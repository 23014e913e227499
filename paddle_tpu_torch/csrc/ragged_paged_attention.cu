// Ragged paged attention: the page-table walk, forward, float arenas.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py `_walk_kernel` (the
// Pallas TPU kernel that `ragged_pallas` launches): one program per row
// DMAs every page of the row's page table into VMEM, then runs
// `grouped_masked_attention` over the staged walk.
//
// What it computes, per row r, KV head hk and query i of the row:
//   keys      kp in [0, max_len), key kp read from arena page
//             clip(page_table[r, kp / page], 0, P-1), offset kp % page;
//   score     (q . k) / sqrt(Dh) (rounded to bf16 at each step for bf16
//             inputs, as the oracle's einsum and division are), then f32;
//   mask      kp <= pos0[r] + i and active[r], else the FINITE -1e30 --
//             p is not zeroed, so a row with no valid key (an inactive
//             row) returns the uniform mean of V over its max_len keys,
//             exactly as the oracle's softmax does;
//   output    softmax-weighted sum of V, in the input dtype.
// Grouped-query heads: a block serves the G = H/Hkv query heads of one
// KV head, so each staged K/V tile feeds all G heads (the grouped path
// is the only path, as in grouped_masked_attention).
//
// What bounds it on an H100: memory. A decode read does 4*Dh flops per
// key and moves 2*Dh*itemsize bytes of K/V per key: ~1 flop per byte in
// f32, far below the card's ~20 (f32) or ~295 (bf16 tensor-core) flops
// per byte, so the least time is bytes / 3.35 TB/s.
//
// Design: grid (R rows, Hkv heads, TQ tiles). The TPU kernel staged the
// whole walk in 16 MB of VMEM; a block here has at most 227 KB, so the
// walk streams through shared memory 32 keys at a time with an online
// softmax in f32 (m, l, acc kept in registers), and a long prefix-hit
// chunk (TQ up to max_len-1) is tiled over blockIdx.z. Each query vector
// is served by 8 lanes that split head_dim and combine the dot product
// with warp shuffles; 16 query vectors share a block and one K/V tile.
// A tile moves as 16-byte vectors, coalesced along head_dim, with all of
// a thread's loads in flight before the first lands in shared memory.
// For an active row the walk stops after the block's last query
// position: later keys would add exp(-1e30 - m) = 0 exactly. Simple
// first: no TMA, no tensor cores, no split-K over pages (one group of 8
// lanes walks a decode row alone), which is where a later, faster
// version starts.
//
// int8 arenas (kernel C). Replaces: paddle_tpu/ops/ragged_paged_attention.py
// `_walk_kernel_int8`, which DMAs each page's s8 data block and its f32
// scale plane into VMEM and dequantizes the block on scratch as it lands.
// Here the same walk body runs with a different tile loader (the KV
// template argument): the tile's 32 per-(key, head) scales are read once
// into shared memory beside the key's source index -- both through the
// same clipped page id, so real bytes never meet another page's scale --
// and each 16-byte load carries 16 s8 values, dequantized as
// `(float)s8 * scale`, rounded to q's dtype (kv_dequantize's element
// sequence), into the same f32 tile. It moves (Dh + 4) bytes per key and
// head where the f32 walk moves 4 * Dh, but it keeps the serial walk, so
// at decode it is bound by the same latency, not by the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_io.cuh"

namespace {

using tile_io::load_f;
using tile_io::store_f;
using tile_io::store_vec;
using tile_io::Vec16;

constexpr int kLanes = 8;                    // lanes per query vector
constexpr int kQueries = 16;                 // query vectors per block
constexpr int kThreads = kLanes * kQueries;  // 128
constexpr int kTileKeys = 32;                // keys staged per step
constexpr float kMask = -1e30f;

// The oracle's score: einsum in the input dtype, divided by sqrt(Dh) in
// the input dtype, then promoted to f32.
template <typename T>
struct Score;
template <>
struct Score<float> {
  __device__ static float apply(float dot, float sqrt_d) {
    return dot / sqrt_d;
  }
};
template <>
struct Score<__nv_bfloat16> {
  __device__ static float apply(float dot, float sqrt_d) {
    const float d = __bfloat162float(__float2bfloat16(dot));
    const float s = __bfloat162float(__float2bfloat16(sqrt_d));
    return __bfloat162float(__float2bfloat16(d / s));
  }
};

// A value rounded to T and widened back (the pointer only selects T).
__device__ __forceinline__ float round_to(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dequantize one 16-byte vector of 16 s8 values into f32 at dst:
// (float)s8 * scale, rounded to T -- kv_dequantize's element sequence.
template <typename T>
__device__ __forceinline__ void store_dequant(float* dst, const uint4& raw,
                                              float scale) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int8_t v = static_cast<int8_t>((w[j] >> (8 * b)) & 0xffu);
      f[b] = round_to(__fmul_rn(static_cast<float>(v), scale),
                      static_cast<const T*>(nullptr));
    }
    *reinterpret_cast<float4*>(dst + 4 * j) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

// KV is the arena's element type: T for a float arena (kernel B), int8_t
// for an (s8 data, f32 scale) pair (kernel C; kscale/vscale are the
// [P, page, Hkv] scale planes, unused for float arenas).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_walk_kernel(const T* __restrict__ q, const KV* __restrict__ karena,
                       const float* __restrict__ kscale,
                       const KV* __restrict__ varena,
                       const float* __restrict__ vscale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ pos0,
                       const uint8_t* __restrict__ active,
                       T* __restrict__ out, int TQ, int H, int Hkv, int P,
                       int page, int max_pages, int max_len,
                       int rows_per_block) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kDims = D / kLanes;  // head_dim slice of one lane
  constexpr int kVec = Vec16<KV>::kN;  // 4 f32, 8 bf16 or 16 s8 values
  constexpr int kVecsPerKey = D / kVec;
  constexpr int kLoads = kTileKeys * kVecsPerKey / kThreads;
  static_assert(kTileKeys * kVecsPerKey % kThreads == 0, "tile split");
  constexpr int kScales = kQuant ? kTileKeys : 1;
  __shared__ __align__(16) float ks[kTileKeys][D];
  __shared__ __align__(16) float vs[kTileKeys][D];
  __shared__ long long tile_src[kTileKeys];
  __shared__ float tile_kscale[kScales], tile_vscale[kScales];

  const int r = blockIdx.x;
  const int hk = blockIdx.y;
  const int i0 = blockIdx.z * rows_per_block;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int qv = tid / kLanes;
  const int lane = tid % kLanes;
  const int il = qv / G;
  const int h = hk * G + qv % G;
  const int i = i0 + il;
  const bool q_ok = il < rows_per_block && i < TQ;

  const int p0 = pos0[r];
  const bool act = active[r] != 0;
  const int last_i = min(i0 + rows_per_block, TQ) - 1;
  // an inactive row attends (uniformly) all max_len keys; an active row
  // needs keys up to its block's last query position only
  const long long bound = (long long)p0 + last_i + 1;
  const int kend = (act && bound > 0 && bound < max_len) ? (int)bound
                                                          : max_len;
  const long long qpos = (long long)p0 + i;
  const float sqrt_d = sqrtf((float)D);

  float qr[kDims], acc[kDims];
  const T* qrow = q + ((long long)(r * TQ + (q_ok ? i : 0)) * H + h) * D;
#pragma unroll
  for (int t = 0; t < kDims; ++t) {
    qr[t] = q_ok ? load_f(qrow + lane + kLanes * t) : 0.f;
    acc[t] = 0.f;
  }
  float m = kMask, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kTileKeys) {
    if (tid < kTileKeys) {
      const int kp = k0 + tid;
      long long src = -1;
      if (kp < kend) {
        int pg = page_table[(long long)r * max_pages + kp / page];
        pg = min(max(pg, 0), P - 1);  // sentinel entries clip
        src = ((long long)pg * page + kp % page) * Hkv + hk;
      }
      tile_src[tid] = src;
      if constexpr (kQuant) {
        // the scale of (key, head) sits at the data vector's index
        tile_kscale[tid] = src >= 0 ? kscale[src] : 0.f;
        tile_vscale[tid] = src >= 0 ? vscale[src] : 0.f;
      }
    }
    __syncthreads();
    // every 16-byte load of the tile is in flight before the first store
    uint4 kraw[kLoads], vraw[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = tid + it * kThreads;
      const long long src = tile_src[e / kVecsPerKey];
      const long long off = src * D + (e % kVecsPerKey) * kVec;
      kraw[it] = src >= 0 ? *reinterpret_cast<const uint4*>(karena + off)
                          : make_uint4(0u, 0u, 0u, 0u);
      vraw[it] = src >= 0 ? *reinterpret_cast<const uint4*>(varena + off)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kVecsPerKey, c = (e % kVecsPerKey) * kVec;
      if constexpr (kQuant) {
        store_dequant<T>(&ks[kk][c], kraw[it], tile_kscale[kk]);
        store_dequant<T>(&vs[kk][c], vraw[it], tile_vscale[kk]);
      } else {
        store_vec(&ks[kk][c], kraw[it], karena);
        store_vec(&vs[kk][c], vraw[it], varena);
      }
    }
    __syncthreads();

    const int nk = min(kTileKeys, kend - k0);
    float s[kTileKeys];
    float mcur = kMask;
#pragma unroll
    for (int kk = 0; kk < kTileKeys; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kDims; ++t)
        part = fmaf(qr[t], ks[kk][lane + kLanes * t], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      const float sc = Score<T>::apply(part, sqrt_d);
      s[kk] = (act && (long long)(k0 + kk) <= qpos) ? sc : kMask;
      if (kk < nk) mcur = fmaxf(mcur, s[kk]);
    }
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kDims; ++t) acc[t] *= alpha;
#pragma unroll
    for (int kk = 0; kk < kTileKeys; ++kk) {
      const float p = kk < nk ? expf(s[kk] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int t = 0; t < kDims; ++t)
        acc[t] = fmaf(p, vs[kk][lane + kLanes * t], acc[t]);
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();
  }

  if (q_ok) {
    T* orow = out + ((long long)(r * TQ + i) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kDims; ++t)
      store_f(orow + lane + kLanes * t, acc[t] / l);
  }
}

struct WalkArgs {
  const void *q, *k, *kscale, *v, *vscale, *pt, *pos0, *active;
  void* out;
  int R, TQ, H, Hkv, P, page, max_pages, max_len;
};

template <typename T, typename KV, int D>
cudaError_t launch(const WalkArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const int rows = G >= kQueries ? 1 : kQueries / G;
  const dim3 grid(a.R, a.Hkv, (a.TQ + rows - 1) / rows);
  ragged_walk_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const float*>(a.kscale), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.vscale), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.pos0), static_cast<const uint8_t*>(a.active),
      static_cast<T*>(a.out), a.TQ, a.H, a.Hkv, a.P, a.page, a.max_pages,
      a.max_len, rows);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 queries; KV32/KV16 are the arena
// element types that go with them. Returns the launch's cudaError_t.
// The walk reads key kp < max_len through table entry kp / page, so it
// touches min(max_pages, ceil(max_len / page)) entries at most.
template <typename KV32, typename KV16>
int dispatch(int dtype, int head_dim, const WalkArgs& a, void* stream) {
  if (a.Hkv < 1 || a.H % a.Hkv != 0 || a.H / a.Hkv > kQueries ||
      a.page < 1 || (long long)a.max_pages * a.page < a.max_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, KV32, 64>(a, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, KV32, 128>(a, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, KV16, 64>(a, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, KV16, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel B: float arenas in q's dtype.
extern "C" int ragged_walk(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const void* pt,
                           const void* pos0, const void* active, void* out,
                           int R, int TQ, int H, int Hkv, int P, int page,
                           int max_pages, int max_len, void* stream) {
  const WalkArgs a{q,   k,  nullptr, v,   nullptr, pt,   pos0,      active,
                   out, R,  TQ,      H,   Hkv,     P,    page,      max_pages,
                   max_len};
  return dispatch<float, __nv_bfloat16>(dtype, head_dim, a, stream);
}

// Kernel C: (s8 data [P, page, Hkv, Dh], f32 scale [P, page, Hkv]) pairs.
extern "C" int ragged_walk_int8(int dtype, int head_dim, const void* q,
                                const void* kd, const void* ks,
                                const void* vd, const void* vs,
                                const void* pt, const void* pos0,
                                const void* active, void* out, int R, int TQ,
                                int H, int Hkv, int P, int page,
                                int max_pages, int max_len, void* stream) {
  const WalkArgs a{q,   kd, ks, vd,  vs, pt,   pos0,      active,
                   out, R,  TQ, H,   Hkv, P,   page,      max_pages,
                   max_len};
  return dispatch<int8_t, int8_t>(dtype, head_dim, a, stream);
}
