// Ragged paged attention: the page-table walk, forward, over float
// arenas (kernel B) and int8 arenas (kernel C), one split walk for both.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py `_walk_kernel` (B)
// and `_walk_kernel_int8` (C), the Pallas TPU kernels that
// `ragged_pallas` launches: one program per row DMAs every page of the
// row's page table into VMEM (C also each page's f32 scale plane,
// dequantizing the s8 block on scratch as it lands), then runs
// `grouped_masked_attention` over the staged walk.
//
// What it computes, per row r, KV head hk and query i of the row:
//   keys      kp in [0, max_len), key kp read from arena page
//             clip(page_table[r, kp / page], 0, P-1), offset kp % page
//             (C: (float)s8 * scale rounded to q's dtype, kv_dequantize's
//             element sequence, its scale read through the same page id);
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
// What bounds it on an H100: memory, and at decode the latency of a few
// dependent reads. A decode read does 4*Dh flops per key and moves
// 2*Dh*itemsize bytes of K/V per key (C: 2*(Dh + 4)): ~1 flop per byte,
// far below the card's ~20 (f32) or ~295 (bf16 tensor-core) flops per
// byte, so the least time is bytes / 3.35 TB/s -- under 2 us for a
// decode step's 8 rows, far less than a chain of DRAM round trips.
//
// Design (`split_walk_kernel` below, flash-decoding): the TPU kernel
// staged a row's whole walk in 16 MB of VMEM, one program per row; a
// block here has at most 227 KB and the card has 132 SMs, so the walk is
// split over runs of keys across blocks -- grid (R, Hkv, query tiles x
// splits), the host choosing the splits (`walk_plan`) so that a decode
// step fills the card -- and the splits' f32 partials are merged in a
// fixed order by a second small kernel. Each query vector is served by 8
// lanes that split head_dim (a lane holds D/8 contiguous values) and
// combine the dot product with warp shuffles; a block's 16 query slots
// hold its query tile's vectors, and where the tile leaves slots idle
// they take other keys of the same tile. Each block reads its span's
// page-table entries (and C its scales) once, up front, and keeps the
// raw arena tiles of K and V in flight through a cp.async ring; the dot
// products read straight from the ring (C dequantizing as it reads). The
// tile loader is the arena's (`TileRing`): raw f32 or bf16 tiles for B,
// raw s8 tiles for C (a quarter of an f32 tile's bytes). The block's
// shared memory is dynamic: a float ring of 3 tiles of 32 keys takes 48
// KB (f32, Dh=64) to 96 KB (f32, Dh=128) for K and V, past the 48 KB of
// static shared memory; `walk_resources` reports each instantiation's
// bytes, registers and resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_io.cuh"

namespace {

using tile_io::load_f;
using tile_io::store_f;

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

// -- the split walk (kernels B and C) -----------------------------------------
//
// Grid (R rows, Hkv heads, query tiles x splits). Split sp of a query
// tile walks keys [sp * span, (sp + 1) * span) of [0, kend) (span a run
// of whole pages where a page holds at most kMaxSpan keys, else a run of
// kMaxSpan keys; kend = pos0 + the tile's last query + 1 for an active
// row, max_len for an inactive one: later keys would add exp(-1e30 - m)
// = 0 exactly) and leaves f32 partials (m, l, acc) per query vector;
// `combine_kernel` merges the splits in order sp = 0, 1, ... (with one
// split the block writes the output itself). A split past kend walks
// nothing and leaves l = 0, acc = 0: it adds nothing. Every key a split
// does walk is scored with the finite mask, so an inactive row's splits
// all keep m = -1e30 and merge to the uniform mean of V.
//
// A block's 16 query slots of 8 lanes hold rows_per_block queries x G
// heads (nqv vectors); where nqv < 16, kg = 16 / nqv groups of nqv
// vectors take every kg-th key of a tile each, with their own (m, l,
// acc), merged in shared memory in group order at the end.
//
// The block reads its span's page-table entries (clipped: one read per
// key) and, through the arena's loader, anything else per key (C's
// scales) once, up front; its raw arena tiles (32 keys of K and V) then
// move through a kRing-deep cp.async ring, tile n + kRing - 1 in flight
// while tile n computes, and the dot products read straight from the
// ring. The tile loader is the arena's (`TileRing`).

constexpr int kMaxSpan = 512;  // keys one block walks at most
constexpr int kRing = 3;       // tiles in the cp.async ring
constexpr int kChunk = 4;      // keys a group scores between rescales

template <typename KV, typename T, int D>
struct TileRing;

// (s8 data, f32 scale) arenas: the ring holds raw s8 rows; a lane reads
// its D / 8 contiguous bytes of a key and dequantizes (float)s8 * scale
// rounded to T, kv_dequantize's element sequence.
template <typename T, int D>
struct TileRing<int8_t, T, D> {
  static constexpr int kDims = D / kLanes;
  static constexpr int kVecs = D / 16;  // 16-byte copies per key row
  struct Smem {
    __align__(16) int8_t k[kRing][kTileKeys][D];
    __align__(16) int8_t v[kRing][kTileKeys][D];
    float ks[kMaxSpan], vs[kMaxSpan];
  };

  // the span's scales, through the same clipped page ids as the data
  __device__ static void prepare(Smem& sm, const float* kscale,
                                 const float* vscale, const long long* src,
                                 int nkeys) {
    for (int e = threadIdx.x; e < nkeys; e += kThreads) {
      sm.ks[e] = kscale[src[e]];
      sm.vs[e] = vscale[src[e]];
    }
  }
  // start the copies of the span's tile n (keys e0 .. e0+31 of the span)
  __device__ static void issue(Smem& sm, int slot, const int8_t* karena,
                               const int8_t* varena, const long long* src,
                               int e0, int nkeys) {
    for (int e = threadIdx.x; e < kTileKeys * kVecs; e += kThreads) {
      const int kk = e / kVecs, c = (e % kVecs) * 16;
      if (e0 + kk >= nkeys) continue;
      const long long off = src[e0 + kk] * D + c;
      tile_io::cp_async16(&sm.k[slot][kk][c], karena + off);
      tile_io::cp_async16(&sm.v[slot][kk][c], varena + off);
    }
  }
  __device__ static void row(const int8_t* p, float scale,
                             float (&x)[kDims]) {
    unsigned w[kDims / 4];
    if constexpr (kDims == 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      w[0] = raw.x;
      w[1] = raw.y;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      w[0] = raw.x;
      w[1] = raw.y;
      w[2] = raw.z;
      w[3] = raw.w;
    }
#pragma unroll
    for (int t = 0; t < kDims; ++t) {
      const int8_t b = static_cast<int8_t>((w[t / 4] >> (8 * (t % 4))) & 0xffu);
      x[t] = round_to(__fmul_rn(static_cast<float>(b), scale),
                      static_cast<const T*>(nullptr));
    }
  }
  // the lane's slice of key kk of slot (span key e), dequantized
  __device__ static void key(const Smem& sm, int slot, int kk, int e,
                             int lane, float (&x)[kDims]) {
    row(&sm.k[slot][kk][lane * kDims], sm.ks[e], x);
  }
  __device__ static void value(const Smem& sm, int slot, int kk, int e,
                               int lane, float (&x)[kDims]) {
    row(&sm.v[slot][kk][lane * kDims], sm.vs[e], x);
  }
};

// Widen a 16-byte vector of T into f32 at x (the pointer selects T)
__device__ __forceinline__ void widen(const uint4& raw, float* x,
                                      const float*) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* x,
                                      const __nv_bfloat16*) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = p.x;
    x[2 * j + 1] = p.y;
  }
}

// Float arenas in q's dtype (f32 or bf16): the ring holds raw rows of T;
// a lane reads its D / 8 contiguous values of a key (16-byte loads) as
// f32. Nothing is read per key beside the data.
template <typename T, int D>
struct TileRing<T, T, D> {
  static constexpr int kDims = D / kLanes;
  static constexpr int kVec = 16 / sizeof(T);  // values per 16-byte copy
  static constexpr int kVecs = D / kVec;       // copies per key row
  struct Smem {
    __align__(16) T k[kRing][kTileKeys][D];
    __align__(16) T v[kRing][kTileKeys][D];
  };

  __device__ static void prepare(Smem&, const float*, const float*,
                                 const long long*, int) {}
  // start the copies of the span's tile n (keys e0 .. e0+31 of the span)
  __device__ static void issue(Smem& sm, int slot, const T* karena,
                               const T* varena, const long long* src,
                               int e0, int nkeys) {
    for (int e = threadIdx.x; e < kTileKeys * kVecs; e += kThreads) {
      const int kk = e / kVecs, c = (e % kVecs) * kVec;
      if (e0 + kk >= nkeys) continue;
      const long long off = src[e0 + kk] * D + c;
      tile_io::cp_async16(&sm.k[slot][kk][c], karena + off);
      tile_io::cp_async16(&sm.v[slot][kk][c], varena + off);
    }
  }
  __device__ static void row(const T* p, float (&x)[kDims]) {
#pragma unroll
    for (int u = 0; u < kDims / kVec; ++u)
      widen(reinterpret_cast<const uint4*>(p)[u], &x[u * kVec], p);
  }
  // the lane's slice of key kk of slot
  __device__ static void key(const Smem& sm, int slot, int kk, int,
                             int lane, float (&x)[kDims]) {
    row(&sm.k[slot][kk][lane * kDims], x);
  }
  __device__ static void value(const Smem& sm, int slot, int kk, int,
                               int lane, float (&x)[kDims]) {
    row(&sm.v[slot][kk][lane * kDims], x);
  }
};

// The split walk's shared memory, dynamic (a float ring is past the 48
// KB a block may declare statically)
template <typename Ring, int D>
struct WalkSmem {
  typename Ring::Smem ring;
  long long src[kMaxSpan];                // arena index of each span key
  __align__(16) float macc[kQueries][D];  // the key groups' partials
  float mml[kQueries][2];
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    split_walk_kernel(const T* __restrict__ q, const KV* __restrict__ karena,
                      const float* __restrict__ kscale,
                      const KV* __restrict__ varena,
                      const float* __restrict__ vscale,
                      const int* __restrict__ page_table,
                      const int* __restrict__ pos0,
                      const uint8_t* __restrict__ active,
                      T* __restrict__ out, float* __restrict__ part, int TQ,
                      int H, int Hkv, int P, int page, int max_pages,
                      int max_len, int rows_per_block, int splits,
                      int span) {
  using Ring = TileRing<KV, T, D>;
  constexpr int kDims = D / kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  WalkSmem<Ring, D>& ws = *reinterpret_cast<WalkSmem<Ring, D>*>(smem);
  typename Ring::Smem& sm = ws.ring;
  long long* src = ws.src;

  const int r = blockIdx.x, hk = blockIdx.y;
  const int qt = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int i0 = qt * rows_per_block;
  const int G = H / Hkv;
  const int nqv = rows_per_block * G;
  const int kg = kQueries / nqv;          // key groups
  const int tid = threadIdx.x, qv = tid / kLanes, lane = tid % kLanes;
  const int group = qv / nqv, qidx = qv % nqv;
  const int h = hk * G + qidx % G;
  const int i = i0 + qidx / G;
  const bool q_ok = group < kg && i < TQ;

  // up front, all in flight together: pos0 and active, the block's
  // queries, and each span key's arena index (its page id read once per
  // key and clipped: sentinels read the last page); then the first
  // tiles' copies and what the loader reads per key (C's scales)
  const int p0 = pos0[r];
  const bool act = active[r] != 0;
  float qr[kDims], acc[kDims];
  const T* qrow = q + ((long long)(r * TQ + (q_ok ? i : 0)) * H + h) * D;
#pragma unroll
  for (int t = 0; t < kDims; ++t) {
    qr[t] = q_ok ? load_f(qrow + lane * kDims + t) : 0.f;
    acc[t] = 0.f;
  }
  const int k_lo = sp * span;
  const int span_keys = max(0, min(span, max_len - k_lo));
  for (int e = tid; e < span_keys; e += kThreads) {
    const int kp = k_lo + e;
    int pg = page_table[(long long)r * max_pages + kp / page];
    pg = min(max(pg, 0), P - 1);
    src[e] = ((long long)pg * page + kp % page) * Hkv + hk;
  }
  __syncthreads();
  const int last_i = min(i0 + rows_per_block, TQ) - 1;
  const long long bound = (long long)p0 + last_i + 1;
  const int kend = (act && bound > 0 && bound < max_len) ? (int)bound
                                                          : max_len;
  const int nkeys = max(0, min(k_lo + span_keys, kend) - k_lo);
  const int n_tiles = (nkeys + kTileKeys - 1) / kTileKeys;
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) {
    if (n < n_tiles)
      Ring::issue(sm, n, karena, varena, src, n * kTileKeys, nkeys);
    tile_io::cp_async_commit();
  }
  Ring::prepare(sm, kscale, vscale, src, nkeys);
  const long long qpos = (long long)p0 + i;
  const float sqrt_d = sqrtf((float)D);
  float m = kMask, l = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int ahead = n + kRing - 1;
    if (ahead < n_tiles)
      Ring::issue(sm, ahead % kRing, karena, varena, src, ahead * kTileKeys,
                  nkeys);
    tile_io::cp_async_commit();
    tile_io::cp_async_wait<kRing - 1>();  // tile n has landed
    __syncthreads();
    const int slot = n % kRing, e0 = n * kTileKeys;
    const int nk = min(kTileKeys, nkeys - e0);
    const int per_group = (nk + kg - 1) / kg;  // the most keys of a group
    for (int u0 = 0; u0 < per_group; u0 += kChunk) {
      // the group's keys kk = group + kg * u: scores (-inf past the
      // tile or for an idle group, the finite mask where masked)
      float s[kChunk];
      float mcur = kMask;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int kk = group + kg * (u0 + u);
        const bool in = group < kg && kk < nk;
        const int kc = in ? kk : 0;
        float kx[kDims];
        Ring::key(sm, slot, kc, e0 + kc, lane, kx);
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kDims; ++t) dot = fmaf(qr[t], kx[t], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        const float sc = Score<T>::apply(dot, sqrt_d);
        const bool valid = act && (long long)(k_lo + e0 + kk) <= qpos;
        s[u] = in ? (valid ? sc : kMask) : -INFINITY;
        mcur = fmaxf(mcur, s[u]);
      }
      const float m_new = fmaxf(m, mcur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kDims; ++t) acc[t] *= alpha;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = expf(s[u] - m_new);   // 0 for -inf
        const int kk = group + kg * (u0 + u);
        const int kc = (group < kg && kk < nk) ? kk : 0;
        float vx[kDims];
        Ring::value(sm, slot, kc, e0 + kc, lane, vx);
        psum += p;
#pragma unroll
        for (int t = 0; t < kDims; ++t) acc[t] = fmaf(p, vx[t], acc[t]);
      }
      l = l * alpha + psum;
      m = m_new;
    }
    __syncthreads();  // slot n % kRing is refilled next iteration
  }

  // merge the key groups in order (group 0 keeps the result)
  if (kg > 1) {
    if (group < kg) {
#pragma unroll
      for (int t = 0; t < kDims; ++t)
        ws.macc[qv][lane * kDims + t] = acc[t];
      if (lane == 0) {
        ws.mml[qv][0] = m;
        ws.mml[qv][1] = l;
      }
    }
    __syncthreads();
    if (group == 0) {
      float mm = kMask;
      for (int g = 0; g < kg; ++g)
        mm = fmaxf(mm, ws.mml[g * nqv + qidx][0]);
      l = 0.f;
#pragma unroll
      for (int t = 0; t < kDims; ++t) acc[t] = 0.f;
      for (int g = 0; g < kg; ++g) {
        const int v = g * nqv + qidx;
        const float f = expf(ws.mml[v][0] - mm);
        l = fmaf(ws.mml[v][1], f, l);
#pragma unroll
        for (int t = 0; t < kDims; ++t)
          acc[t] = fmaf(ws.macc[v][lane * kDims + t], f, acc[t]);
      }
      m = mm;
    }
  }
  if (group != 0 || !q_ok) return;
  const long long vec = (long long)(r * TQ + i) * H + h;
  if (splits == 1) {
    T* orow = out + vec * D;
#pragma unroll
    for (int t = 0; t < kDims; ++t)
      store_f(orow + lane * kDims + t, acc[t] / l);
    return;
  }
  // partials [splits][R*TQ*H][D + 4]: acc, then m and l
  const long long nvec = (long long)gridDim.x * TQ * H;
  float* prow = part + ((long long)sp * nvec + vec) * (D + 4);
#pragma unroll
  for (int t = 0; t < kDims; ++t) prow[lane * kDims + t] = acc[t];
  if (lane == 0) {
    prow[D] = m;
    prow[D + 1] = l;
  }
}

// out[v][d] = sum_s acc_s[d] e^(m_s - M) / sum_s l_s e^(m_s - M), M =
// max_s m_s, over the splits in order: one thread per output element
template <typename T, int D>
__global__ void __launch_bounds__(256)
    combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                   long long nvec, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nvec * D) return;
  const long long v = idx / D;
  const int d = (int)(idx % D);
  const long long stride = nvec * (D + 4);
  const float* p = part + v * (D + 4);
  float mm = kMask;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, p[s * stride + D]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float f = expf(p[s * stride + D] - mm);
    l = fmaf(p[s * stride + D + 1], f, l);
    a = fmaf(p[s * stride + d], f, a);
  }
  store_f(out + idx, a / l);
}

struct WalkArgs {
  const void *q, *k, *kscale, *v, *vscale, *pt, *pos0, *active;
  void* out;
  int R, TQ, H, Hkv, P, page, max_pages, max_len;
  // the host's plan: partials [splits][R*TQ*H][D + 4], query rows per
  // block, splits per query tile, keys per split
  void* part;
  int rows_per_block, splits, span;
  int* launched;  // device launches made
};

// The split walk's dynamic shared memory for an instantiation, opted in
// to (above 48 KB a launch needs the function's attribute raised)
template <typename T, typename KV, int D>
cudaError_t opt_in(size_t* bytes) {
  *bytes = sizeof(WalkSmem<TileRing<KV, T, D>, D>);
  return cudaFuncSetAttribute(split_walk_kernel<T, KV, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// The split walk, then (with several splits) the combine.
template <typename T, typename KV, int D>
cudaError_t launch_split(const WalkArgs& a, cudaStream_t stream) {
  *a.launched = 0;
  size_t smem = 0;
  cudaError_t err = opt_in<T, KV, D>(&smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.TQ + a.rows_per_block - 1) / a.rows_per_block;
  const dim3 grid(a.R, a.Hkv, q_tiles * a.splits);
  split_walk_kernel<T, KV, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const float*>(a.kscale), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.vscale), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.pos0), static_cast<const uint8_t*>(a.active),
      static_cast<T*>(a.out), static_cast<float*>(a.part), a.TQ, a.H, a.Hkv,
      a.P, a.page, a.max_pages, a.max_len, a.rows_per_block, a.splits,
      a.span);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  *a.launched = 1;
  if (a.splits == 1) return err;
  const long long nvec = (long long)a.R * a.TQ * a.H;
  const long long blocks = (nvec * D + 255) / 256;
  combine_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<T*>(a.out), nvec,
      a.splits);
  if ((err = cudaGetLastError()) == cudaSuccess) *a.launched = 2;
  return err;
}

// Call f(T*, KV*, integral_constant<D>) with null pointers whose types
// select q's dtype (0 = float32, 1 = bfloat16), the arena's element type
// that goes with it (KV32 or KV16) and head_dim (64 or 128).
template <typename KV32, typename KV16, typename F>
cudaError_t with_types(int dtype, int head_dim, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  float* f32 = nullptr;
  __nv_bfloat16* bf16 = nullptr;
  KV32* kv32 = nullptr;
  KV16* kv16 = nullptr;
  if (dtype == 0 && head_dim == 64) return f(f32, kv32, D64());
  if (dtype == 0 && head_dim == 128) return f(f32, kv32, D128());
  if (dtype == 1 && head_dim == 64) return f(bf16, kv16, D64());
  if (dtype == 1 && head_dim == 128) return f(bf16, kv16, D128());
  return cudaErrorInvalidValue;
}

// Validate the host's plan and launch. Returns the first cudaError_t.
// The walk reads key kp < max_len through table entry kp / page, so it
// touches min(max_pages, ceil(max_len / page)) entries at most.
template <typename KV32, typename KV16>
int dispatch(int dtype, int head_dim, const WalkArgs& a, void* stream) {
  if (a.Hkv < 1 || a.H % a.Hkv != 0 || a.H / a.Hkv > kQueries ||
      a.page < 1 || (long long)a.max_pages * a.page < a.max_len ||
      a.rows_per_block < 1 || a.rows_per_block * (a.H / a.Hkv) > kQueries ||
      a.splits < 1 || a.span < 1 || a.span > kMaxSpan ||
      (long long)a.splits * a.span < a.max_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_types<KV32, KV16>(
      dtype, head_dim, [&](auto* tp, auto* kvp, auto d) -> cudaError_t {
        using T = std::remove_pointer_t<decltype(tp)>;
        using KV = std::remove_pointer_t<decltype(kvp)>;
        return launch_split<T, KV, decltype(d)::value>(a, s);
      });
}

}  // namespace

// Both walks take the host's plan (rows_per_block, splits, span: keys per
// split, at most 512; part [splits][R*TQ*H][Dh + 4] f32 when splits > 1),
// run the split walk and, with several splits, the combine; *launched
// counts the device launches made (1 or 2). dtype: 0 = float32, 1 =
// bfloat16 queries.
//
// Kernel B: float arenas [P, page, Hkv, Dh] in q's dtype.
extern "C" int ragged_walk(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const void* pt,
                           const void* pos0, const void* active, void* out,
                           void* part, int R, int TQ, int H, int Hkv, int P,
                           int page, int max_pages, int max_len,
                           int rows_per_block, int splits, int span,
                           int* launched, void* stream) {
  *launched = 0;
  const WalkArgs a{q,    k,      nullptr, v,         nullptr, pt,
                   pos0, active, out,     R,         TQ,      H,
                   Hkv,  P,      page,    max_pages, max_len, part,
                   rows_per_block, splits, span,     launched};
  return dispatch<float, __nv_bfloat16>(dtype, head_dim, a, stream);
}

// Kernel C: (s8 data [P, page, Hkv, Dh], f32 scale [P, page, Hkv]) pairs.
extern "C" int ragged_walk_int8(int dtype, int head_dim, const void* q,
                                const void* kd, const void* ks,
                                const void* vd, const void* vs,
                                const void* pt, const void* pos0,
                                const void* active, void* out, void* part,
                                int R, int TQ, int H, int Hkv, int P,
                                int page, int max_pages, int max_len,
                                int rows_per_block, int splits, int span,
                                int* launched, void* stream) {
  *launched = 0;
  const WalkArgs a{q,    kd,     ks,  vd,        vs,      pt,
                   pos0, active, out, R,         TQ,      H,
                   Hkv,  P,      page, max_pages, max_len, part,
                   rows_per_block, splits, span, launched};
  return dispatch<int8_t, int8_t>(dtype, head_dim, a, stream);
}

// What an instantiation of the split walk takes on this card: out[0] =
// dynamic shared memory bytes, out[1] = registers per thread, out[2] =
// blocks resident per SM, out[3] = local memory (spill) bytes per thread.
// int8 = 1 selects kernel C's instantiation, else B's.
extern "C" int walk_resources(int int8, int dtype, int head_dim, int* out) {
  auto f = [&](auto* tp, auto* kvp, auto d) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tp)>;
    using KV = std::remove_pointer_t<decltype(kvp)>;
    constexpr int D = decltype(d)::value;
    size_t smem = 0;
    cudaError_t err = opt_in<T, KV, D>(&smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, split_walk_kernel<T, KV, D>)) !=
        cudaSuccess)
      return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, split_walk_kernel<T, KV, D>, kThreads, smem);
    out[0] = (int)smem;
    out[1] = fa.numRegs;
    out[2] = per_sm;
    out[3] = (int)fa.localSizeBytes;
    return err;
  };
  return (int)(int8 ? with_types<int8_t, int8_t>(dtype, head_dim, f)
                    : with_types<float, __nv_bfloat16>(dtype, head_dim, f));
}
