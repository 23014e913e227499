// Flash attention, forward.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_attn_kernel` (the Pallas
// TPU kernel that `_flash_forward` launches under the `_flash`
// custom_vjp).
//
// What it computes, per batch b, head h and query position t of
// q, k, v [B, T, H, D] (the JAX layout, read in place -- no transpose):
//   score     (q . k) * (1/sqrt(D)), products accumulated in f32;
//   mask      key kp < min(key_lens[b], Tk); with `causal` also t >= kp,
//             and with a `window` also t - kp < window;
//   softmax   streaming, in f32 (m, l, acc), with p ZEROED where a key is
//             invalid, so a row with no valid key returns 0;
//   output    o [B, T, H, D] in the input dtype, and the row log-sum-exp
//             lse [B, H, T] in f32 (m + log max(l, 1e-30)).
// For bf16 inputs p is rounded to bf16 before the PV product, as the TPU
// kernel feeds p.astype(v.dtype) to the MXU.
//
// What bounds it on an H100: operations for long rows (4*D flops per
// (query, key) pair against ~2*D*itemsize bytes per key read once), bytes
// for short ones; this first version runs its products on the CUDA cores
// (f32 FMA), not the tensor cores.
//
// Design: grid (B*H, query tiles of 64 rows); 256 threads, 4 lanes per
// query row, each lane holding a quarter of head_dim of q and of the f32
// accumulator in registers. K and V stream through shared memory 32 keys
// at a time (the TPU kernel's 512-key blocks do not fit a block's shared
// memory with room for more than one block per SM), as 16-byte vector
// loads coalesced along head_dim, all in flight before the first is
// converted to f32 in shared memory. A tile that the key_lens, causal or
// window predicates leave no valid key for in the whole query tile is
// skipped, as the TPU kernel skips dead k-blocks. Later work: tensor-core
// products (mma/wgmma), TMA loads, larger tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_io.cuh"

namespace {

using tile_io::load_f;
using tile_io::store_f;
using tile_io::store_vec;
using tile_io::Vec16;

constexpr int kRows = 64;                 // query rows per block
constexpr int kLanes = 4;                 // lanes per query row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kTileKeys = 32;             // keys staged per step
constexpr float kMask = -1e30f;

// the PV operand in the value dtype
__device__ __forceinline__ float as_operand(float p, const float*) {
  return p;
}
__device__ __forceinline__ float as_operand(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Tq, int Tk, float scale, int causal, int window) {
  constexpr int kDims = D / kLanes;  // head_dim slice of one lane
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kVecsPerKey = D / kVec;
  constexpr int kLoads = kTileKeys * kVecsPerKey / kThreads;
  static_assert(kTileKeys * kVecsPerKey % kThreads == 0, "tile split");
  __shared__ __align__(16) float ks[kTileKeys][D];
  __shared__ __align__(16) float vs[kTileKeys][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const int qpos = q0 + row;
  const bool row_ok = qpos < Tq;
  const int len = min(lens[b], Tk);
  const int q_last = min(q0 + kRows, Tq) - 1;

  float qr[kDims], acc[kDims];
  const T* qrow = q + ((long long)(b * Tq + (row_ok ? qpos : 0)) * H + h) * D;
#pragma unroll
  for (int t = 0; t < kDims; ++t) {
    qr[t] = row_ok ? load_f(qrow + lane + kLanes * t) : 0.f;
    acc[t] = 0.f;
  }
  float m = kMask, l = 0.f;

  const int ntiles = (Tk + kTileKeys - 1) / kTileKeys;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTileKeys;
    // whole-tile skip: uniform across the block
    bool needed = k0 < len;
    if (causal) needed = needed && k0 <= q_last;
    if (window > 0) needed = needed && k0 + kTileKeys - 1 >= q0 - window + 1;
    if (!needed) continue;

    // every 16-byte load of the tile is in flight before the first store
    uint4 kraw[kLoads], vraw[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = tid + it * kThreads;
      const int kp = k0 + e / kVecsPerKey;
      const long long off = ((long long)(b * Tk + kp) * H + h) * D +
                            (e % kVecsPerKey) * kVec;
      kraw[it] = kp < Tk ? *reinterpret_cast<const uint4*>(k + off)
                         : make_uint4(0u, 0u, 0u, 0u);
      vraw[it] = kp < Tk ? *reinterpret_cast<const uint4*>(v + off)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kVecsPerKey, c = (e % kVecsPerKey) * kVec;
      store_vec(&ks[kk][c], kraw[it], k);
      store_vec(&vs[kk][c], vraw[it], v);
    }
    __syncthreads();

    float s[kTileKeys];
    unsigned valid_bits = 0u;
    float mcur = kMask;
#pragma unroll
    for (int kk = 0; kk < kTileKeys; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kDims; ++t)
        part = fmaf(qr[t], ks[kk][lane + kLanes * t], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + kk;
      bool valid = kp < len;
      if (causal) {
        valid = valid && qpos >= kp;
        if (window > 0) valid = valid && qpos - kp < window;
      }
      s[kk] = valid ? part * scale : kMask;
      valid_bits |= (valid ? 1u : 0u) << kk;
      mcur = fmaxf(mcur, s[kk]);
    }
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kDims; ++t) acc[t] *= alpha;
#pragma unroll
    for (int kk = 0; kk < kTileKeys; ++kk) {
      const float p = (valid_bits >> kk) & 1u ? expf(s[kk] - m_new) : 0.f;
      psum += p;
      const float pv = as_operand(p, v);
#pragma unroll
      for (int t = 0; t < kDims; ++t)
        acc[t] = fmaf(pv, vs[kk][lane + kLanes * t], acc[t]);
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + ((long long)(b * Tq + qpos) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kDims; ++t)
      store_f(orow + lane + kLanes * t, acc[t] / l_safe);
    if (lane == 0) lse[(long long)bh * Tq + qpos] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* o, void* lse, int B, int H,
                   int Tq, int Tk, float scale, int causal, int window,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none. q [B, Tq, H,
// D], k/v [B, Tk, H, D], lens [B] int32 -> o [B, Tq, H, D], lse [B, H, Tq]
// f32. Returns the launch's cudaError_t.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* lens,
                         void* o, void* lse, int B, int H, int Tq, int Tk,
                         float scale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k, v, lens, o, lse, B, H, Tq, Tk, scale,
                                  causal, window, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k, v, lens, o, lse, B, H, Tq, Tk,
                                   scale, causal, window, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, lens, o, lse, B, H, Tq,
                                          Tk, scale, causal, window, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, lens, o, lse, B, H, Tq,
                                           Tk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
