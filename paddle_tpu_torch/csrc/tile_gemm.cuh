// A tiled f32 product on the CUDA cores, for the parallel phases of the
// backward time loops (fused_lstm.cu, fused_gru.cu):
//   C[m][n] = sum_{k in [kbeg, kend)} A(k, m) * B(k, n)
// over one 128 x 128 output tile per CTA of 256 threads, each thread
// holding an 8 x 8 register tile (rows ty*4 + {0..3, 64..67}, columns
// tx*4 + {0..3, 64..67}). Slabs of kBK = 8 move through shared memory,
// double-buffered: the next slab is loaded into registers while the
// current one is multiplied. Products are f32 FMAs of f32 (or
// bf16-exact) operands, never TF32: the time loops' contract is f32.
//
// The operands come from loader functors, so that a caller can shift,
// round or permute while loading: `float operator()(int k, int i) const`
// returns A(k, i) (or B(k, i)) at global indices, 0 outside the matrix,
// and `static constexpr bool kContigK` says which index is contiguous in
// memory (true: k, as in a row-major [M, K] operand; false: i), so that
// neighbouring threads load neighbouring addresses.
#pragma once

#include <cuda_runtime.h>

namespace tile_gemm {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;
constexpr int kPad = 4;  // shared rows of kBM + 4 floats: no store conflicts

struct Smem {
  float a[2][kBK][kBM + kPad];
  float b[2][kBK][kBN + kPad];
};

// tile-local row (or column) of the thread's ii-th (0..7) output
__device__ __forceinline__ int out_index(int t16, int ii) {
  return (ii < 4 ? 0 : 64 - 4) + t16 * 4 + ii;
}

// Slab element e (0..1023) of this thread's 4: (k within the slab, index
// within the tile), in the loader's memory order
template <bool kContigK>
__device__ __forceinline__ void slab_pos(int e, int& kk, int& i) {
  if (kContigK) {
    kk = e % kBK;
    i = e / kBK;
  } else {
    kk = e / kBM;
    i = e % kBM;
  }
}

template <class L>
__device__ __forceinline__ void load_slab(float (&r)[4], const L& ld, int k0,
                                          int kend, int i0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int kk, i;
    slab_pos<L::kContigK>(threadIdx.x + q * kThreads, kk, i);
    r[q] = k0 + kk < kend ? ld(k0 + kk, i0 + i) : 0.f;
  }
}

template <bool kContigK, int kW>
__device__ __forceinline__ void store_slab(float (*s)[kW + kPad],
                                           const float (&r)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int kk, i;
    slab_pos<kContigK>(threadIdx.x + q * kThreads, kk, i);
    s[kk][i] = r[q];
  }
}

// acc (zeroed here) = the tile (m0, n0) of the product over [kbeg, kend).
// Only columns n with n % 4 < kLive are computed (the others stay 0): a
// product whose columns come in groups of 4 with a zero lane skips it.
template <int kLive = 4, class LA, class LB>
__device__ void product(float (&acc)[8][8], Smem& sm, const LA& la,
                        const LB& lb, int m0, int n0, int kbeg, int kend) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[4], rb[4];
  load_slab(ra, la, kbeg, kend, m0);
  load_slab(rb, lb, kbeg, kend, n0);
  store_slab<LA::kContigK, kBM>(sm.a[0], ra);
  store_slab<LB::kContigK, kBN>(sm.b[0], rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) {
      load_slab(ra, la, k0 + kBK, kend, m0);
      load_slab(rb, lb, k0 + kBK, kend, n0);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* sa = sm.a[buf][kk];
      const float* sb = sm.b[buf][kk];
      const float4 a0 = *reinterpret_cast<const float4*>(sa + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j % 4 < kLive) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_slab<LA::kContigK, kBM>(sm.a[buf ^ 1], ra);
      store_slab<LB::kContigK, kBN>(sm.b[buf ^ 1], rb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// out[e] = sum over s = 0..S-1 of part[s][e], in that order (split-K
// partials reduced without atomics, so the sum is the same every run)
__global__ void __launch_bounds__(256)
    reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                  long long n, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int q = 1; q < splits; ++q) s += part[q * n + e];
    out[e] = s;
  }
}

}  // namespace tile_gemm
