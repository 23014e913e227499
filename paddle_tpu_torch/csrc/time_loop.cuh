// Plumbing shared by the GRU and tanh-RNN time-loop kernels
// (fused_gru.cu, fused_rnn.cu): the cooperative launch with its
// co-residency check, the (row, unit) pairs a thread carries, operand
// rounding to the weight's dtype, and the cp.async staging of f32 tiles
// that other CTAs write during the launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tile_io.cuh"

namespace time_loop {

using tile_io::load_f;
using tile_io::store_f;

constexpr int kMaxPairs = 4;  // (row, unit) pairs one thread carries
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// an operand rounded to the weight's dtype, as the TPU kernel casts it
// before its f32-accumulating product
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage columns [k0, k0+kw) of the f32 array src [B, ld_src] (kw, k0 and
// ld_src multiples of 4) into tile [B][ld]: 16 bytes a copy, read at L2
// only (.cg: L1 is not coherent across SMs, and other CTAs write these
// buffers during the launch), every copy of the thread in flight at
// once. The caller synchronises the block after it.
__device__ __forceinline__ void stage_tile(float* tile, int ld,
                                           const float* src, int ld_src,
                                           int B, int k0, int kw) {
  const int q = kw / 4;
  for (int e = threadIdx.x; e < B * q; e += blockDim.x) {
    const int b = e / q, c = (e % q) * 4;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tile + b * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + (size_t)b * ld_src + k0 + c));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's (row, unit) pairs: pair p = tid + n * blockDim; returns
// how many it has
__device__ __forceinline__ int my_pairs(int (&pb)[kMaxPairs],
                                        int (&pu)[kMaxPairs], int B, int hb) {
  int np = 0;
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    const int p = threadIdx.x + n * blockDim.x;
    pb[n] = 0;
    pu[n] = 0;
    if (p < B * hb) {
      pb[n] = p / hb;
      pu[n] = p % hb;
      np = n + 1;
    }
  }
  return np;
}

// Launch kern over `grid` CTAs as one cooperative launch, after checking
// that the grid can be co-resident (a grid barrier over CTAs that cannot
// all run at once never returns).
template <typename K>
cudaError_t launch_coop(K kern, int grid, int threads, size_t smem,
                        void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Call f(T*, TW*) with null pointers whose types select x_proj's and
// w_hh's element types from the host's codes (0 = float32, 1 = bfloat16);
// returns f's cudaError_t as an int.
template <typename F>
int dispatch_dtypes(int x_dtype, int w_dtype, F&& f) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)f(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
  if (x_dtype == 0 && w_dtype == 1)
    return (int)f(static_cast<float*>(nullptr), static_cast<bf16*>(nullptr));
  if (x_dtype == 1 && w_dtype == 0)
    return (int)f(static_cast<bf16*>(nullptr), static_cast<float*>(nullptr));
  if (x_dtype == 1 && w_dtype == 1)
    return (int)f(static_cast<bf16*>(nullptr), static_cast<bf16*>(nullptr));
  return (int)cudaErrorInvalidValue;
}

// The card's limits the host's geometry needs: out[0] = SM count, out[1] =
// shared memory a block may opt in to (bytes), out[2] = 1 if cooperative
// launches are supported.
inline int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  return (int)cudaGetLastError();
}

}  // namespace time_loop
