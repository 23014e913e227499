// Element and tile movement shared by the port's kernels: f32 or bf16 in
// device memory, f32 in registers and shared memory, cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile_io {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A tile row moves as 16-byte vectors: 4 floats or 8 bf16 per load.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

// Widen one 16-byte vector loaded from a T array into f32 at dst (the
// pointer argument only selects T).
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw,
                                          const float*) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw,
                                          const __nv_bfloat16*) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// cp.async of 16 bytes, read at L2 only (.cg), and its group fences
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tile_io
