// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The reference's large negative (-2^30): masked logits and scores.
#define SALS_NEG_INF (-1073741824.0f)

// dtype codes shared with the Python wrappers
enum SalsDtype { SALS_F32 = 0, SALS_BF16 = 1, SALS_I8 = 2 };

template <typename T>
__device__ __forceinline__ float sals_to_f(T x);
template <>
__device__ __forceinline__ float sals_to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float sals_to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float sals_to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// Load element i of a bf16-or-f32 array chosen at run time.
__device__ __forceinline__ float sals_load(const void* p, int dtype,
                                           size_t i) {
  return dtype == SALS_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float sals_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
