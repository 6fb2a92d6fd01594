// Shared helpers of the port's CUDA kernels: storage-dtype codes and fp32
// conversions of each storage dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage-dtype codes, as the Python wrappers pass them (kernels/_build.py).
enum RrDtype { RR_NONE = 0, RR_F32 = 1, RR_F16 = 2, RR_BF16 = 3 };

__device__ __forceinline__ float rr_to_float(float v) { return v; }
__device__ __forceinline__ float rr_to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float rr_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T rr_from_float(float v);
template <> __device__ __forceinline__ float rr_from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half rr_from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 rr_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
