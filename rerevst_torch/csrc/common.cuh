// Shared helpers of the port's CUDA kernels: storage-dtype codes, fp32
// conversions of each storage dtype, and cp.async.
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

// cp.async helpers.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid = false it writes 16 zero bytes
// and reads nothing (`src` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
