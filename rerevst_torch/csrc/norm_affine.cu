// Frozen-statistics normalize + clamp (+ style affine) over a contiguous
// NHWC tensor, per element of channel c:
//
//   v = leaky ? (x >= 0 ? x : 0.2 x) : x            (x read in storage dtype)
//   y = min(max((v - mean[c]) * rstd[c], xmin[c]), xmax[c])
//   if affine: y = y * s[c] + m[c]                   (s, m promoted to fp32)
//
// all in fp32, stored once in the storage dtype.
//
// Replaces the TPU kernel rerevst_tpu/kernels/norm_affine.py:norm_affine_clamp
// (and the inline _norm_apply of rerevst_tpu/models/transformer.py that the
// global decoder evaluates at 11 sites per call).
//
// What bounds it on the H100: bytes.  One read and one write of the
// activation, a handful of flops per element — about 0.1 flop per byte,
// far below the ~20 flop/byte where fp32 CUDA-core math would take over.
// The design therefore spends nothing but the two streams:
//   * one thread per 16-byte vector (8 f16/bf16 or 4 fp32 elements), so each
//     warp moves 512 contiguous bytes per load and per store;
//   * a block is (C/V) x (256/(C/V)) threads: threadIdx.x owns one channel
//     vector for the block's whole life, so its per-channel constants (mean,
//     rstd, xmin, xmax, s, m) are read once into registers — no shared-memory
//     traffic in the loop;
//   * a grid-stride loop over rows masks the ragged tail (the TPU kernel
//     padded the rows to its tile instead);
//   * subtract, then scale: (v - mean) * rstd, NOT the folded x*rstd +
//     (-mean*rstd) of the TPU kernel — rstd reaches 1e6 on degenerate
//     channels and the folded form then cancels catastrophically.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename A, bool LEAKY, bool AFFINE>
__global__ void __launch_bounds__(kThreads) norm_affine_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long rows, int C,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ xmin, const float* __restrict__ xmax,
    const A* __restrict__ s, const A* __restrict__ m) {
  constexpr int V = 16 / sizeof(T);
  const int c0 = threadIdx.x * V;
  float mu[V], rs[V], lo[V], hi[V], sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = mean[c0 + j];
    rs[j] = rstd[c0 + j];
    lo[j] = xmin[c0 + j];
    hi[j] = xmax[c0 + j];
    if (AFFINE) {
      sc[j] = rr_to_float(s[c0 + j]);
      sh[j] = rr_to_float(m[c0 + j]);
    }
  }
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < rows;
       r += step) {
    const long long off = r * C + c0;
    alignas(16) T e[V];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(x + off);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = rr_to_float(e[j]);
      if (LEAKY) v = v >= 0.f ? v : v * 0.2f;
      float t = __fmul_rn(__fsub_rn(v, mu[j]), rs[j]);
      t = fminf(fmaxf(t, lo[j]), hi[j]);
      // Round the product, then the sum, as the plain version does (no FMA
      // contraction), so the two agree bit for bit.
      if (AFFINE) t = __fadd_rn(__fmul_rn(t, sc[j]), sh[j]);
      e[j] = rr_from_float<T>(t);
    }
    *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(e);
  }
}

template <typename T, typename A, bool AFFINE>
cudaError_t launch(int leaky, const void* x, void* y, long long rows, int C,
                   const float* mean, const float* rstd, const float* xmin,
                   const float* xmax, const void* s, const void* m, int grid,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (C % V != 0 || C / V > kThreads || rows <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  const int lanes = C / V;
  dim3 block(lanes, kThreads / lanes);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const A* st = static_cast<const A*>(s);
  const A* mt = static_cast<const A*>(m);
  if (leaky)
    norm_affine_kernel<T, A, true, AFFINE><<<grid, block, 0, stream>>>(
        xt, yt, rows, C, mean, rstd, xmin, xmax, st, mt);
  else
    norm_affine_kernel<T, A, false, AFFINE><<<grid, block, 0, stream>>>(
        xt, yt, rows, C, mean, rstd, xmin, xmax, st, mt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_affine(int affine_dtype, int leaky, const void* x, void* y,
                            long long rows, int C, const float* mean,
                            const float* rstd, const float* xmin,
                            const float* xmax, const void* s, const void* m,
                            int grid, cudaStream_t stream) {
  switch (affine_dtype) {
    case RR_NONE:
      return launch<T, float, false>(leaky, x, y, rows, C, mean, rstd, xmin,
                                     xmax, nullptr, nullptr, grid, stream);
    case RR_F32:
      return launch<T, float, true>(leaky, x, y, rows, C, mean, rstd, xmin,
                                    xmax, s, m, grid, stream);
    case RR_F16:
      return launch<T, __half, true>(leaky, x, y, rows, C, mean, rstd, xmin,
                                     xmax, s, m, grid, stream);
    case RR_BF16:
      return launch<T, __nv_bfloat16, true>(leaky, x, y, rows, C, mean, rstd,
                                            xmin, xmax, s, m, grid, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rr_norm_affine(int dtype, int affine_dtype, int leaky,
                              const void* x, void* y, long long rows, int C,
                              const void* mean, const void* rstd,
                              const void* xmin, const void* xmax, const void* s,
                              const void* m, int grid, void* stream) {
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* lo = static_cast<const float*>(xmin);
  const float* hi = static_cast<const float*>(xmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RR_F32:
      return dispatch_affine<float>(affine_dtype, leaky, x, y, rows, C, mu, rs,
                                    lo, hi, s, m, grid, st);
    case RR_F16:
      return dispatch_affine<__half>(affine_dtype, leaky, x, y, rows, C, mu, rs,
                                     lo, hi, s, m, grid, st);
    case RR_BF16:
      return dispatch_affine<__nv_bfloat16>(affine_dtype, leaky, x, y, rows, C,
                                            mu, rs, lo, hi, s, m, grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}
