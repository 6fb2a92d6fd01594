// Frozen dynamic-filter pair on rows of 32 channels:
//
//   y[r, :] = leaky_0.2(x[r, :] . f1^T) . f2^T        (f1, f2: [32, 32], fp32)
//
// i.e. out_p = sum_q h_q f2[p, q] with h_p = leaky(sum_q x_q f1[p, q]).
//
// Replaces the TPU kernel rerevst_tpu/kernels/filter_chain.py:
// dynamic_filter_pair (the middle of _kernel_filter_frozen in
// rerevst_tpu/models/transformer.py, three times per global decode).
//
// What bounds it on the H100: 4096 flops per row against 2 x 32 storage
// elements moved (128 bytes in f16) — 32 flop/byte, above the ~20 flop/byte
// balance of fp32 CUDA-core math and well below that of the tensor cores.
// With the fp32 math this kernel must do, the fp32 CUDA-core rate is its
// bound; moving the products to the tensor cores is later work.
//
// Design: one warp per group of rows, one output channel per lane.
//   * Lane p keeps row p of both filters in registers (64 fp32 values), so
//     the products read no filter from memory at all.  The filters stay fp32
//     in every storage dtype: they are unbounded FC outputs that f16 cannot
//     hold (the TPU kernel cast them to x's dtype; not carried over).
//     A block brings them in once, with coalesced loads into shared memory
//     (rows padded to 33 floats, so neither those stores nor the lanes'
//     reads of their rows conflict): read straight from device memory,
//     lane p's row is 32 lanes on 32 cache lines for each of 64 loads.
//   * The grid is persistent (two blocks per SM, see __launch_bounds__), so
//     a block stages the filters once and then walks over many tiles.
//   * A block stages a tile of 128 rows in shared memory as fp32, loaded and
//     stored with coalesced 16-byte vectors (the ragged tail masked).
//   * For each row the warp reads the row's 32 inputs as shared-memory
//     broadcasts, each lane forms its h_p, writes it back to shared memory,
//     and after a __syncwarp reads all 32 h_q as broadcasts to form its
//     out_p.  The 32-wide intermediate stays fp32 in shared memory — never
//     in device memory, never rounded to the storage dtype.
//   * Four rows at a time give each lane four independent FMA chains.
#include "common.cuh"

namespace {

constexpr int kC = 32;          // channels per row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;      // rows per block tile
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kGroup = 4;       // rows in flight per lane
constexpr int kPad = kC + 1;    // padded filter row in shared memory
static_assert(2 * kC * kPad <= kTile * kC, "filters must fit in the tile");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) filter_pair_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long rows,
    const float* __restrict__ f1, const float* __restrict__ f2) {
  __shared__ __align__(16) float xs[kTile * kC];  // inputs, then outputs
  __shared__ __align__(16) float hs[kTile * kC];  // the intermediate

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Both filters into xs (its first use), then each lane's rows into
  // registers.
  for (int i = threadIdx.x; i < 2 * kC * kC; i += kThreads) {
    const int f = i / (kC * kC), pq = i % (kC * kC);
    xs[f * kC * kPad + (pq / kC) * kPad + pq % kC] = (f ? f2 : f1)[pq];
  }
  __syncthreads();
  float w1[kC], w2[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    w1[q] = xs[lane * kPad + q];
    w2[q] = xs[kC * kPad + lane * kPad + q];
  }
  __syncthreads();  // the tiles overwrite xs

  constexpr int V = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr int kVecs = kTile * kC / V;        // vectors per tile
  for (long long base = (long long)blockIdx.x * kTile; base < rows;
       base += (long long)gridDim.x * kTile) {
    const long long valid = rows - base < kTile ? rows - base : kTile;
    // Coalesced load of the tile, converted to fp32.
    for (int v = threadIdx.x; v < kVecs; v += kThreads) {
      const int e0 = v * V;
      alignas(16) T e[V];
      if (e0 / kC < valid) {
        *reinterpret_cast<uint4*>(e) =
            reinterpret_cast<const uint4*>(x + base * kC)[v];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = rr_from_float<T>(0.f);
      }
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(xs + e0 + j) =
            make_float4(rr_to_float(e[j]), rr_to_float(e[j + 1]),
                        rr_to_float(e[j + 2]), rr_to_float(e[j + 3]));
    }
    __syncthreads();

#pragma unroll 1
    for (int g = 0; g < kRowsPerWarp; g += kGroup) {
      const int r0 = warp * kRowsPerWarp + g;
      float acc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < kC / 4; ++q4) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float4 v = reinterpret_cast<const float4*>(xs + (r0 + i) * kC)[q4];
          acc[i] = fmaf(v.x, w1[4 * q4 + 0], acc[i]);
          acc[i] = fmaf(v.y, w1[4 * q4 + 1], acc[i]);
          acc[i] = fmaf(v.z, w1[4 * q4 + 2], acc[i]);
          acc[i] = fmaf(v.w, w1[4 * q4 + 3], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        hs[(r0 + i) * kC + lane] = acc[i] >= 0.f ? acc[i] : acc[i] * 0.2f;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < kC / 4; ++q4) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float4 h = reinterpret_cast<const float4*>(hs + (r0 + i) * kC)[q4];
          acc[i] = fmaf(h.x, w2[4 * q4 + 0], acc[i]);
          acc[i] = fmaf(h.y, w2[4 * q4 + 1], acc[i]);
          acc[i] = fmaf(h.z, w2[4 * q4 + 2], acc[i]);
          acc[i] = fmaf(h.w, w2[4 * q4 + 3], acc[i]);
        }
      }
      // Every lane has read its rows' inputs (before the __syncwarp above),
      // so the outputs may overwrite them.
#pragma unroll
      for (int i = 0; i < kGroup; ++i) xs[(r0 + i) * kC + lane] = acc[i];
    }
    __syncthreads();

    // Coalesced store of the valid rows, rounded once to the storage dtype.
    for (int v = threadIdx.x; v < kVecs; v += kThreads) {
      const int e0 = v * V;
      if (e0 / kC >= valid) continue;
      alignas(16) T e[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 o = *reinterpret_cast<const float4*>(xs + e0 + j);
        e[j] = rr_from_float<T>(o.x);
        e[j + 1] = rr_from_float<T>(o.y);
        e[j + 2] = rr_from_float<T>(o.z);
        e[j + 3] = rr_from_float<T>(o.w);
      }
      reinterpret_cast<uint4*>(y + base * kC)[v] =
          *reinterpret_cast<const uint4*>(e);
    }
    __syncthreads();  // the next tile's load overwrites xs
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long rows, const float* f1,
                   const float* f2, int grid, cudaStream_t stream) {
  if (rows <= 0 || grid <= 0) return cudaErrorInvalidValue;
  filter_pair_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, f1, f2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rr_filter_pair(int dtype, const void* x, void* y, long long rows,
                              const void* f1, const void* f2, int grid,
                              void* stream) {
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RR_F32:
      return launch<float>(x, y, rows, a, b, grid, st);
    case RR_F16:
      return launch<__half>(x, y, rows, a, b, grid, st);
    case RR_BF16:
      return launch<__nv_bfloat16>(x, y, rows, a, b, grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}
