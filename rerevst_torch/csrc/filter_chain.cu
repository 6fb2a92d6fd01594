// Frozen dynamic-filter pair on rows of 32 channels:
//
//   y[r, :] = leaky_0.2(x[r, :] . f1^T) . f2^T        (f1, f2: [32, 32], fp32)
//
// i.e. out_p = sum_q h_q f2[p, q] with h_p = leaky(sum_q x_q f1[p, q]).
//
// Replaces the TPU kernel rerevst_tpu/kernels/filter_chain.py:
// dynamic_filter_pair (the middle of _kernel_filter_frozen in
// rerevst_tpu/models/transformer.py, three times per global decode).  The
// filters and the intermediate stay fp32-accurate in every storage dtype
// (the TPU kernel cast the filters to x's dtype: they are unbounded FC
// outputs that f16 cannot hold); the output is rounded once to x's dtype.
//
// What bounds it on the H100: a row moves 2 x 32 storage elements (128
// bytes in f16) for 4096 flops.  On the tensor cores at fp32 accuracy (three
// TF32 passes at 495 TFLOP/s) the flops take less time than the bytes at
// 3.35 TB/s, so the bytes bound it.  The design keeps bytes in flight and
// the products off the CUDA cores.
//
// Products: mma.sync m16n8k8 TF32 with fp32 accumulators, made fp32-accurate
// by a split.  Each fp32 operand v becomes hi = rna_tf32(v) and
// lo = rna_tf32(v - hi) (the mma ignores an operand's low 13 bits, so the
// rounding is explicit), and a.b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi.
// f16 and bf16 inputs are exact in TF32, so the first product needs only the
// filter's split (2 passes); fp32 inputs need 3, and so does the second
// product's fp32 intermediate.  What the split drops (a_lo b_lo and the two
// rounding remainders) is at most 3 x 2^-22 (about 2^-20.4) of |a||b| per
// product, 2^-22 for a 16-bit x, so at most that share of sum |a||b| over a
// row, plus the fp32 accumulation's own rounding: well inside the checks'
// 1e-5 (about 2^-16.6) of the output's scale.  TF32 keeps fp32's exponent
// range, so filters of 1e5 or 1e-6 cost nothing (an f16 or bf16 split would
// not hold them).  inf splits into hi = inf and lo = NaN: a row with a
// non-finite input comes out non-finite, as the plain version's does.
//
// The intermediate stays in registers.  m16n8k8's fp32 C fragment of an n
// block holds columns (2t, 2t+1) at rows (g, g + 8) (lane = 4 g + t), and its
// A fragment takes columns (t, t + 4).  Numbering the second product's k in
// each 8-block so that column 2t is k = t and 2t + 1 is k = t + 4 makes the
// first product's C fragment the second's A fragment:
// a0, a1, a2, a3 = c0, c2, c1, c3 (after the leaky and the split), with f2's
// B fragments loaded under the same numbering.  No shared memory, no
// __syncwarp, no rounding of the intermediate.
//
// Channel numbering (any bijection works for a k or n dimension, as long as
// both operands use it):
//   * a lane's 8 values of a row, m = 0..7, are channels
//     ch(t, m) = V (4 (m / V) + t) + m % V with V = 8 channels per 16-byte
//     chunk in 16-bit storage (channels 8t .. 8t + 7, one chunk) and V = 4
//     in fp32 (two chunks, 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3), so a
//     copy or store instruction covers whole 32-byte sectors of 8 rows;
//   * first product, k block kb: k = t is value 2 kb, k = t + 4 value
//     2 kb + 1 (its channel by ch);
//   * first product n / second product k: h channel 8 nb + column;
//   * second product, n block nb, column c = 2t + j: value 2 nb + j, i.e.
//     output channel ch(c / 2, 2 nb + c % 2), so a lane writes its 8 values
//     of a row where it read them.
// tests/test_torch_filter_pair_plan.py emulates these maps on the CPU.
//
// Rows: a persistent grid (one block per SM) from the wrapper's plan
// (kernels/filter_chain.py: row_plan).  Block b takes the contiguous 16-row
// tiles [b T / grid, (b + 1) T / grid) of the T tiles, so shares differ by at
// most one tile; its warps take those tiles in turn.  A warp's loop is
// software-pipelined: one body holds tile i + 1's first product and tile
// i's split, second product and store, so the scheduler fills one's mma
// waits with the other's work.  Each warp streams its tiles through a
// cp.async ring of its own (kStages tiles), each lane copying exactly the
// 16-byte chunks it later reads, so a lane needs only its own
// cp.async.wait_group and no barrier; a slot is refilled once the first
// product has used its values.  Rows past the end are zero-filled by the
// copy (nothing is read) and never stored.  Each warp keeps the hi and lo
// B fragments of both filters in registers (4 x 32 a lane), loaded once
// while its first tiles are in flight.
#include "common.cuh"

namespace {

constexpr int kC = 32;           // channels per row
constexpr int kTileRows = 16;    // rows per mma tile (m16n8k8's M)
constexpr int kB = kC / 8;       // 8-wide k and n blocks per product
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Tiles in each warp's cp.async ring.  Deeper rings measured slower on the
// H100 at the main path's shape (6-7 tiles a warp): all warps' early copies
// at once delay every warp's first tile, and the math, not the copies,
// sets the pace after it.
constexpr int kStages = 2;

// hi = rna_tf32(v) with its low 13 bits cleared, as the mma reads it.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One pass of a k block: d[nb] += a . b[nb] for every n block.
__device__ __forceinline__ void mma_pass(float (&d)[kB][4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[kB][2]) {
#pragma unroll
  for (int nb = 0; nb < kB; ++nb) mma_tf32(d[nb], a, b[nb]);
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * 0.2f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) filter_pair_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long rows,
    const float* __restrict__ f1, const float* __restrict__ f2) {
  constexpr int kChunks = sizeof(T) / 2;  // 16-byte chunks of a lane's row
  constexpr int kStageBytes = kTileRows * kC * sizeof(T);
  constexpr bool kSplitX = sizeof(T) == 4;          // 16-bit x is exact TF32
  // The channel of a lane's value m (of its 8 in a row): lane t's chunk k
  // holds channels kV (4k + t) .. + kV - 1, so each copy and store
  // instruction covers whole 32-byte sectors of a row.
  constexpr int kV = 16 / sizeof(T);  // channels per 16-byte chunk
  auto ch = [](int t, int m) { return kV * (4 * (m / kV) + t) + m % kV; };
  __shared__ __align__(16) unsigned char smem[kWarps * kStages * kStageBytes];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + warp * kStages * kStageBytes;

  // This block's contiguous share of the 16-row tiles; its warps take them
  // in turn.
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  const long long end = (blockIdx.x + 1LL) * tiles / gridDim.x;
  const long long first = blockIdx.x * tiles / gridDim.x + warp;
  const int n = first < end ? (int)((end - first + kWarps - 1) / kWarps) : 0;

  // The i-th tile of this warp into ring slot i % kStages: the lane's chunks
  // of rows g and g + 8, chunk k of the lane at (k * 32 + lane) * 16, so both
  // the copies and the reads are 32 lanes on 512 consecutive bytes.  Past
  // the warp's last tile the copies only zero-fill (no branch, so the loop
  // body below stays one block for the scheduler).
  auto issue = [&](int i) {
    const long long tile = first + (long long)i * kWarps;
    unsigned char* slot = ring + (i % kStages) * kStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = tile * kTileRows + g + 8 * h;
      const bool ok = i < n && r < rows;
      const uint4* src = reinterpret_cast<const uint4*>(x + (ok ? r * kC : 0));
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        cp_async16(slot + ((h * kChunks + c) * 32 + lane) * 16,
                   src + 4 * c + t, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);

  // B fragments (b0 at k = t, b1 at k = t + 4, column n = g of the block),
  // hi and lo, while the first tiles are in flight.
  //   first product (kb, nb):  f1[8 nb + g][ch(t, 2 kb + j)]
  //   second product (kb, nb): f2[ch(g / 2, 2 nb + g % 2)][8 kb + 2 t + j]
  uint32_t b1h[kB][kB][2], b1l[kB][kB][2], b2h[kB][kB][2], b2l[kB][kB][2];
#pragma unroll
  for (int nb = 0; nb < kB; ++nb) {
    const float* row = f1 + (8 * nb + g) * kC;
    const float4 u = __ldg(reinterpret_cast<const float4*>(row + ch(t, 0)));
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + ch(t, 4)));
    const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int kb = 0; kb < kB; ++kb)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split(w[2 * kb + j], b1h[kb][nb][j], b1l[kb][nb][j]);
    const float* prow = f2 + ch(g >> 1, 2 * nb + (g & 1)) * kC + 2 * t;
#pragma unroll
    for (int kb = 0; kb < kB; ++kb) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(prow + 8 * kb));
      split(q.x, b2h[kb][nb][0], b2l[kb][nb][0]);
      split(q.y, b2h[kb][nb][1], b2l[kb][nb][1]);
    }
  }

  // h = x . f1^T for tile i: A of k block kb is values 2 kb and 2 kb + 1
  // of both rows.  Its slot is refilled once the products have used it.
  auto first_product = [&](int i, float (&acc)[kB][4]) {
    // One group was committed per slot: tile i's copies have landed once
    // at most kStages - 1 groups are pending.
    cp_async_wait<kStages - 1>();
    const unsigned char* slot = ring + (i % kStages) * kStageBytes;
    float e[2][8];  // rows g and g + 8, value m at channel ch(t, m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alignas(16) T v[8];
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        reinterpret_cast<uint4*>(v)[k] = *reinterpret_cast<const uint4*>(
            slot + ((h * kChunks + k) * 32 + lane) * 16);
#pragma unroll
      for (int m = 0; m < 8; ++m) e[h][m] = rr_to_float(v[m]);
    }
#pragma unroll
    for (int nb = 0; nb < kB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][j] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kB; ++kb) {
      const float a[4] = {e[0][2 * kb], e[1][2 * kb], e[0][2 * kb + 1],
                          e[1][2 * kb + 1]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kSplitX) {
          split(a[j], ah[j], al[j]);
        } else {
          ah[j] = __float_as_uint(a[j]);
        }
      }
      // Pass by pass, so that consecutive mmas write other accumulators.
      if constexpr (kSplitX) mma_pass(acc, al, b1h[kb]);
      mma_pass(acc, ah, b1l[kb]);
      mma_pass(acc, ah, b1h[kb]);
    }
    // The slot's reads stay before its refill (a compiler barrier; the warp
    // issues in order, and the copy writes only once its data arrives).
    asm volatile("" ::: "memory");
    issue(i + kStages);
  };

  // out = leaky(h) . f2^T for tile i, stored: A of k block kb is the first
  // product's C of n block kb, as c0, c2, c1, c3.
  auto second_product = [&](int i, const float (&acc)[kB][4]) {
    float out[kB][4];
#pragma unroll
    for (int nb = 0; nb < kB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[nb][j] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kB; ++kb) {
      const float hv[4] = {leaky(acc[kb][0]), leaky(acc[kb][2]),
                           leaky(acc[kb][1]), leaky(acc[kb][3])};
      uint32_t hh[4], hl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split(hv[j], hh[j], hl[j]);
      mma_pass(out, hl, b2h[kb]);
      mma_pass(out, hh, b2l[kb]);
      mma_pass(out, hh, b2h[kb]);
    }
    // Output channel ch(t, 2 nb + j) of row g is out[nb][j], of row g + 8
    // out[nb][2 + j]: the lane's 8 values of each row, as it read x.
    const long long tile = first + (long long)i * kWarps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = tile * kTileRows + g + 8 * h;
      alignas(16) T o[8];
#pragma unroll
      for (int nb = 0; nb < kB; ++nb) {
        o[2 * nb] = rr_from_float<T>(out[nb][2 * h]);
        o[2 * nb + 1] = rr_from_float<T>(out[nb][2 * h + 1]);
      }
      uint4* dst = reinterpret_cast<uint4*>(y + r * kC);
      if (r < rows) {
#pragma unroll
        for (int k = 0; k < kChunks; ++k)
          dst[4 * k + t] = reinterpret_cast<const uint4*>(o)[k];
      }
    }
  };

  // Software-pipelined: tile i + 1's first product and tile i's split and
  // second product share one loop body, so the scheduler fills one's mma
  // waits with the other's work.
  // (A warp's zero-fill copies past its last tile are waited for before it
  // exits: nothing writes the block's shared memory after the block ends.)
  if (n == 0) {
    cp_async_wait<0>();
    return;
  }
  float acc[kB][4], next[kB][4];
  first_product(0, acc);
#pragma unroll 1
  for (int i = 0; i + 1 < n; ++i) {
    first_product(i + 1, next);
    second_product(i, acc);
#pragma unroll
    for (int nb = 0; nb < kB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][j] = next[nb][j];
  }
  second_product(n - 1, acc);
  cp_async_wait<0>();
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
