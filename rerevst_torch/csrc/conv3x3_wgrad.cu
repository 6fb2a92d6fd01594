// Weight gradient of the SAME-padded 3x3 convolution, fp32, NHWC x NHWC ->
// HWIO:
//
//   dw[ky, kx, c, o] = sum_{n, h, w} x_pad[n, h + ky, w + kx, c] g[n, h, w, o]
//
// with x_pad x under one row and column of zeros on each side.  It is the
// backward of the fp32 routes of rr_conv3x3 (csrc/conv3x3.cu, designs
// "tf32x3" and "tf32x1"): the input gradient needs no kernel of its own (a
// SAME 3x3 conv's input gradient is the same conv of g by the weights
// rotated 180 degrees with C and O swapped, which the forward kernel
// computes), this one takes the weights'.
//
// Replaces no TPU kernel: the JAX package has no backward of its own for
// its conv kernels; it is the weight gradient that JAX's autodiff makes of
// the XLA conv at Precision HIGH (passes = 3) or DEFAULT (passes = 1) in a
// train step.
//
// What bounds it on the H100: per tap a GEMM of M = C, N = O over K = the
// N H W pixels (262144 at a train step's full resolution), so 2 9 C O K
// operations a pass at 495 TFLOP/s TF32 against x and g read once and dw
// written once at 3.35 TB/s.  At C = O = 64 that is 19.3 GFLOP a pass
// against 134 MB: the operations bound it at every shape of the train step.
//
// Design (simple first; wgmma and TMA are later work):
// * K split.  M x N is small against K (9 x 64 x 64 outputs against 262144
//   pixels), so the K tiles (row segments of kTW = 32 output pixels of one
//   image) are split over `splits` blocks per output tile, each summing a
//   contiguous run of them.  With splits > 1 each block writes its partial
//   dw into the workspace ws [splits][9][C][O] and a second kernel sums the
//   partials in split order.  No atomics: two runs give bit-equal dw.
// * Block tiles of BM = 16 MB input channels x BN = 8 NB output channels,
//   all nine taps: a K tile stages x's 3 x (kTW + 2) halo pixels (zeros past
//   the image and past C) and g's kTW pixels (zeros past W and O) once, and
//   each tap reads its shifted window of the x tile.  g's B fragment is the
//   same for every tap, x's A fragment is loaded per tap.  Warps take one
//   m16 block x WN n8 blocks x the nine taps each (9 x WN x 4 fp32
//   accumulators a thread).  Two shapes, by O (the launcher's dispatch;
//   kernels/conv3x3.py: wgrad_tile): O <= 8 -> 64 x 8 (4 warps, one n8
//   block each), else 16 x 64 (4 warps, two n8 blocks each).  Three blocks
//   an SM (__launch_bounds__: at most 170 registers a thread, no spill),
//   the k8 steps of a K tile in a loop the compiler does not unroll (fewer
//   fragments loaded ahead).  scripts/probe_wgrad.py measured the rejected
//   shapes: a 32 x 64 tile in 8 warps at one block an SM (180 registers)
//   or two (128: spills), the k8 steps unrolled, a fourth K tile.
// * Loads: cp.async, channel fastest (each warp's copies cover consecutive
//   channels of a pixel), 16 bytes a copy where C (for x) or O (for g) is a
//   multiple of 4, else 4, zero-filling what lies outside, into a ring of K
//   tiles (three; two at passes = 3, beside the lo tile).  The tiles' rows
//   are padded to a stride of 8 or 24 mod 32 floats, so a fragment's 32
//   loads hit 32 banks.  Once a tile has landed the block splits it in
//   place (hi, or the one-pass value) with the lo values in the lo tile, so
//   each value is split once and not once per warp and tap that reads it
//   (splitting the fragments in registers left the kernel issue-bound on
//   the splits: PERF.md section 6, scripts/wgrad_ab.py).
// * Products: mma.sync m16n8k8 TF32 with fp32 accumulators, A = x
//   (channels x pixels), B = g (pixels x output channels).  passes = 3:
//   each operand v = hi + lo, hi = v truncated to TF32, lo = v - hi rounded
//   to nearest TF32 (ties away), so lo never has hi's opposite sign; a lo
//   of 0 for a non-zero finite v becomes hi 2^-30 (the same sign), and an
//   infinite v splits into two equal infinities, so an infinity meets a
//   non-zero finite partner as infinities of one sign, never as inf - inf or
//   inf 0; NaN stays NaN.  x g is taken as x_hi g_hi + x_hi g_lo + x_lo g_hi:
//   with |v - hi| < 2^-10 |v| and |lo - (v - hi)| <= 2^-21 |v|, what that
//   drops (x_lo g_lo, the lo values' rounding, the 2^-30 terms) is under
//   2^-19 of |x||g| a product.  passes = 1: x_hi g_hi alone, with
//   both operands rounded to nearest TF32 (ties away; truncated where
//   rounding would overflow), each within 2^-11 of its value: at most
//   2^-10 + 2^-22 of |x||g| a product.  The fp32 sums add K_split + splits
//   terms a value (the block's pixels, then the partials).
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kTW = 32;         // output pixels of a K tile (one row segment)
constexpr int kXC = kTW + 2;    // the tile's input columns, with the halo
constexpr int kTiles = 3;       // K tiles of shared memory a block

// 4-byte global -> shared copy; with valid = false it writes zeros and
// reads nothing (`src` must still be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// TF32 of the fp32 bits v rounded to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives), for |v| below 0x7f7ff000.
__device__ __forceinline__ uint32_t rna(uint32_t v) {
  return (v + 0x1000u) & 0xffffe000u;
}

// One pass: v rounded to nearest TF32, truncated where rounding would
// overflow (|v| >= 0x7f7ff000) and for inf and NaN (a NaN stays a NaN).
__device__ __forceinline__ uint32_t tf32_round(float v) {
  const uint32_t b = __float_as_uint(v), a = b & 0x7fffffffu;
  if (a > 0x7f800000u) return 0x7fffe000u;
  return a >= 0x7f7ff000u ? b & 0xffffe000u : rna(b);
}

// Three passes: v = hi + lo (see the header).
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t b = __float_as_uint(v), a = b & 0x7fffffffu;
  if (a >= 0x7f800000u) {  // inf: two equal infinities; NaN: two NaNs
    hi = lo = a > 0x7f800000u ? 0x7fffe000u : b;
    return;
  }
  hi = b & 0xffffe000u;
  lo = rna(__float_as_uint(v - __uint_as_float(hi)));
  if (lo == 0u && a != 0u)
    lo = __float_as_uint(__uint_as_float(hi) * 0x1p-30f);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One copy of the loader: its shared-memory destination, its global source
// (a mapped address even where `ok` is false) and whether it lies inside.
struct Copy {
  float* dst;
  const float* src;
  bool ok;
};

// A row stride (in floats) of n values that puts the 4 rows a fragment
// load touches 8 banks apart: n rounded to 8 or 24 mod 32.
constexpr int padded(int n) { return n % 32 == 8 || n % 32 == 24 ? n : n + 8; }

template <int MB, int NB, int WN>
struct Wgrad {
  static constexpr int kBM = 16 * MB;            // input channels a block
  static constexpr int kBN = 8 * NB;             // output channels a block
  static constexpr int kWarps = MB * (NB / WN);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSX = padded(kBM);        // x tile: [3][kXC][kSX]
  static constexpr int kSG = padded(kBN);        // g tile: [kTW][kSG]
  static constexpr int kXF = 3 * kXC * kSX;
  static constexpr int kStage = kXF + kTW * kSG;  // floats a K tile
  static constexpr int kBytes = kTiles * kStage * 4;
  static_assert(NB % WN == 0, "warp columns");
};

// Splits a landed K tile in place, once for the block: each value becomes
// its TF32 hi (P = 3) or its one-pass TF32 value (P = 1), and (P = 3) its lo
// goes to the same offset of `lo`.  The pad columns are split too, unread.
template <int MB, int NB, int WN, int P>
__device__ __forceinline__ void split_tile(float* tile, float* lo) {
  using T = Wgrad<MB, NB, WN>;
  for (int i = threadIdx.x; i < T::kStage; i += T::kThreads) {
    if (P == 3) {
      uint32_t h, l;
      tf32_split(tile[i], h, l);
      tile[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    } else {
      tile[i] = __uint_as_float(tf32_round(tile[i]));
    }
  }
}

// One split K tile's products for a warp: acc[tap][j] += A(tap) B(j), A =
// the x tile's window of tap (ky, kx) (channels x pixels), B = the g tile
// (pixels x output channels), hi from `xs` / `gs`, lo (P = 3) from the same
// offsets `dlo` floats further on.  Ragged: the tile's last kTW - nk pixels
// lie past the image, where g is zero-filled; there the x value that tap
// kx = 0 reads at pixel nk (the image's last column) is masked to 0, so a
// non-finite x never meets those zeros (every other such x is padding).
template <int MB, int NB, int WN, int P, bool Ragged>
__device__ __forceinline__ void k_tile(float (&acc)[9][WN][4],
                                       const float* xs, const float* gs,
                                       long long dlo, int nk) {
  using T = Wgrad<MB, NB, WN>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp % MB, wn = warp / MB;  // m16 block, n8 blocks wn WN..
#pragma unroll 1
  for (int kk = 0; kk < kTW; kk += 8) {
    // B = g: b0 at (k = t, n = gq), b1 at (k = t + 4, n = gq).
    uint32_t bh[WN][2], bl[WN][2];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const float* gp = gs + (kk + t) * T::kSG + (wn * WN + j) * 8 + gq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bh[j][e] = __float_as_uint(gp[4 * e * T::kSG]);
        if (P == 3) bl[j][e] = __float_as_uint(gp[4 * e * T::kSG + dlo]);
      }
    }
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A = x of tap (ky, kx): a0 (m = gq, k = t), a1 (gq + 8, t),
        // a2 (gq, t + 4), a3 (gq + 8, t + 4); pixel k reads tile column
        // k + kx of row ky.
        const float* xp =
            xs + (ky * kXC + kk + kx + t) * T::kSX + wm * 16 + gq;
        const int off[4] = {0, 8, 4 * T::kSX, 4 * T::kSX + 8};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = __float_as_uint(xp[off[e]]);
          if (P == 3) al[e] = __float_as_uint(xp[off[e] + dlo]);
          if (Ragged && kx == 0 && kk + t + 4 * (e >> 1) == nk)
            ah[e] = al[e] = 0u;
        }
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          float(&d)[4] = acc[ky * 3 + kx][j];
          mma_tf32(d, ah, bh[j][0], bh[j][1]);
          if (P == 3) {
            mma_tf32(d, ah, bl[j][0], bl[j][1]);
            mma_tf32(d, al, bh[j][0], bh[j][1]);
          }
        }
      }
    }
  }
}

// Block (blockIdx.x = output tile, blockIdx.y = split) sums its run of K
// tiles into out: dw itself where splits = 1, else its split's slice of ws.
template <int MB, int NB, int WN, int P>
__global__ void __launch_bounds__(Wgrad<MB, NB, WN>::kThreads, 3)
    conv3x3_wgrad_kernel(const float* __restrict__ x,
                         const float* __restrict__ g, float* __restrict__ out,
                         int B, int H, int W, int C, int O, int splits) {
  using T = Wgrad<MB, NB, WN>;
  extern __shared__ __align__(16) float smem[];
  const int ctiles = (C + T::kBM - 1) / T::kBM;
  const int c0 = (blockIdx.x % ctiles) * T::kBM;
  const int o0 = (blockIdx.x / ctiles) * T::kBN;
  const int split = blockIdx.y;
  const int nsx = (W + kTW - 1) / kTW;                 // K tiles a row
  const long long total = (long long)B * H * nsx;
  const long long q0 = split * total / splits;
  const int n_tiles = (int)((split + 1) * total / splits - q0);
  const bool vec_x = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_g = O % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // The ring of K tiles in flight: three, or (P = 3) two and a tile of the
  // current one's lo values.
  constexpr int kStages = P == 3 ? kTiles - 1 : kTiles;

  // K tile q into ring slot s: x rows h - 1 .. h + 1, columns w0 - 1 ..
  // w0 + kTW, channels c0 .. c0 + kBM; g row h, columns w0 .. w0 + kTW - 1,
  // channels o0 .. o0 + kBN.
  auto load = [&](long long q, int s) {
    float* xs = smem + s * T::kStage;
    float* gs = xs + T::kXF;
    const int w0 = (int)(q % nsx) * kTW;
    const long long r = q / nsx;
    const int h = (int)(r % H);
    const long long img = r / H;
    // V channels a copy: 4 (16 bytes) where the channel count is a
    // multiple of 4 and the tensor 16-byte aligned, else 1.
    auto x_at = [&](int i, int v) {
      const int per = T::kBM / v, c = (i % per) * v, p = i / per;
      const int col = p % kXC, row = p / kXC;
      const int hh = h - 1 + row, ww = w0 - 1 + col, cc = c0 + c;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && cc < C;
      return Copy{xs + (row * kXC + col) * T::kSX + c,
                         ok ? x + ((img * H + hh) * W + ww) * (long long)C + cc
                            : x,
                         ok};
    };
    auto g_at = [&](int i, int v) {
      const int per = T::kBN / v, o = (i % per) * v, k = i / per;
      const int ww = w0 + k, oo = o0 + o;
      const bool ok = ww < W && oo < O;
      return Copy{gs + k * T::kSG + o,
                         ok ? g + ((img * H + h) * W + ww) * (long long)O + oo
                            : g,
                         ok};
    };
    if (vec_x) {
      for (int i = threadIdx.x; i < 3 * kXC * T::kBM / 4; i += T::kThreads) {
        const Copy a = x_at(i, 4);
        cp_async16(a.dst, a.src, a.ok);
      }
    } else {
      for (int i = threadIdx.x; i < 3 * kXC * T::kBM; i += T::kThreads) {
        const Copy a = x_at(i, 1);
        cp_async4(a.dst, a.src, a.ok);
      }
    }
    if (vec_g) {
      for (int i = threadIdx.x; i < kTW * T::kBN / 4; i += T::kThreads) {
        const Copy a = g_at(i, 4);
        cp_async16(a.dst, a.src, a.ok);
      }
    } else {
      for (int i = threadIdx.x; i < kTW * T::kBN; i += T::kThreads) {
        const Copy a = g_at(i, 1);
        cp_async4(a.dst, a.src, a.ok);
      }
    }
  };

  float acc[9][WN][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(q0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed
    __syncthreads();               // and every warp is done with tile i - 1
    if (i + kStages - 1 < n_tiles)
      load(q0 + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    float* xs = smem + (i % kStages) * T::kStage;
    float* lo = smem + (kTiles - 1) * T::kStage;  // unused at P = 1
    split_tile<MB, NB, WN, P>(xs, lo);
    __syncthreads();
    const long long dlo = lo - xs;
    const int rest = W - (int)((q0 + i) % nsx) * kTW;  // pixels left a row
    const int nk = rest < kTW ? rest : kTW;
    if (nk == kTW)
      k_tile<MB, NB, WN, P, false>(acc, xs, xs + T::kXF, dlo, nk);
    else
      k_tile<MB, NB, WN, P, true>(acc, xs, xs + T::kXF, dlo, nk);
  }
  cp_async_wait<0>();

  // D fragment: d0 (m = gq, n = 2t), d1 (gq, 2t + 1), d2 (gq + 8, 2t),
  // d3 (gq + 8, 2t + 1); out [9][C][O].
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp % MB, wn = warp / MB;
  float* dst = out + (splits > 1 ? (long long)split * 9 * C * O : 0);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wm * 16 + gq + 8 * (e >> 1);
        const int o = o0 + (wn * WN + j) * 8 + 2 * t + (e & 1);
        if (c < C && o < O)
          dst[((long long)tap * C + c) * O + o] = acc[tap][j][e];
      }
}

// dw[i] = sum over s = 0 .. splits - 1, in that order, of ws[s][i].
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ ws,
                                            float* __restrict__ dw,
                                            long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    dw[i] = s;
  }
}

template <int MB, int NB, int WN, int P>
cudaError_t launch(const float* x, const float* g, float* dw, float* ws,
                   int B, int H, int W, int C, int O, int splits,
                   cudaStream_t st) {
  using T = Wgrad<MB, NB, WN>;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgrad_kernel<MB, NB, WN, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (e != cudaSuccess) return e;
  const int tiles = (C + T::kBM - 1) / T::kBM * ((O + T::kBN - 1) / T::kBN);
  conv3x3_wgrad_kernel<MB, NB, WN, P>
      <<<dim3(tiles, splits), T::kThreads, T::kBytes, st>>>(
      x, g, splits > 1 ? ws : dw, B, H, W, C, O, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = 9LL * C * O;
  conv3x3_wgrad_reduce_kernel<<<(int)std::min<long long>((n + 255) / 256,
                                                          1024),
                                256, 0, st>>>(ws, dw, n, splits);
  return cudaGetLastError();
}

template <int P>
cudaError_t by_shape(const float* x, const float* g, float* dw, float* ws,
                     int B, int H, int W, int C, int O, int splits,
                     cudaStream_t st) {
  if (O <= 8) return launch<4, 1, 1, P>(x, g, dw, ws, B, H, W, C, O, splits, st);
  return launch<1, 8, 2, P>(x, g, dw, ws, B, H, W, C, O, splits, st);
}

}  // namespace

// x [B,H,W,C] and g [B,H,W,O] fp32, dw [3,3,C,O] fp32 (written whole); ws
// a scratch of splits 9 C O floats where splits > 1 (else unread, may be
// null); `splits` K splits (kernels/conv3x3.py: wgrad_plan), 1 <= splits <=
// B H ceil(W / 32); `passes` 3 (fp32-accurate) or 1.
extern "C" int rr_conv3x3_wgrad(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int C, int O,
                                int splits, int passes, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || splits <= 0 ||
      (splits > 1 && ws == nullptr) ||
      (long long)splits > (long long)B * H * ((W + kTW - 1) / kTW) ||
      splits > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* d = static_cast<float*>(dw);
  float* w = static_cast<float*>(ws);
  if (passes == 3) return by_shape<3>(xf, gf, d, w, B, H, W, C, O, splits, st);
  if (passes == 1) return by_shape<1>(xf, gf, d, w, B, H, W, C, O, splits, st);
  return cudaErrorInvalidValue;
}
