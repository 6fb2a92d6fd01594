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
// The arithmetic (both routes).  Products on the tensor cores in TF32 with
// fp32 sums.  passes = 3: each operand v = hi + lo, hi = v truncated to
// TF32, lo = v - hi rounded to nearest TF32 (ties away), so lo never has
// hi's opposite sign; a lo of 0 for a non-zero finite v becomes hi 2^-30
// (the same sign), and an infinite v splits into two equal infinities, so
// an infinity meets a non-zero finite partner as infinities of one sign,
// never as inf - inf or inf 0; NaN stays NaN.  x g is taken as x_hi g_hi +
// x_hi g_lo + x_lo g_hi: with |v - hi| < 2^-10 |v| and |lo - (v - hi)| <=
// 2^-21 |v|, what that drops (x_lo g_lo, the lo values' rounding, the
// 2^-30 terms) is under 2^-19 of |x||g| a product.  passes = 1: x_hi g_hi
// alone, with both operands rounded to nearest TF32 (ties away; truncated
// where rounding would overflow), each within 2^-11 of its value: at most
// 2^-10 + 2^-22 of |x||g| a product.  The fp32 sums add K_split + splits
// terms a value (a block's pixels, then the partials).  K is cut into K
// tiles, row segments of kTW = 32 output pixels of one image, and split
// over `splits` blocks per output tile (kernels/conv3x3.py: wgrad_plan),
// each summing a contiguous run of them.  With splits > 1 the partials are
// summed in split order through the workspace ws [splits][9][C][O] and a
// second kernel.  No atomics: two runs give bit-equal dw.
//
// Which route takes which call (the launcher's dispatch, mirrored by
// kernels/conv3x3.py: wgrad_route):
// * C >= 8, O >= 8, C and O multiples of 4 and x and g 16-byte aligned --
//   every shape of a train step but the two of the RGB layers: the wgmma
//   route below (conv3x3_wgrad_tc_kernel).
// * Any other shape (a train step's [4,256,256,3] -> 64 and [4,256,256,64]
//   -> 3, whose 12-byte pixels no tensor map takes and which a 64-row
//   wgmma tile would waste): the mma.sync route below
//   (conv3x3_wgrad_kernel, kept from the first version of this kernel).
//
// The wgmma route.  A unit is 64 input channels (wgmma's M) x 32 output
// channels (N) x all nine taps; an item is a unit's split: its run of K
// tiles.  One block an SM (one item each where the plan makes as many
// items as SMs or fewer; persistent blocks walk items it = blockIdx.x, +
// gridDim.x, ... where units alone outnumber the SMs).
// * The GEMM's operands.  .tf32 wgmma reads shared-memory operands only
//   K-major, and in NHWC both x and g lie channel-contiguous, which is
//   MN-major for this GEMM: neither lands K-major from a TMA box.  So g is
//   B, from shared memory, transposed on the way (it is the operand all
//   nine taps share), and x is A, from registers, which any layout can
//   feed.
// * The shift moves to B.  dw[ky, kx] = sum_u x[h + ky - 1, u] g[h, u -
//   kx + 1] over the x columns u of a K tile: A, the tile's 32 pixels of x
//   row h + ky - 1, is the same for the three taps kx of a row, and each
//   tap takes its own copy of g shifted by kx - 1.  A warp loads its A
//   fragments once a row and feeds them to three taps, with hi and lo made
//   in registers (tf32_split) as they arrive.
// * Roles: three consumer warpgroups, one tap row ky each (its 3 taps'
//   m64n32 accumulators, and at passes = 3 an accumulator of the two
//   correction products beside each: wgmma truncates its fp32 sums, so a
//   chain that takes the small corrections into the main sum shrinks it;
//   kept apart they truncate at 2^-11 of the size, and the two are added in
//   the epilogue); a producer warpgroup whose first thread issues the TMA
//   loads and whose other three warps make the B copies.  setmaxnreg moves
//   registers from the producer (56) to the consumers (152): at the
//   launch's 128 the three-pass consumers spill and ptxas serializes their
//   wgmmas (scripts/probe_wgrad.py no_setmaxnreg).
// * Loads: TMA with the hardware's zero fill for the SAME halo and the
//   ragged edges.  A stage is one K tile: x as two boxes {32 channels, 32
//   pixels, 3 rows, 1} (rows h - 1 .. h + 1) with the 128-byte swizzle,
//   and g as a box {32 channels, 34 pixels, 1, 1} (columns w0 - 1 .. w0 +
//   32), in a ring of stages with a full, a ready and an empty mbarrier
//   each (4 stages at passes = 3, 5 at one).
// * A from the landed box.  wgmma's A fragment for a k8 step gives lane
//   (gq = lane / 4, t = lane % 4) of warp w rows (input channels) 16 w +
//   gq, + 8 and K indices t, t + 4; K index t is taken as pixel 2 t and t
//   + 4 as pixel 2 t + 1 of the step (B's rows follow the same order), so
//   the 32 lanes' 4-byte loads from the swizzled box (16-byte chunk c of
//   pixel p at c ^ (p % 8)) hit 32 banks.
// * B: the splitter warps write each tap kx's copy of g, hi and lo planes
//   (or the one-pass value), as wgmma's K-major B with the 128-byte
//   swizzle: output channel n is a 128-byte row of the tile's 32 K values
//   (K order as A's), eight rows a 1024-byte group; a k8 step is 32 bytes
//   into the row.  A task is one channel n at one k8 step: its ten box
//   columns, split once, give the six 16-byte chunks of the three taps
//   (one vector store each; eight lanes of consecutive n hit eight bank
//   groups).  The splits are selects, not branches: with a branch per
//   value the compiler chained them one by one, and the splitter warps,
//   not the products, set the pace.
// * Non-finite x at the image's edge columns.  Tap kx = 0 takes no product
//   at the image's last column u = W - 1, tap kx = 2 none at u = 0: there
//   B holds the zero fill, and a finite x times 0 adds nothing; an
//   infinite x would add inf 0 = NaN.  The splitter warps flag a stage
//   whose x holds a non-finite value at those columns, and there the
//   consumers issue the three taps one after another, each from A loaded
//   again with that column zeroed for the tap that excludes it.
// * Non-finite g at the image's edge columns.  The column padding's own
//   products, 0 g[0] at u = -1 (tap kx = 0) and 0 g[W - 1] at u = W (tap
//   kx = 2), lie in no K tile where W is a multiple of 32, and 0 inf = NaN.
//   Where g is non-finite there, the splitter warps write a NaN into that
//   tap's B copy of the output channel (its first K value, in place of
//   a g that the NaN sum makes moot): NaN times any x is NaN, so the
//   channel's sums are NaN in every row, which is what the missing
//   products add.  The consumers hold nothing more for it.
// * A stage's products for a warpgroup: 4 k8 steps x 3 taps x (1 or 3)
//   wgmma.mma_async m64n32k8 .tf32, a group a step, the next step's A
//   loaded while a group runs; the last group is waited for before the
//   stage goes back to the producer, while the other two warpgroups'
//   groups keep the tensor cores busy.  At one pass each tile's chain is
//   then added into a register sum with fp32 adds (the three-pass
//   registers of the corrections), so no chain of truncating wgmmas runs
//   longer than a K tile; at three passes there are no registers for it
//   and the x_hi g_hi chain runs over the block's K_split (chip_smoke.py
//   check_wgrad bars its mean signed error).
// * The epilogue writes each thread's accumulator pairs straight to dw (or
//   its split's slice of ws) as 8-byte vectors, while the producer loads
//   the next item's stages.
// * The plan (kernels/conv3x3.py: wgrad_plan): as many splits as keep
//   units x splits within the SMs and no more than there are K tiles.  A
//   reduction inside thread block clusters, with no workspace, was tried:
//   at equal splits it was no faster than the workspace, and its cap on
//   the workspace cost more than it saved.
// * Measured (scripts/conv_ab.py --wgrad, scripts/probe_wgrad.py; NVIDIA
//   H100 80GB HBM3 at 700 W; PERF.md section 6, row 5): 14.5-14.6 ms over
//   a 'high' train step's 133 launches (the mma.sync route at every shape,
//   as this kernel first was: 39.2-39.4), 9.6 at one pass (25.4-25.5).
//   Mean signed error against float64 at those shapes: three passes -5.9e-7
//   .. -8.4e-6 (the mma.sync route: -1.0e-6 .. -6.6e-6): each block's x_hi
//   g_hi chain of K_split / 8 wgmmas truncates its sums; one pass -1.9e-6
//   .. +2.3e-6 with the register sum (-5.0e-7 .. -8.5e-6 without it, which
//   saves 0.4 ms a step: probe variant no_promotion).
//
// The mma.sync route (kept for the shapes above).  Block tiles of BM = 16
// MB input channels x BN = 8 NB output channels, all nine taps: a K tile
// stages x's 3 x (kTW + 2) halo pixels (zeros past the image and past C)
// and g's kTW pixels (zeros past W and O) once with cp.async, the block
// splits it in place once (hi, or the one-pass value, with the lo values
// in a lo tile), and each tap reads its shifted window of the x tile with
// mma.sync m16n8k8 TF32: 64 x 8 (O <= 8, 4 warps, one n8 block each), else
// 16 x 64 (4 warps, two n8 blocks each), three blocks an SM.  Ragged: the
// tile's last kTW - nk pixels lie past the image, where g is zero-filled;
// there the x value that tap kx = 0 reads at pixel nk (the image's last
// column) is masked to 0, so a non-finite x never meets those zeros.
#include "common.cuh"

#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Both routes
// ---------------------------------------------------------------------------

constexpr int kTW = 32;         // output pixels of a K tile (one row segment)
constexpr int kXC = kTW + 2;    // its columns with the halo

// TF32 of the fp32 bits v rounded to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives), for |v| below 0x7f7ff000.
__device__ __forceinline__ uint32_t rna(uint32_t v) {
  return (v + 0x1000u) & 0xffffe000u;
}

// One pass: v rounded to nearest TF32, truncated where rounding would
// overflow (|v| >= 0x7f7ff000) and for inf and NaN (a NaN stays a NaN).
// Selects, no branch: the callers split many independent values at once.
__device__ __forceinline__ uint32_t tf32_round(float v) {
  const uint32_t b = __float_as_uint(v), a = b & 0x7fffffffu;
  const uint32_t r = a >= 0x7f7ff000u ? b & 0xffffe000u : rna(b);
  return a > 0x7f800000u ? 0x7fffe000u : r;
}

// Three passes: v = hi + lo (see the header), in selects.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t b = __float_as_uint(v), a = b & 0x7fffffffu;
  const uint32_t h = b & 0xffffe000u;
  uint32_t l = rna(__float_as_uint(v - __uint_as_float(h)));
  l = l == 0u && a != 0u ? __float_as_uint(__uint_as_float(h) * 0x1p-30f)
                         : l;
  // inf: two equal infinities; NaN: two NaNs
  const uint32_t special = a > 0x7f800000u ? 0x7fffe000u : b;
  hi = a >= 0x7f800000u ? special : h;
  lo = a >= 0x7f800000u ? special : l;
}

// ---------------------------------------------------------------------------
// The mma.sync route (C < 8, O < 8, C or O off a multiple of 4, or a
// tensor off 16 bytes)
// ---------------------------------------------------------------------------

constexpr int kTiles = 3;       // K tiles of shared memory a block

// 4-byte global -> shared copy; with valid = false it writes zeros and
// reads nothing (`src` must still be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

template <int MB, int NB, int WN, int P>
cudaError_t launch_mma(const float* x, const float* g, float* out, int B,
                       int H, int W, int C, int O, int splits,
                       cudaStream_t st) {
  using T = Wgrad<MB, NB, WN>;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgrad_kernel<MB, NB, WN, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (e != cudaSuccess) return e;
  const int tiles = (C + T::kBM - 1) / T::kBM * ((O + T::kBN - 1) / T::kBN);
  conv3x3_wgrad_kernel<MB, NB, WN, P>
      <<<dim3(tiles, splits), T::kThreads, T::kBytes, st>>>(
      x, g, out, B, H, W, C, O, splits);
  return cudaGetLastError();
}

template <int P>
cudaError_t by_shape(const float* x, const float* g, float* out, int B, int H,
                     int W, int C, int O, int splits, cudaStream_t st) {
  if (O <= 8) return launch_mma<4, 1, 1, P>(x, g, out, B, H, W, C, O, splits, st);
  return launch_mma<1, 8, 2, P>(x, g, out, B, H, W, C, O, splits, st);
}

// ---------------------------------------------------------------------------
// The wgmma route (the design above)
// ---------------------------------------------------------------------------

constexpr int kTcM = 64;                 // input channels of a unit (M)
constexpr int kTcN = 32;                 // output channels of a unit (N)
constexpr int kTcConsumers = 3;          // consumer warpgroups: tap row ky
constexpr int kTcSplitters = 3;          // producer warps that make B
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kXBox = 3 * kTW * 128;     // a box of x: 3 rows x 32 px x 128 B
constexpr int kXRow = kTW * 128;         // one row of it
constexpr int kGLand = (kXC * kTcN * 4 + 1023) / 1024 * 1024;  // g's box
constexpr int kBCopy = kTcN * 128;       // one B operand: 32 rows x 32 K
constexpr int kSmemMax = 232448;         // dynamic shared memory a block may take

// A stage: the two boxes of x, the box of g, then the B copies, tap kx's
// at (kx kPlanes + plane) kBCopy (plane 0 hi or the one-pass value, 1 lo),
// every piece on a 1024-byte boundary.  After the ring: the full, ready and
// empty mbarriers, then the splitter warps' flag words, kTcSplitters a
// stage.
template <int P>
struct Tc {
  static_assert(P == 1 || P == 3, "passes");
  static constexpr int kPlanes = P == 3 ? 2 : 1;
  static constexpr int kB = 2 * kXBox + kGLand;
  static constexpr int kStage = kB + 3 * kPlanes * kBCopy;
  static constexpr int kTx = 2 * kXBox + kXC * kTcN * 4;  // TMA's bytes
  static constexpr int kTail = 3 * 8 + 4 * kTcSplitters;  // a stage's
  static constexpr int kStages = (kSmemMax - 1024) / (kStage + kTail);
  static constexpr int kSmem = 1024 + kStages * (kStage + kTail);
  static_assert(kStages >= 2, "ring");
};

// Registers move between warpgroups: the producer gives its up, the
// consumer warpgroups take them (128 x 56 + 384 x 152 = 65536; the launch
// gives each of the 512 threads 128).
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}

__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused), eight 128-byte
// rows a group 1024 bytes apart (the stride offset), layout 1 (128B).  A
// start sits on a 1024-byte group; a k8 step of .tf32 adds 32 bytes.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64n32k8 .tf32: d (16 fp32 a thread) += A B, A from
// registers (a0 .. a3: rows gq, gq + 8 x K t, then K t + 4), B K-major
// through `desc`.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The byte offset in a box of x of channel cc (0 .. 31) of pixel p of row
// `row`: 16-byte chunk cc / 4 of the pixel's 128-byte row at chunk (cc / 4)
// ^ (p % 8), TMA's 128-byte swizzle.
__device__ __forceinline__ int x_offset(int row, int p, int cc) {
  return row * kXRow + p * 128 + (((cc >> 2) ^ (p & 7)) << 4) +
         ((cc & 3) << 2);
}

// Item it: unit it % units (the input-channel block fastest: the blocks at
// work together share K ranges, so x and g are reread from L2), split it /
// units.  Its K tiles are q0 .. q1 - 1.
struct TcItem {
  int c0, o0, split;
  long long q0, q1;
};

__device__ __forceinline__ TcItem tc_item(long long it, int units, int cblocks,
                                          long long total, int splits) {
  const int unit = (int)(it % units), split = (int)(it / units);
  return {(unit % cblocks) * kTcM, (unit / cblocks) * kTcN, split,
          split * total / splits, (split + 1) * total / splits};
}

// Whether the fp32 bits of v are inf or NaN.
__device__ __forceinline__ bool non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// A walk over K tiles q, q + 1, ...: segment (of nsx a row) fastest, then
// row, image, with one division at its start.
struct TileWalk {
  int seg, h, n;
  __device__ __forceinline__ TileWalk(long long q, int nsx, int H) {
    const long long r = q / nsx;
    seg = (int)(q - r * nsx);
    h = (int)(r % H);
    n = (int)(r / H);
  }
  __device__ __forceinline__ void next(int nsx, int H) {
    if (++seg == nsx) {
      seg = 0;
      if (++h == H) {
        h = 0;
        ++n;
      }
    }
  }
};

// A warp's A fragments of k8 step S4 of a K tile from the landed x (generic
// address `xs` of the stage, `aoff` the lane's four offsets at step 0; a
// step is 8 pixels = 1024 bytes on): hi and lo (P = 3) or the one-pass
// value, the raw value of pixel `skip` (the lane's pixel 8 S4 + 2 t + e / 2)
// zeroed first.
template <int P, int S4>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const unsigned char* xs,
                                       const int (&aoff)[4], int t, int skip) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = *reinterpret_cast<const float*>(xs + aoff[e] + S4 * 1024);
    if (8 * S4 + 2 * t + (e >> 1) == skip) v = 0.f;
    if (P == 3)
      tf32_split(v, ah[e], al[e]);
    else
      ah[e] = tf32_round(v);
  }
}

// The products of k8 step S4 for taps KX0 .. KX1 of a warpgroup's row, one
// group: x_hi g_hi into acc, x_hi g_lo + x_lo g_hi into cor (P = 3), or x g
// into acc (P = 1).  bd: the descriptor of the stage's first B copy.
template <int P, int S4, int KX0, int KX1>
__device__ __forceinline__ void tc_step(float (&acc)[3][16],
                                        float (&cor)[3][16],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bd) {
  wgmma_fence();
#pragma unroll
  for (int kx = KX0; kx <= KX1; ++kx) {
    const uint64_t bh =
        bd + (uint64_t)((kx * Tc<P>::kPlanes * kBCopy + 32 * S4) >> 4);
    wgmma_tf32(acc[kx], ah, bh);
    if constexpr (P == 3) {
      const uint64_t bl = bh + (kBCopy >> 4);
      wgmma_tf32(cor[kx], ah, bl);
      wgmma_tf32(cor[kx], al, bh);
    }
  }
  wgmma_commit();
}

// A K tile's products for taps KX0 .. KX1, one group a k8 step, the A of
// step s + 1 loaded while step s's group runs: two register sets, a set
// reloaded once the group that read it is done.  The stage's last group is
// waited for before the stage goes back to the producer (keeping it in
// flight into the next stage costs the three-pass consumers registers
// that serialize their wgmmas).
template <int P, int KX0, int KX1>
__device__ __forceinline__ void tc_tile(float (&acc)[3][16],
                                        float (&cor)[3][16],
                                        const unsigned char* xs,
                                        const int (&aoff)[4], int t, int skip,
                                        uint64_t bd) {
  uint32_t ah[2][4], al[2][4];
  fence_regs(acc);
  if constexpr (P == 3) fence_regs(cor);
  load_a<P, 0>(ah[0], al[0], xs, aoff, t, skip);
  tc_step<P, 0, KX0, KX1>(acc, cor, ah[0], al[0], bd);
  load_a<P, 1>(ah[1], al[1], xs, aoff, t, skip);
  tc_step<P, 1, KX0, KX1>(acc, cor, ah[1], al[1], bd);
  wgmma_wait<1>();  // step 0's group: set 0 is free
  load_a<P, 2>(ah[0], al[0], xs, aoff, t, skip);
  tc_step<P, 2, KX0, KX1>(acc, cor, ah[0], al[0], bd);
  wgmma_wait<1>();  // step 1's group: set 1 is free
  load_a<P, 3>(ah[1], al[1], xs, aoff, t, skip);
  tc_step<P, 3, KX0, KX1>(acc, cor, ah[1], al[1], bd);
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (P == 3) fence_regs(cor);
}

// xmap: x as [B][H][W][C], boxes {32, kTW, 3, 1}, 128-byte swizzle; gmap:
// g as [B][H][W][O], boxes {kTcN, kXC, 1, 1}, no swizzle.  out: dw where
// splits = 1, else ws.
template <int P>
__global__ void __launch_bounds__(kTcThreads, 1) conv3x3_wgrad_tc_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap gmap, float* __restrict__ out, int B,
    int H, int W, int C, int O, int splits) {
  using T = Tc<P>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_addr(base);
  const uint32_t full = ring + T::kStages * T::kStage;
  const uint32_t ready = full + 8 * T::kStages;
  const uint32_t empty = ready + 8 * T::kStages;
  uint32_t* flags = reinterpret_cast<uint32_t*>(
      base + T::kStages * T::kStage + 24 * T::kStages);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, kTcSplitters);
      mbar_init(empty + 8 * s, 4 * kTcConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int cblocks = (C + kTcM - 1) / kTcM;
  const int units = cblocks * ((O + kTcN - 1) / kTcN);
  const long long items = (long long)units * splits;
  const int nsx = (W + kTW - 1) / kTW;  // K tiles a row
  const long long total = (long long)B * H * nsx;
  const int lane = tid & 31;

  if (tid >= 128 * kTcConsumers) {
    regs_release();
    const int pw = (tid >> 5) - 4 * kTcConsumers;  // producer warp 0 .. 3
    int s = 0;
    uint32_t ph = 0;
    if (pw == 0) {
      // The loads: stage s takes K tile q, x rows h - 1 .. h + 1 (two
      // boxes of 32 channels), g row h, columns w0 - 1 .. w0 + 32.
      if (lane == 0) {
        for (long long it = blockIdx.x; it < items; it += gridDim.x) {
          const TcItem u = tc_item(it, units, cblocks, total, splits);
          TileWalk k(u.q0, nsx, H);
          for (long long q = u.q0; q < u.q1; ++q, k.next(nsx, H)) {
            const int w0 = k.seg * kTW;
            const uint32_t st = ring + s * T::kStage;
            mbar_wait(empty + 8 * s, ph ^ 1);
            mbar_expect_tx(full + 8 * s, T::kTx);
            tma_load_4d(st, &xmap, full + 8 * s, u.c0, w0, k.h - 1, k.n);
            tma_load_4d(st + kXBox, &xmap, full + 8 * s, u.c0 + 32, w0,
                        k.h - 1, k.n);
            tma_load_4d(st + 2 * kXBox, &gmap, full + 8 * s, u.o0, w0 - 1,
                        k.h, k.n);
            if (++s == T::kStages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
      return;
    }
    // Splitter warp sw: the flags of x row sw, then its share of the B
    // copies.
    const int sw = pw - 1, sid = tid - 128 * kTcConsumers - 32;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const TcItem u = tc_item(it, units, cblocks, total, splits);
      TileWalk k(u.q0, nsx, H);
      for (long long q = u.q0; q < u.q1; ++q, k.next(nsx, H)) {
        const int w0 = k.seg * kTW;
        mbar_wait(full + 8 * s, ph);
        unsigned char* st = base + s * T::kStage;
        // Bit 0: a non-finite x at column W - 1 in this tile (tap kx = 0
        // must not take it); bit 1: at column 0 (tap kx = 2).
        bool last = false, first = false;
        const int pl = W - 1 - w0;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (pl < kTW)
            last |= non_finite(*reinterpret_cast<const float*>(
                st + b * kXBox + x_offset(sw, pl, lane)));
          if (w0 == 0)
            first |= non_finite(*reinterpret_cast<const float*>(
                st + b * kXBox + x_offset(sw, 0, lane)));
        }
        const uint32_t bits = (__any_sync(~0u, last) ? 1u : 0u) |
                              (__any_sync(~0u, first) ? 2u : 0u);
        if (lane == 0) flags[kTcSplitters * s + sw] = bits;
        // B: task i is output channel n = i % 32 at k8 step s4 = i / 32.
        // The step's ten box columns 8 s4 .. 8 s4 + 9 of g, split once
        // (or rounded), give its six chunks: tap kx's chunk hf (K values 4
        // hf .. 4 hf + 3, pixels 2 e + hf of the step) takes columns 8 s4
        // + 2 e + hf - kx + 2, e = 0 .. 3.
        const float* gl = reinterpret_cast<const float*>(st + 2 * kXBox);
        for (int i = sid; i < 4 * kTcN; i += 32 * kTcSplitters) {
          const int n = i % kTcN, s4 = i / kTcN;
          uint32_t hi[10], lo[10];
#pragma unroll
          for (int j = 0; j < 10; ++j) {
            const float v = gl[(8 * s4 + j) * kTcN + n];
            if (P == 3)
              tf32_split(v, hi[j], lo[j]);
            else
              hi[j] = tf32_round(v);
          }
          // g non-finite at the image's first column (box column 1), which
          // meets the padding column of x at tap kx = 0, or at its last
          // (box column pl + 1; tap kx = 2): that tap's first K value of
          // channel n becomes NaN, so its sums are NaN in every row, as the
          // padding's 0 inf makes them.
          const bool nan0 = s4 == 0 && w0 == 0 && non_finite(gl[kTcN + n]);
          const bool nan2 = s4 == 0 && pl < kTW &&
                            non_finite(gl[(pl < kTW ? pl + 1 : 0) * kTcN + n]);
          unsigned char* row = st + T::kB + n * 128;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int j0 = hf - kx + 2;
              unsigned char* dst = row + kx * T::kPlanes * kBCopy +
                                   (((2 * s4 + hf) ^ (n & 7)) << 4);
              const bool nan = hf == 0 && (kx == 0 ? nan0 : kx == 2 && nan2);
              *reinterpret_cast<uint4*>(dst) =
                  make_uint4(nan ? 0x7fffe000u : hi[j0], hi[j0 + 2],
                             hi[j0 + 4], hi[j0 + 6]);
              if (P == 3)
                *reinterpret_cast<uint4*>(dst + kBCopy) =
                    make_uint4(lo[j0], lo[j0 + 2], lo[j0 + 4], lo[j0 + 6]);
            }
        }
        fence_async_shared();  // the B copies, before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + 8 * s);
        if (++s == T::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup ky, taps (ky, 0 .. 2).
  regs_claim();
  const int ky = tid >> 7, w = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  int aoff[4];  // a0 .. a3 at k8 step 0: channels 16 w + gq (+ 8), pixels
                // 2 t (a0, a1) and 2 t + 1 (a2, a3)
#pragma unroll
  for (int e = 0; e < 4; ++e)
    aoff[e] = (w >> 1) * kXBox +
              x_offset(ky, 2 * t + (e >> 1), 16 * (w & 1) + gq + 8 * (e & 1));
  float acc[3][16], cor[3][16];
  int s = 0;
  uint32_t ph = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const TcItem u = tc_item(it, units, cblocks, total, splits);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[kx][e] = cor[kx][e] = 0.f;
    TileWalk k(u.q0, nsx, H);
    for (long long q = u.q0; q < u.q1; ++q, k.next(nsx, H)) {
      const int w0 = k.seg * kTW;
      mbar_wait(full + 8 * s, ph);
      mbar_wait(ready + 8 * s, ph);
      const unsigned char* xs = base + s * T::kStage;
      const uint64_t bd = desc_k128(ring + s * T::kStage + T::kB);
      const uint32_t* fl = flags + kTcSplitters * s;
      const uint32_t f = fl[0] | fl[1] | fl[2];
      if (f == 0) {
        tc_tile<P, 0, 2>(acc, cor, xs, aoff, t, -1, bd);
      } else {
        // A non-finite x at an edge column: the taps one after another,
        // each with the column it takes no product at zeroed in A.
        tc_tile<P, 0, 0>(acc, cor, xs, aoff, t, f & 1 ? W - 1 - w0 : -1, bd);
        tc_tile<P, 1, 1>(acc, cor, xs, aoff, t, -1, bd);
        tc_tile<P, 2, 2>(acc, cor, xs, aoff, t, f & 2 ? 0 : -1, bd);
      }
      if constexpr (P == 1) {
        // One pass: the tile's chain of wgmmas goes into the register sum
        // cor with fp32 adds, so no chain runs longer than a K tile.
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            cor[kx][e] += acc[kx][e];
            acc[kx][e] = 0.f;
          }
      }
      // The x reads above, before the next TMA write into the stage.
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == T::kStages) {
        s = 0;
        ph ^= 1;
      }
    }

    // The epilogue: accumulator pairs (columns 8 j + 2 t, + 1) of rows
    // (input channels) 16 w + gq and + 8 of each tap, acc + cor (at one
    // pass acc is 0 here), straight to out.
    float* dst = out + (splits > 1 ? (long long)u.split * 9 * C * O : 0);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = u.c0 + 16 * w + gq + 8 * h;
        float* row = dst + ((long long)(3 * ky + kx) * C + c) * O;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 8 * j + 2 * t, o = u.o0 + n;
          const float v0 = acc[kx][4 * j + 2 * h] + cor[kx][4 * j + 2 * h];
          const float v1 =
              acc[kx][4 * j + 2 * h + 1] + cor[kx][4 * j + 2 * h + 1];
          if (c < C && o < O)
            *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
        }
      }
  }
}

// A tiled 4-D tensor map over an fp32 NHWC tensor [B][H][W][ch] with boxes
// {box0, box1, box2, 1} and zero fill out of bounds.  The map holds the
// data's pointer, so it is encoded at every call.
cudaError_t nhwc_map(CUtensorMap* map, const float* p, int B, int H, int W,
                     int ch, int box0, int box1, int box2,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {ch * 4ull, ch * 4ull * W, ch * 4ull * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1,
                             (cuuint32_t)box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether a call takes the wgmma route (kernels/conv3x3.py: wgrad_route).
bool tc_route(const void* x, const void* g, int C, int O) {
  return C >= 8 && O >= 8 && C % 4 == 0 && O % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

// `out` is dw (splits = 1) or ws; one persistent block an SM.
template <int P>
cudaError_t launch_tc(const float* x, const float* g, float* out, int B, int H,
                      int W, int C, int O, int splits, cudaStream_t st) {
  using T = Tc<P>;
  CUtensorMap xmap, gmap;
  cudaError_t e = nhwc_map(&xmap, x, B, H, W, C, 32, kTW, 3,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = nhwc_map(&gmap, g, B, H, W, O, kTcN, kXC, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(conv3x3_wgrad_tc_kernel<P>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::kSmem);
  if (e != cudaSuccess) return e;
  const long long units = (long long)((C + kTcM - 1) / kTcM) *
                          ((O + kTcN - 1) / kTcN);
  const int grid = (int)std::min<long long>(units * splits, sms);
  conv3x3_wgrad_tc_kernel<P><<<grid, kTcThreads, T::kSmem, st>>>(
      xmap, gmap, out, B, H, W, C, O, splits);
  return cudaGetLastError();
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

}  // namespace

// x [B,H,W,C] and g [B,H,W,O] fp32, dw [3,3,C,O] fp32 (written whole); ws
// a scratch of splits 9 C O floats where splits > 1, else unused;
// `splits` K splits (kernels/conv3x3.py: wgrad_plan, for the route
// tc_route picks), 1 <= splits <= B H ceil(W / 32); `passes` 3
// (fp32-accurate) or 1.
extern "C" int rr_conv3x3_wgrad(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int C, int O,
                                int splits, int passes, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || splits <= 0 ||
      (splits > 1 && ws == nullptr) ||
      (long long)splits > (long long)B * H * ((W + kTW - 1) / kTW) ||
      splits > 65535 || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* d = static_cast<float*>(dw);
  float* out = splits > 1 ? static_cast<float*>(ws) : d;
  cudaError_t e;
  if (tc_route(x, g, C, O))
    e = passes == 3 ? launch_tc<3>(xf, gf, out, B, H, W, C, O, splits, st)
                    : launch_tc<1>(xf, gf, out, B, H, W, C, O, splits, st);
  else
    e = passes == 3 ? by_shape<3>(xf, gf, out, B, H, W, C, O, splits, st)
                    : by_shape<1>(xf, gf, out, B, H, W, C, O, splits, st);
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = 9LL * C * O;
  conv3x3_wgrad_reduce_kernel<<<(int)std::min<long long>((n + 255) / 256,
                                                          1024),
                                256, 0, st>>>(out, d, n, splits);
  return cudaGetLastError();
}
