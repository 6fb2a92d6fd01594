// The fp32 SAME 3x3 conv for O <= 32 output channels (kernels/conv3x3.py
// design "tf32_rows"), at one TF32 pass (x and w rounded to nearest TF32:
// the 'default' precision) or three (x_hi w_hi + x_hi w_lo + x_lo w_hi,
// fp32-accurate: 'highest' and 'high'):
//
//   y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] w[dy, dx, c, o]
//
// It replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_implicit_gemm and
// :conv3x3_pairlane for fp32 calls with O <= 32 (the decoder filter
// blocks' `down` conv 512 -> 32, the 64 -> 3 `out` conv, and the input
// gradients of convs with C <= 32), in place of the split-TF32 kernel's
// instances at N = 8, 16 and 32 (csrc/conv3x3.cu conv3x3_tf32x3_kernel),
// which stay for O > 32 at three passes.  C entry: rr_conv3x3_rows.
//
// What bound the split-TF32 walk at these N: pixels are wgmma's A, read
// from shared memory by every m64nNk8: 2 KB of A for N / 2 clocks of
// products, 2.0 to 9.1 times what shared memory gives (kernels/conv3x3.py:
// tf32x3_stage_reckoning at N = 32 and 8, one and three passes), and each
// K slice staged three times, once a dx.  Putting the weights in A (the
// one-pass design, O > 32) pads M = 64 to O: at O = 3, 61 of 64 rows.
//
// The design: pixels stay wgmma's A, but from registers, and each value
// loaded from shared memory feeds every product it is in.
// * A tile is two warpgroup columns, one above the other, each cw columns
//   (16, 32 or 64) x hr = 64 R / cw rows (8 or more); R, the warpgroup's
//   accumulator rows, keeps its fp32 sums (R N / 2 a thread, twice that at
//   three passes) at 64 registers or fewer: 8, 8, 4 at N = 8, 16, 32 at
//   one pass, 8, 4, 2 at three.  Accumulator block j
//   (j = 0 .. R - 1, one m64 wgmma tile) holds the column's rows j, j + R,
//   j + 2 R, ... (64 / cw row segments of cw pixels): block j shifted down
//   by one row is block j + 1.
// * A stage is one K slice (KS = 16 fp32 channels, 8 where C <= 8): one
//   TMA box of x {KS, cw + 2, 2 hr + 2, 1} at (s KS, x0 - 1, y0 - 1, b),
//   the halo in both directions zero-filled by the hardware (the SAME
//   padding), and one box {KS, N, 9 (x 2)} of the weights' K-major planes.
//   The dx shift is an offset into the box (the loads compute their own
//   swizzled addresses), so each value is staged once a slice, not once a
//   dx.
// * For each phase t = 0 .. R + 1 and dx, each warp loads its 16 x KS
//   fragment (box rows t + i R of its warpgroup, shifted by dx) with one
//   16-byte load a row (8 at KS = 8; the K order within a k8 step is
//   permuted so that a lane's four channels are its A values of both
//   steps, and the weights' planes are written in the same order), rounds
//   it (one pass) or splits it into hi and lo (three passes) in registers,
//   and issues it against taps (dy, dx), dy = 0, 1, 2, into blocks t - dy
//   (those in 0 .. R - 1): one load serves three taps.  At one pass a
//   phase's three dx are one group of wgmmas (at three passes a fragment
//   is), the tap rows fastest, so that consecutive wgmmas write other
//   accumulators.  Register A, B
//   (the taps' weights) from shared memory: a m64nNk8 reads 32 N bytes of
//   B for N / 2 clocks of products, and A adds 2 KB a fragment for up to
//   three (nine at three passes) of them (kernels/conv3x3.py:
//   tf32_rows_stage_reckoning).  No box is written back: no lo box, no
//   rounding pass, no consumer barrier.
// * The loads run a group ahead of the products: a group's rows are
//   loaded into registers of their own while the group before it is
//   issued, and rounded or split into A once that group is done
//   (wgmma.wait_group 0: the other warpgroup's products fill the tensor
//   cores meanwhile).  This kernel's first form loaded each fragment
//   only after that wait, and kept two A sets at three passes, whose
//   wgmmas ptxas then serialized: [16,80,80,512] -> 32 at three passes
//   took 0.569 ms against 0.352 with the loads ahead and one set
//   (scripts/probe_rows_conv.py; PERF.md section 6).  A stage goes back
//   to the producer once its last group is done.
// * Three passes: x_hi w_hi into acc, x_hi w_lo + x_lo w_hi into cor, added
//   in the epilogue (wgmma truncates its fp32 sums: the corrections'
//   chain truncates at 2^-11 of the size); one pass: x w into acc.  x_hi is
//   x truncated to TF32, x_lo = tf32_lo(x), the one-pass x tf32_round_x(x),
//   the weights as the split-TF32 kernel splits or rounds them
//   (csrc/hopper.cuh): inf and NaN as there.  Padded K columns (past C) are
//   zeros on both sides; padded N columns (past O) are never stored.
// * Split K (csrc/conv3x3.cu's header, "Split K"): where the tiles are
//   fewer than the SMs, units (tile, split), split s summing its run of
//   slices, partials summed in split order by the last to finish (the
//   same bits whichever block that is).
// * The epilogue writes each thread's accumulator pairs straight to y
//   (8-byte vectors where O is even), while the producer loads the next
//   unit's stages.
// * What bounds it: at N = 32 the products (one pass, 64 x 32 x 8 a
//   m64n32k8 in 16 clocks), with shared memory at about 1.1 to 1.2 times
//   their clocks; at N = 8 (O = 3) the bytes of x from device memory
//   (the [16,640,640,64] -> 3 `out` conv reads 1.68 GB: 0.50 ms at 3.35
//   TB/s).
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <utility>

namespace {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

// N output channels a tile (O rounded up to 8, 16, 32), K slices of KS fp32
// channels (kS bytes a pixel of a slice: the swizzle span), P passes.
template <int N, int KS, int P>
struct Rows {
  static_assert(N == 8 || N == 16 || N == 32, "width");
  static_assert(KS == 8 || KS == 16, "K slice");
  static_assert(P == 1 || P == 3, "passes");
  // Accumulator rows a warpgroup: R N / 2 fp32 sums a thread, 64 at most
  // (acc, and at three passes cor beside it), R at most 8.  With 128 (R =
  // 4 at N = 32, three passes), this kernel's first form spilled and had
  // its wgmmas serialized by ptxas.
  static constexpr int kSums = (P == 1 ? 128 : 64) / N;
  static constexpr int kR = kSums < 8 ? kSums : 8;
  static constexpr int kS = KS * 4;
  static constexpr int kPlanes = P == 3 ? 2 : 1;  // w's hi (and lo)
  static constexpr int kTap = N * KS * 4;         // a tap's {KS, N} weights
  static constexpr int kWTx = 9 * kPlanes * kTap;  // TMA's bytes of them
  static constexpr int kWBytes = (kWTx + 1023) / 1024 * 1024;
  static constexpr int kFrags = 3 * (kR + 2);     // (phase, dx) a stage
  // Fragments a group of wgmmas: the three dx of a phase at one pass and
  // at three with N = 32 (R = 2); one at three passes with N = 8 and 16
  // (18 wgmmas already; with three, ptxas spilled in the N = 8 instance:
  // scripts/probe_rows_conv.py --compile-only --variants three_dx).
  static constexpr int kDx = P == 1 || N == 32 ? 3 : 1;
  static constexpr int kGroups = kFrags / kDx;
};

// The weights' channel at position p of a K slice of `ks` in the planes'
// order: k8 step j = p / 8 puts, at its K index k, channel (ks / 4) (k % 4)
// + 2 j + k / 4, so that the ks / 4 channels a lane loads from a pixel
// (16 or 8 bytes) are its A values at K indices t and t + 4 of every step.
__device__ __forceinline__ int rows_channel(int p, int ks) {
  const int j = p >> 3, k = p & 7;
  return (ks >> 2) * (k & 3) + 2 * j + (k >> 2);
}

// ws [planes][9][O][Cs] (hi, lo at passes = 3; the value rounded to TF32 at
// one pass; tap, output channel, position in the slices' order of
// rows_channel; zero for channels past C) from the HWIO weights w
// [9][C][O], Cs = C rounded up to ks.  Also zeroes the `ncnt` counters of a
// split call (split_sum) before the conv kernel, next on the stream,
// counts on them.
__global__ void conv3x3_rows_split_kernel(const float* __restrict__ w,
                                          float* __restrict__ ws, int C,
                                          int Cs, int O, int ks, int passes,
                                          int* __restrict__ cnt,
                                          long long ncnt) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < ncnt; i += (long long)gridDim.x * blockDim.x)
    cnt[i] = 0;
  const long long n = 9LL * Cs * O;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(i % O);
    const long long q = i / O;
    const int p = (int)(q % Cs), tap = (int)(q / Cs);
    const int c = p - p % ks + rows_channel(p % ks, ks);
    const long long d = ((long long)tap * O + o) * Cs + p;
    const float v = c < C ? w[((long long)tap * C + c) * O + o] : 0.f;
    if (passes == 1) {
      ws[d] = c < C ? tf32_round_w(v) : 0.f;
      continue;
    }
    float hi = 0.f, lo = 0.f;
    if (c < C) tf32_split_w(v, hi, lo);
    ws[d] = hi;
    ws[n + d] = lo;
  }
}

// wgmma.mma_async m64nNk8 .tf32: d (N / 2 fp32 a thread) += A B, A from
// registers (a0 .. a3: rows gq, gq + 8 at K index t, then at t + 4), B
// K-major through desc + Off (Off in 16-byte units, added inside the asm so
// that the compiler keeps one descriptor live, not one a tap).
#define RR_TF32_RA(NS, ACC, D, IA, ID, IO, IS)                              \
  asm volatile("{\n.reg .pred p;\n.reg .b64 dd;\n"                         \
               "setp.ne.b32 p, %" IS ", 0;\nadd.s64 dd, %" ID ", %" IO ";\n" \
               "wgmma.mma_async.sync.aligned.m64n" NS "k8.f32.tf32.tf32 "  \
               "{" ACC "}, {" IA "}, dd, p, 1, 1;\n}\n"                     \
               : D                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),   \
                 "n"(Off), "r"(1))

#define RR_ACC4 "%0, %1, %2, %3"
#define RR_ACC8 RR_ACC4 ", %4, %5, %6, %7"
#define RR_ACC16 RR_ACC8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define RR_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RR_D8(i) RR_D4(i), RR_D4(i + 4)
#define RR_D16(i) RR_D8(i), RR_D8(i + 8)

template <int N, int Off>
__device__ __forceinline__ void wgmma_ra(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (N == 8)
    RR_TF32_RA("8", RR_ACC4, RR_D4(0), "%4, %5, %6, %7", "8", "9", "10");
  else if constexpr (N == 16)
    RR_TF32_RA("16", RR_ACC8, RR_D8(0), "%8, %9, %10, %11", "12", "13", "14");
  else
    RR_TF32_RA("32", RR_ACC16, RR_D16(0), "%16, %17, %18, %19", "20", "21",
               "22");
}

// An input value's one-pass TF32 value (bits v), as tf32_round_x computes
// it (csrc/hopper.cuh), in selects: the fragments' many independent values
// each take the same few instructions.  Written as tf32_round_x's nested
// choice, the compiler branched around each value's rounding, and one pass
// took 1.85 times as long as with x unrounded (scripts/probe_rows_conv.py
// no_round, PERF.md section 6).
__device__ __forceinline__ uint32_t rows_round_x(uint32_t v) {
  const uint32_t a = v & 0x7fffffffu;
  const uint32_t r = a >= 0x7f7ff000u ? v & 0xffffe000u : tf32_rna(v);
  return a > 0x7f800000u ? 0x7fffe000u : r;
}

// An input value's lo beside hi = v truncated (tf32_lo, csrc/hopper.cuh),
// in selects.
__device__ __forceinline__ uint32_t rows_lo(uint32_t v) {
  const uint32_t hi = v & 0xffffe000u;
  const uint32_t r =
      __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) & 0xffffe000u;
  return hi == v ? 0u : r;
}

// Shared-memory loads of a lane's channels of one pixel: 16 bytes (KS = 16)
// or 8 (KS = 8).
__device__ __forceinline__ void lds128(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void lds64(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The byte offset of this lane's channels of box pixel q: 16-byte chunk c
// of the pixel's kS-byte row lies at chunk c ^ ((q kS >> 7) % (kS / 16)),
// TMA's 64- or 32-byte swizzle; at KS = 16 the lane's chunk is t, at KS =
// 8 half t % 2 of chunk t / 2.
template <int KS>
__device__ __forceinline__ uint32_t rows_offset(int q, int t) {
  constexpr int kS = KS * 4;
  const int sw = (q * kS >> 7) & (kS / 16 - 1);
  if constexpr (KS == 16) return q * kS + ((t ^ sw) << 4);
  else return q * kS + (((t >> 1) ^ sw) << 4) + ((t & 1) << 3);
}

// Unit i of the walk (split fastest): tile t, split sp and its slices
// [k0, k1) (SplitUnit's run, csrc/hopper.cuh, at one stage a slice), and
// the tile's first column, first row and image (strip fastest, then band,
// image).  In 32-bit arithmetic (a launch has fewer than 2^31 units): with
// the 64-bit divisions, the producer warpgroup's 40 registers spilled.
template <bool kSplit>
struct RowsUnit {
  int t, sp, k0, k1, x0, y0, b;
  __device__ __forceinline__ RowsUnit(int i, int splits, int slices,
                                      int strips, int bands, int cw,
                                      int rows) {
    if constexpr (kSplit) {
      t = i / splits;
      sp = i - t * splits;
      k0 = sp * slices / splits;
      k1 = (sp + 1) * slices / splits;
    } else {
      t = i;
      sp = 0;
      k0 = 0;
      k1 = slices;
    }
    const int r = t / strips;
    x0 = (t - r * strips) * cw;
    y0 = (r % bands) * rows;
    b = r / bands;
  }
};

// Registers move between warpgroups: the producer keeps 56 (with 40, as
// the other kernels give it, its unit walk spilled at three passes), the
// consumers take 224 (56 x 128 + 224 x 256 = 64512 of the SM's 65536).
__device__ __forceinline__ void rows_regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}

__device__ __forceinline__ void rows_regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

// What a consumer thread keeps across the stages of its units.
struct RowsLane {
  int q0;          // box pixel of its first fragment row at phase 0, dx 0
  int rs;          // box pixels a row (cw + 2)
  int t;           // lane % 4: its K indices t, t + 4
};

// The products of fragment F (phase F / 3, dx F % 3) of a stage at k8
// step K for one tap row dy: block j = phase - dy, if there is one, x tap
// (dy, dx), from A registers a (hi) and l (lo).  B offsets: plane p, tap,
// step K at ((p 9 + tap) kTap + 32 K) bytes from the stage's weights.
template <int N, int KS, int P, int F, int K, int DY>
__device__ __forceinline__ void rows_tap(
    float (&acc)[Rows<N, KS, P>::kR][N / 2],
    float (&cor)[Rows<N, KS, P>::kR][N / 2], const uint32_t (&a)[4],
    const uint32_t (&l)[4], uint64_t db) {
  using Q = Rows<N, KS, P>;
  constexpr int j = F / 3 - DY, tap = 3 * DY + F % 3;
  if constexpr (j >= 0 && j < Q::kR) {
    wgmma_ra<N, tap * Q::kTap / 16 + 2 * K>(acc[j], a, db);
    if constexpr (P == 3) {
      wgmma_ra<N, (9 + tap) * Q::kTap / 16 + 2 * K>(cor[j], a, db);
      wgmma_ra<N, tap * Q::kTap / 16 + 2 * K>(cor[j], l, db);
    }
  }
}

// Loads this lane's two rows of fragment G (phase G / 3, dx G % 3) of a
// stage from the box at `box` into u (rows gq and gq + 8: channels (KS /
// 4) t ..).  The empty asm pins the address's computation here: hoisted to
// the stage's top, a stage's every address would stay live in registers.
template <int KS, int G>
__device__ __forceinline__ void rows_load(uint32_t (&u)[2][4], uint32_t box,
                                          const RowsLane& ln) {
  int q = ln.q0 + (G / 3) * ln.rs + G % 3;
  asm volatile("" : "+r"(q));
  if constexpr (KS == 16) {
    lds128(u[0], box + rows_offset<KS>(q, ln.t));
    lds128(u[1], box + rows_offset<KS>(q + 8, ln.t));
  } else {
    lds64(u[0], box + rows_offset<KS>(q, ln.t));
    lds64(u[1], box + rows_offset<KS>(q + 8, ln.t));
  }
}

// The fragments of group G (kDx of them from fragment G kDx) into raw.
template <int N, int KS, int P, int G, int... I>
__device__ __forceinline__ void rows_load_group(
    uint32_t (&raw)[Rows<N, KS, P>::kDx][2][4], uint32_t box,
    const RowsLane& ln, std::integer_sequence<int, I...>) {
  (rows_load<KS, G * Rows<N, KS, P>::kDx + I>(raw[I], box, ln), ...);
}

// Group G's products at k8 step K: each of its fragments' three tap rows,
// the tap rows fastest (blocks t, t - 1, t - 2 in turn, so that no wgmma
// waits on the one before it for its accumulator).
template <int N, int KS, int P, int G, int K, int... I>
__device__ __forceinline__ void rows_step(
    float (&acc)[Rows<N, KS, P>::kR][N / 2],
    float (&cor)[Rows<N, KS, P>::kR][N / 2],
    const uint32_t (&ah)[Rows<N, KS, P>::kDx][KS / 8][4],
    const uint32_t (&al)[Rows<N, KS, P>::kDx][KS / 8][4], uint64_t db,
    std::integer_sequence<int, I...>) {
  constexpr int F0 = G * Rows<N, KS, P>::kDx;
  ((rows_tap<N, KS, P, F0 + I, K, 0>(acc, cor, ah[I][K], al[I][K], db),
    rows_tap<N, KS, P, F0 + I, K, 1>(acc, cor, ah[I][K], al[I][K], db),
    rows_tap<N, KS, P, F0 + I, K, 2>(acc, cor, ah[I][K], al[I][K], db)),
   ...);
}

// Group G of a stage: kDx fragments (the three dx of a phase, or one) whose
// rows were loaded a group ago into raw.  Wait until every group of this
// warpgroup is done, round or split the rows into A, load the next
// group's rows into raw, and issue the group's products as one group of
// wgmmas.
template <int N, int KS, int P, int G>
__device__ __forceinline__ void rows_group(
    float (&acc)[Rows<N, KS, P>::kR][N / 2],
    float (&cor)[Rows<N, KS, P>::kR][N / 2],
    uint32_t (&ah)[Rows<N, KS, P>::kDx][KS / 8][4],
    uint32_t (&al)[Rows<N, KS, P>::kDx][KS / 8][4],
    uint32_t (&raw)[Rows<N, KS, P>::kDx][2][4], uint32_t box, uint64_t db,
    RowsLane& ln) {
  using Q = Rows<N, KS, P>;
  constexpr auto frags = std::make_integer_sequence<int, Q::kDx>{};
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < Q::kDx; ++i)
#pragma unroll
    for (int k = 0; k < KS / 8; ++k) {
      const uint32_t v[4] = {raw[i][0][2 * k], raw[i][1][2 * k],
                             raw[i][0][2 * k + 1], raw[i][1][2 * k + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (P == 1) {
          ah[i][k][e] = rows_round_x(v[e]);
        } else {
          ah[i][k][e] = v[e] & 0xffffe000u;
          al[i][k][e] = rows_lo(v[e]);
        }
      }
    }
  if constexpr (G + 1 < Q::kGroups)
    rows_load_group<N, KS, P, G + 1>(raw, box, ln, frags);
  fence_regs(acc);
  if constexpr (P == 3) fence_regs(cor);
  wgmma_fence();
  rows_step<N, KS, P, G, 0>(acc, cor, ah, al, db, frags);
  if constexpr (KS == 16) rows_step<N, KS, P, G, 1>(acc, cor, ah, al, db, frags);
  wgmma_commit();
}

template <int N, int KS, int P, int... G>
__device__ __forceinline__ void rows_stage(
    float (&acc)[Rows<N, KS, P>::kR][N / 2],
    float (&cor)[Rows<N, KS, P>::kR][N / 2],
    uint32_t (&ah)[Rows<N, KS, P>::kDx][KS / 8][4],
    uint32_t (&al)[Rows<N, KS, P>::kDx][KS / 8][4],
    uint32_t (&raw)[Rows<N, KS, P>::kDx][2][4], uint32_t box, uint64_t db,
    RowsLane& ln, std::integer_sequence<int, G...>) {
  rows_load_group<N, KS, P, 0>(raw, box, ln,
                               std::make_integer_sequence<int,
                                                          Rows<N, KS, P>::kDx>{});
  (rows_group<N, KS, P, G>(acc, cor, ah, al, raw, box, db, ln), ...);
}

// xmap: x as [B][H][W][Cp] fp32, boxes {KS, cw + 2, 8, 1}, and xtail, the
// same with boxes {KS, cw + 2, 2, 1}: a stage's box of x, 2 hr + 2 rows (2
// hr a multiple of 8), lands as 2 hr / 8 boxes of 8 rows and one of 2, one
// after another (each on a whole swizzle pattern: 8 (cw + 2) kS bytes);
// wmap: ws as [9 kPlanes][O][Cs], boxes {KS, N, 9 kPlanes}; all with the
// kS-byte swizzle.  `lc` = log2(cw); `stages` stages of `a_slot` + kWBytes bytes.
// Tile t: strip t % strips (cw columns), band (t / strips) % bands (2 hr
// rows), image; `splits` K splits a tile in the kSplit instances (units
// (tile, split), split fastest), whole tiles in the others.
template <int N, int KS, int P, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_rows_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap xtail,
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
    float* __restrict__ y, float* __restrict__ part, int* __restrict__ cnt,
    int B, int H, int W, int Cp, int O, int lc, int stages, int a_slot,
    int splits) {
  using Q = Rows<N, KS, P>;
  constexpr int R = Q::kR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = a_slot + Q::kWBytes;
  const uint32_t ring = smem_addr(base);
  float* bias_s = reinterpret_cast<float*>(base + (size_t)stages * stage_bytes);
  const uint32_t full = smem_addr(bias_s + N);
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    fence_barrier_init();
  }
  for (int i = tid; i < N; i += kThreads)
    bias_s[i] = bias != nullptr && i < O ? bias[i] : 0.f;
  __syncthreads();

  const int cw = 1 << lc, hr = (64 * R) >> lc, rows = 2 * hr;
  const int strips = (W + cw - 1) >> lc;
  const int bands = (H + rows - 1) / rows;
  if (!kSplit) splits = 1;
  const int units = strips * bands * B * splits;
  const int slices = (Cp + KS - 1) / KS;  // one stage a slice
  const int box_bytes = (rows + 2) * (cw + 2) * Q::kS;

  if (tid >= kConsumers) {
    // The producer warpgroup: one thread streams every unit's stages.
    rows_regs_release();
    if (tid == kConsumers) {
      const uint32_t tx = box_bytes + Q::kWTx;
      int s = 0;
      uint32_t ph = 0;
      for (int i = blockIdx.x; i < units; i += gridDim.x) {
        const RowsUnit<kSplit> q(i, splits, slices, strips, bands, cw, rows);
        const int x0 = q.x0, y0 = q.y0, b = q.b;
        for (int k = q.k0; k < q.k1; ++k) {
          const uint32_t a = ring + s * stage_bytes;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, tx);
          // The box in pieces: a TMA copy moves a box's rows at a pace of
          // its own, so several in flight fill the SM's share of the
          // memory's rate where one large box did not.
          for (int r8 = 0; r8 < rows; r8 += 8)
            tma_load_4d(a + r8 * (cw + 2) * Q::kS, &xmap, full + 8 * s,
                        k * KS, x0 - 1, y0 - 1 + r8, b);
          tma_load_4d(a + rows * (cw + 2) * Q::kS, &xtail, full + 8 * s,
                      k * KS, x0 - 1, y0 - 1 + rows, b);
          tma_load_3d(a + a_slot, &wmap, full + 8 * s, k * KS, 0, 0);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes tile rows hr wg .. + hr - 1.  Its
  // warp w, lane (gq, t) holds rows rho = 16 w + gq and rho + 8 of each
  // accumulator block: segment rho / cw, columns rho % cw and + 8 (cw >=
  // 16: both in one segment).
  rows_regs_claim();
  const int wg = tid >> 7, lane = tid & 31;
  const int rho = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int seg = rho >> lc, col = rho & (cw - 1);
  RowsLane ln;
  ln.rs = cw + 2;
  ln.q0 = (wg * hr + seg * R) * ln.rs + col;
  ln.t = lane & 3;
  float acc[R][N / 2], cor[R][N / 2];  // cor: three passes only
  uint32_t ah[Q::kDx][KS / 8][4], al[Q::kDx][KS / 8][4];
  uint32_t raw[Q::kDx][2][4];
  int s = 0;
  uint32_t ph = 0;
  for (int i = blockIdx.x; i < units; i += gridDim.x) {
    const RowsUnit<kSplit> q(i, splits, slices, strips, bands, cw, rows);
    const int x0 = q.x0, y0 = q.y0, b = q.b;
    // The sums start from the bias (split 0; the other splits from 0).
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int o = jj * 8 + (lane & 3) * 2;
      const float b0 = q.sp ? 0.f : bias_s[o];
      const float b1 = q.sp ? 0.f : bias_s[o + 1];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[j][4 * jj] = acc[j][4 * jj + 2] = b0;
        acc[j][4 * jj + 1] = acc[j][4 * jj + 3] = b1;
#pragma unroll
        for (int e = 0; e < 4; ++e) cor[j][4 * jj + e] = 0.f;
      }
    }
    fence_regs(acc);
    if constexpr (P == 3) fence_regs(cor);
#pragma unroll 1
    for (int k = q.k0; k < q.k1; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * stage_bytes;
      rows_stage<N, KS, P>(acc, cor, ah, al, raw, a,
                           wgmma_desc<Q::kS>(a + a_slot), ln,
                           std::make_integer_sequence<int, Q::kGroups>{});
      // The stage's last group done, it goes back to the producer (the
      // fence orders its generic loads before the next TMA write into
      // it).  Kept in flight across the loop's back edge instead, that
      // group made ptxas serialize every wgmma of the split instances.
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (P == 3) fence_regs(cor);
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    // The sums leave the accumulators for registers of their own: written
    // in place (acc += cor, the split's sum), the three-pass split
    // instance at N = 32 had every wgmma serialized by ptxas.
    float out[R][N / 2];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int e = 0; e < N / 2; ++e)
        out[j][e] = P == 3 ? acc[j][e] + cor[j][e] : acc[j][e];
    if constexpr (kSplit) {
      if (!split_sum(out, part, cnt, q.t, wg, q.sp, splits, tid & 127))
        continue;  // another unit of the tile finishes it
    }

    // The epilogue: block j's rows rho, rho + 8 are tile row hr wg + j +
    // R seg, columns col, col + 8; accumulator pairs (channels 8 jj + 2 t,
    // + 1) straight to y.  The empty asm keeps its addresses from being
    // computed ahead of the K loop (live across it, they spilled).
    int ty = y0 + wg * hr + seg * R, tx = x0 + col;
    asm volatile("" : "+r"(ty), "+r"(tx));
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int yy = ty + j, xx = tx + 8 * h;
        if (yy >= H || xx >= W) continue;
        float* dst = y + (((long long)b * H + yy) * W + xx) * O;
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int o = jj * 8 + (lane & 3) * 2;
          const float v0 = out[j][4 * jj + 2 * h];
          const float v1 = out[j][4 * jj + 2 * h + 1];
          if (O % 2 == 0) {
            if (o < O) *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
          } else {
            if (o < O) dst[o] = v0;
            if (o + 1 < O) dst[o + 1] = v1;
          }
        }
      }
  }
}

// The kernel at N, KS, P: `grid` persistent blocks over units of tiles of
// cw = 1 << lc columns x 2 hr rows (hr = 64 R / cw) and `splits` K splits a
// tile.  x is [B,H,W,Cp] (Cp = C rounded up to 4: the wrapper's
// zero-padded copy where C % 4 != 0), w the caller's [3,3,C,O]; ws, the
// wrapper's scratch of 9 kPlanes O Cs floats (Cs = C rounded up to KS),
// takes the weights' planes first, then, where splits > 1, the split
// workspace (split_space).  The ring takes as many stages as fit beside
// the bias, at most kMaxStages.
template <int N, int KS, int P>
cudaError_t launch_rows(const void* x, const void* w, const void* b, void* y,
                        void* ws, int B, int H, int W, int C, int O, int lc,
                        int grid, int splits, cudaStream_t st) {
  using Q = Rows<N, KS, P>;
  const int cw = 1 << lc, hr = (64 * Q::kR) >> lc, rows = 2 * hr;
  if (rows % 8) return cudaErrorInvalidValue;  // the box's 8-row pieces
  const int cp = (C + 3) / 4 * 4, cs = (C + KS - 1) / KS * KS;
  const long long nw = 9LL * cs * O;
  const long long tiles = (long long)((W + cw - 1) / cw)
                          * ((H + rows - 1) / rows) * B;
  if (tiles * splits >= (1LL << 31)) return cudaErrorInvalidValue;
  SplitSpace sp;
  cudaError_t e = split_space(ws, nw * Q::kPlanes, tiles, splits, cs / KS,
                              128LL * Q::kR * N, &sp);
  if (e != cudaSuccess) return e;
  conv3x3_rows_split_kernel<<<(int)std::min<long long>((nw + 255) / 256,
                                                        1024),
                              256, 0, st>>>(static_cast<const float*>(w),
                                            static_cast<float*>(ws), C, cs, O,
                                            KS, P, sp.cnt, sp.ncnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap xmap, xtail, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)cp, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {cp * 4ull, cp * 4ull * W, cp * 4ull * W * H};
  cuuint32_t xb[4] = {(cuuint32_t)KS, (cuuint32_t)(cw + 2), 8, 1};
  e = encode_map<float>(&xmap, x, 4, xd, xs, xb, swizzle_of(Q::kS));
  if (e != cudaSuccess) return e;
  xb[2] = 2;
  e = encode_map<float>(&xtail, x, 4, xd, xs, xb, swizzle_of(Q::kS));
  if (e != cudaSuccess) return e;
  const cuuint64_t wd[3] = {(cuuint64_t)cs, (cuuint64_t)O,
                            (cuuint64_t)(9 * Q::kPlanes)};
  const cuuint64_t wst[2] = {cs * 4ull, cs * 4ull * O};
  const cuuint32_t wb[3] = {(cuuint32_t)KS, (cuuint32_t)N,
                            (cuuint32_t)(9 * Q::kPlanes)};
  e = encode_map<float>(&wmap, ws, 3, wd, wst, wb, swizzle_of(Q::kS));
  if (e != cudaSuccess) return e;
  const int a_slot = ((rows + 2) * (cw + 2) * Q::kS + 1023) / 1024 * 1024;
  const int stage = a_slot + Q::kWBytes;
  const int fixed = 1024 + N * 4;  // alignment, the bias
  const int stages = std::min(kMaxStages, (kSmemMax - fixed) / (stage + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t bytes = fixed + (size_t)stages * (stage + 16);
  // A split needs two K slices or more: KS = 8 (C <= 8) has one.
  auto kernel = conv3x3_rows_kernel<N, KS, P, false>;
  if constexpr (KS == 16)
    if (splits > 1) kernel = conv3x3_rows_kernel<N, KS, P, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, st>>>(
      xmap, xtail, wmap, static_cast<const float*>(b), static_cast<float*>(y),
      sp.part, sp.cnt, B, H, W, cp, O, lc, stages, a_slot, splits);
  return cudaGetLastError();
}

template <int N, int P>
cudaError_t rows_ks(const void* x, const void* w, const void* b, void* y,
                    void* ws, int B, int H, int W, int C, int O, int lc,
                    int ks, int grid, int splits, cudaStream_t st) {
  if (ks == 8)
    return launch_rows<N, 8, P>(x, w, b, y, ws, B, H, W, C, O, lc, grid,
                                splits, st);
  if (ks == 16)
    return launch_rows<N, 16, P>(x, w, b, y, ws, B, H, W, C, O, lc, grid,
                                 splits, st);
  return cudaErrorInvalidValue;
}

template <int P>
cudaError_t rows_n(const void* x, const void* w, const void* b, void* y,
                   void* ws, int B, int H, int W, int C, int O, int lc, int n,
                   int ks, int grid, int splits, cudaStream_t st) {
  switch (n) {
    case 8: return rows_ks<8, P>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid, splits, st);
    case 16: return rows_ks<16, P>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid, splits, st);
    case 32: return rows_ks<32, P>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B,H,W,Cp] fp32 (Cp = C rounded up to 4), w [3,3,C,O], b [O] or null,
// y [B,H,W,O], every pointer 16-byte aligned; O <= n, n = O rounded up to
// 8, 16 or 32.  The wrapper's plan (kernels/conv3x3.py: tf32_rows_plan):
// `cols` (cw: 16, 32 or 64), `n`, `ks` (the K slice: 8 or 16), `grid`,
// `splits` (K splits a tile, 1 up to the K slices) and the TF32 `passes` (3
// or 1); `ws`, a scratch of 9 O Cs floats a plane (two planes at three
// passes, Cs = C rounded up to ks) followed, where splits > 1, by the split
// workspace: the fp32 partials of tiles x splits units of 128 R pixels x n
// channels (R = Rows::kR, kernels/conv3x3.py rows_phases: 8, 8, 4 at n =
// 8, 16, 32 at one pass, 8, 4, 2 at three), then two int counters a
// tile.
extern "C" int rr_conv3x3_rows(const void* x, const void* w, const void* b,
                               void* y, void* ws, int B, int H, int W, int C,
                               int O, int cols, int n, int ks, int grid,
                               int splits, int passes, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || O > n || grid <= 0 ||
      ws == nullptr)
    return cudaErrorInvalidValue;
  const int lc = cols == 16 ? 4 : cols == 32 ? 5 : cols == 64 ? 6 : -1;
  if (lc < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  if (passes == 3)
    return rows_n<3>(x, w, b, y, ws, B, H, W, C, O, lc, n, ks, grid, splits,
                     st);
  if (passes == 1)
    return rows_n<1>(x, w, b, y, ws, B, H, W, C, O, lc, n, ks, grid, splits,
                     st);
  return cudaErrorInvalidValue;
}
