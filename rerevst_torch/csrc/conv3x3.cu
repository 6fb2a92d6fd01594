// SAME-padded 3x3 convolution, NHWC x HWIO -> NHWC, with an optional bias:
//
//   y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] w[dy, dx, c, o]
//
// (x is zero outside each image), accumulated in fp32, the bias added in
// fp32, and the sum rounded once to the storage dtype.  The weights are read
// in the HWIO [3, 3, C, O] layout the checkpoints hold, with no relayout per
// call.  Two entry points:
//
// rr_conv3x3 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_implicit_gemm
// (nine accumulated [tile_h W, C] x [C, O] MXU products over a halo'd row
// slab): any C, any O.
// rr_conv3x3_c64 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_pairlane,
// the same function for C = 64, O <= 64 (the full-resolution 64-channel
// layers: encoder conv1_2, decoder res2.conv2 and the 64->3 out conv).  The
// TPU kernel's lane pairing of two W-adjacent pixels only fills the MXU's
// 128 lanes and has no counterpart here.
//
// Which design takes which call (by shape, in the launcher):
// * 16-bit (f16, bf16) with C = 64 -- both entry points, every O: the
//   streamed design below (conv3x3_stream_kernel).
// * 16-bit with C != 64 -- rr_conv3x3 only (VGG's conv1_1 with C = 3, whose
//   6-byte pixel stride no tensor map takes, and the wide layers): the
//   cp.async implicit GEMM (conv3x3_igemm_kernel).
// * fp32: true fp32 CUDA-core FMAs (the counterpart of the JAX package's
//   HIGHEST precision) in one kernel that both entry points use.
//
// What bounds the C = 64 convs on the H100 (989 TFLOP/s dense f16/bf16,
// 3.35 TB/s): at 64 -> 64 a pixel costs 2 x 576 x 64 = 73.7 kflop against
// 256 bytes moved, 288 flop/byte, so bytes and operations nearly tie (0.50
// ms each for 16 frames of 640^2).  At 64 -> 3 the 134 bytes per pixel bound
// it (0.26 ms): the input must be read from device memory about once and the
// products must keep up with it.
//
// The streamed design.  A work unit is one image x a strip of 128 output
// columns x a band of R output rows.  The wrapper's plan
// (kernels/conv3x3.py: conv_plan) picks R and the grid: one persistent block
// per SM in all, walking units u = blockIdx.x, + gridDim.x, ...; for each it
// streams the band's R + 2 input rows, top to bottom, one 130-pixel halo row
// at a time:
// * One producer thread loads each row with TMA, a box of {64 channels, 130
//   pixels} from a 4-D tensor map over x with the 128-byte swizzle (one
//   pixel of 64 16-bit channels is one 128-byte swizzle row).  Coordinates
//   of -1 or past the edge are zero-filled by the hardware: that is the SAME
//   padding, with no branch and no padded copy.  Six 1024-byte-aligned row
//   slots, each with a full and an empty mbarrier, keep up to six rows in
//   flight.
// * Two consumer warpgroups, one m64 tile of 64 pixels each, read each
//   arriving row once into registers with ldmatrix (16-byte chunk j of box
//   pixel p sits at chunk j ^ (p % 8), so every dx shift is free of bank
//   conflicts) and release the slot (after a proxy fence: the next TMA write
//   into it must not overtake these reads).  Each A fragment then serves the
//   three output rows the row feeds: input row r adds tap dy into output row
//   r + 1 - dy, through three rolling fp32 accumulators (the row loop is
//   unrolled by three so that each accumulator has a fixed register name).
//   After input row r, output row r - 1 is complete and is stored.  Each
//   input value is read from device memory (R + 2) / R x 130 / 128 times,
//   1.06x at the benchmark's R = 50.
// * Products are wgmma.mma_async m64nNk16, A from registers, B from the
//   nine 64 x N weight taps, laid out once per block in wgmma's K-major
//   128-byte-swizzled layout and resident for the block's life (73.7 KB at
//   N = 64).  N is 8, 16, 32 or 64 (O <= 8, 16, 32, else 64; below about 48
//   channels the conv is bound by bytes, so the padded columns cost no
//   time); larger O tiles by 64 over the grid's y, each tile with its own
//   resident taps.  The two warpgroups issue their rows' products on their
//   own, so the tensor cores run one's products while the other stores its
//   finished row and loads its next one.  Three m64n64 accumulators and a
//   row's A fragments need more registers than an even split of 384
//   threads gives: setmaxnreg moves them from the producer warpgroup (40)
//   to the consumers (232); with fewer, ptxas serializes the wgmmas.
// * The epilogue adds the bias in fp32, rounds once, stages the row in
//   shared memory and stores it with 16-byte vectors where O % 8 = 0, or
//   with coalesced scalar stores (the out conv's 6-byte pixels, which no
//   tensor map takes).  The products of the band's first and last input
//   rows for rows outside the band go into accumulators that are never
//   stored: 2 rows' worth of products in R + 2.

// The cp.async implicit GEMM (C != 64).  A block computes 128 consecutive
// output pixels (flattened over batch, rows and columns) by up to 64 output
// channels.  Each K step stages a 128 x 32 input chunk, gathered straight
// from x with the halo's zeros, and a 32 x N weight chunk in shared memory,
// double-buffered with cp.async (16-byte copies whose out-of-image and
// past-C parts are zero-filled by the copy itself; scalar loads where C or O
// is not a multiple of 8).  mma.sync m16n8k16 with fp32 accumulation,
// operands through ldmatrix (rows padded by 16 bytes).  Every input value is
// gathered nine times per call, from L2.
//
// Offsets are 64-bit: a batch of 16 frames of 640^2 x 64 holds 4.2e8
// values.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;  // 8 warps (implicit GEMM, fp32)
constexpr int kBM = 128;       // output pixels per block tile (implicit GEMM)
constexpr int kKC = 32;        // channels per K step (implicit GEMM)
constexpr int kLDA = kKC + 8;  // padded row of the staged input chunk

// The streamed design.
constexpr int kC = 64;                     // input channels it takes
constexpr int kTW = 128;                   // output pixels per strip
constexpr int kBoxPix = kTW + 2;           // pixels per TMA row box
constexpr int kBoxBytes = kBoxPix * kC * 2;                   // 16640
constexpr int kSlotBytes = (kBoxBytes + 1023) / 1024 * 1024;  // 17408
constexpr int kSlots = 6;                  // input rows in flight
constexpr int kConsumerThreads = 256;      // two warpgroups
// + a producer warpgroup: one thread issues the loads, but setmaxnreg hands
// registers over by whole warpgroups.
constexpr int kStreamThreads = kConsumerThreads + 128;

// Padded row length of a [k][BN] weight tile: 16 bytes of padding keeps
// ldmatrix free of bank conflicts; an 8-wide row is already conflict-free.
template <int BN>
__host__ __device__ constexpr int ldw() { return BN == 8 ? 8 : BN + 8; }

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

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

// A fragment of m16n8k16 (and, per warp, of wgmma's register A): a 16 x 16
// row-major tile; lane l names row l % 16, columns 8 (l / 16) .. +7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  ldsm_x4(r, smem_addr(p));
}

// B fragment of m16n8k16 from a [k][n] row-major tile: lane l (< 16) names
// row k = l, columns n .. n+7; the transpose gives the "col" operand.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mbarriers, TMA and fences (shared-memory addresses as 32-bit integers).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  A wait of more
// than 10 s traps: a row that never arrives becomes a launch error rather
// than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (i & 1023) == 1023) {
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (wgmma's operand reads, TMA's writes).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Registers move between warpgroups: the producer gives its up, the
// consumer warpgroups take them (the launch grants every warp the same).
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulators at this point of the instruction stream: the compiler
// may not move a read or copy of them across it (into the span where an
// in-flight wgmma is still writing them).
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused), stride 1024 bytes
// between 8-row groups, layout 1 (128B swizzle).  The base must be
// 1024-byte aligned; a k16 step adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 per thread), A from
// registers (4 x 2 values), B through the descriptor desc + Off (Off in
// 16-byte units, added inside the asm so that the compiler does not keep
// every tap's descriptor live in registers), K-major; scale_d = 0 starts d
// afresh (d = A B, the old d unread).
#define RR_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RR_D8(i) RR_D4(i), RR_D4(i + 4)
#define RR_D16(i) RR_D8(i), RR_D8(i + 8)
#define RR_D32(i) RR_D16(i), RR_D16(i + 16)
#define RR_WGMMA_IN \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(Off), "r"(scale_d)

#define RR_WGMMA_N8(TY)                                               \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %10, 0;\n"     \
      "add.s64 dd, %8, %9;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "      \
      "{%0, %1, %2, %3}, "                                            \
      "{%4, %5, %6, %7}, dd, p, 1, 1, 0;\n}\n"                        \
      : RR_D4(0)                                                      \
      : RR_WGMMA_IN)

#define RR_WGMMA_N16(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %14, 0;\n"     \
      "add.s64 dd, %12, %13;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                            \
      "{%8, %9, %10, %11}, dd, p, 1, 1, 0;\n}\n"                      \
      : RR_D8(0)                                                      \
      : RR_WGMMA_IN)

#define RR_WGMMA_N32(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %22, 0;\n"     \
      "add.s64 dd, %20, %21;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                       \
      "{%16, %17, %18, %19}, dd, p, 1, 1, 0;\n}\n"                    \
      : RR_D16(0)                                                     \
      : RR_WGMMA_IN)

#define RR_WGMMA_N64(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %38, 0;\n"     \
      "add.s64 dd, %36, %37;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                     \
      "{%32, %33, %34, %35}, dd, p, 1, 1, 0;\n}\n"                    \
      : RR_D32(0)                                                     \
      : RR_WGMMA_IN)

template <typename T, int N, int Off>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (N == 8) {
    if constexpr (f16) RR_WGMMA_N8("f16"); else RR_WGMMA_N8("bf16");
  } else if constexpr (N == 16) {
    if constexpr (f16) RR_WGMMA_N16("f16"); else RR_WGMMA_N16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (f16) RR_WGMMA_N32("f16"); else RR_WGMMA_N32("bf16");
  } else {
    static_assert(N == 64, "wgmma width");
    if constexpr (f16) RR_WGMMA_N64("f16"); else RR_WGMMA_N64("bf16");
  }
}

// Two fp32 values rounded to the storage dtype, packed low first.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// 16-bit, C = 64: rows streamed down column strips (the design above)
// ---------------------------------------------------------------------------

template <int BN>
constexpr size_t stream_smem_bytes() {
  return 1024                        // slack to align the base to 1024 bytes
         + 9 * BN * 128              // the nine weight taps
         + kSlots * kSlotBytes       // input row slots
         + 2 * 64 * (BN + 8) * 2     // output staging, one tile per warpgroup
         + BN * 4                    // the bias, fp32
         + 2 * kSlots * 8;           // full and empty mbarriers
}

// Work unit u: image b, output rows y0 .. y0 + rows - 1, columns x0 .. +127.
// The order (strip fastest, then band, then image) is the wrapper's plan's
// (kernels/conv3x3.py: ConvPlan.unit).
struct Unit {
  int b, y0, x0, rows;
};

__device__ __forceinline__ Unit unit_of(long long u, int strips, int bands,
                                        int R, int H) {
  Unit t;
  t.x0 = (int)(u % strips) * kTW;
  const long long q = u / strips;
  t.y0 = (int)(q % bands) * R;
  t.b = (int)(q / bands);
  t.rows = min(R, H - t.y0);
  return t;
}

// What a consumer thread keeps across the rows of its units.
struct Consumer {
  uint32_t slots, full, empty;  // shared addresses of slot 0 and barriers
  uint64_t desc0;               // wgmma descriptor of weight tap 0
  int p0;                       // this lane's ldmatrix pixel at dx = 0
  int hi;                       // this lane's 8-channel half of a k16 step
  int lane, warp, wg, tid;      // tid within the warpgroup
  int s;                        // the next slot
  uint32_t ph;                  // its phase parity
};

// One finished output row (this warpgroup's 64 pixels from pixel index
// `pix`, `npx` of them inside the image): + bias, rounded once,
// staged in shared memory, stored with 16-byte vectors (O % 8 = 0) or
// coalesced scalars.
template <typename T, int BN>
__device__ __forceinline__ void stream_store(const float (&acc)[BN / 2],
                                             const Consumer& c, T* st,
                                             const float* bias_s,
                                             T* __restrict__ y, long long pix,
                                             int npx, int O, int n0) {
  constexpr int LDO = BN + 8;
  bar_sync_wg(1 + c.wg);  // the previous row's copy-out has read `st`
  const int r = c.warp * 16 + (c.lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (c.lane & 3) * 2;
    const float b0 = bias_s[col], b1 = bias_s[col + 1];
    *reinterpret_cast<uint32_t*>(st + r * LDO + col) =
        pack2<T>(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(st + (r + 8) * LDO + col) =
        pack2<T>(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  bar_sync_wg(1 + c.wg);
  const int oc = min(BN, O - n0);
  if (O % 8 == 0) {
    constexpr int VPR = BN / 8;
    for (int i = c.tid; i < 64 * VPR; i += 128) {
      const int px = i / VPR, v = i % VPR;
      if (px < npx && v * 8 < oc)
        *reinterpret_cast<uint4*>(y + (pix + px) * O + n0 + v * 8) =
            *reinterpret_cast<const uint4*>(st + px * LDO + v * 8);
    }
  } else {
    for (int i = c.tid; i < npx * oc; i += 128) {
      const int px = i / oc, ch = i % oc;
      y[(pix + px) * O + n0 + ch] = st[px * LDO + ch];
    }
  }
}

// One k16 step of a row's products: A fragment (dx, k) times the taps
// (dy, dx), channels 16 k .. 16 k + 15, for dy = 0, 1, 2 into acc[F],
// acc[M], acc[D]; tap (0, 0) of k = 0 starts acc[F] afresh.
template <typename T, int BN, int F, int M, int D, int I>
__device__ __forceinline__ void issue_k16(float (&acc)[3][BN / 2],
                                          const uint32_t (&a)[3][4][4],
                                          uint64_t desc0) {
  constexpr int dx = I / 4, k = I % 4;
  constexpr int off = dx * BN * 8 + 2 * k;  // 16-byte units into the taps
  wgmma<T, BN, off>(acc[F], a[dx][k], desc0, I > 0);
  wgmma<T, BN, 3 * BN * 8 + off>(acc[M], a[dx][k], desc0, 1);
  wgmma<T, BN, 6 * BN * 8 + off>(acc[D], a[dx][k], desc0, 1);
}

template <typename T, int BN, int F, int M, int D, int... I>
__device__ __forceinline__ void issue_row(float (&acc)[3][BN / 2],
                                          const uint32_t (&a)[3][4][4],
                                          uint64_t desc0,
                                          std::integer_sequence<int, I...>) {
  (issue_k16<T, BN, F, M, D, I>(acc, a, desc0), ...);
}

// Input row t of a unit (image row y0 - 1 + t), as the P-th of three
// consecutive rows (P = t % 3): its taps dy = 0, 1, 2 go into output rows
// t, t - 1, t - 2 of the unit, held in acc[P], acc[(P + 2) % 3] and
// acc[(P + 1) % 3]; tap dy = 0 starts its accumulator afresh.  After it,
// output row t - 2 is complete and is stored (t >= 2).
template <typename T, int BN, int P>
__device__ __forceinline__ void stream_row(float (&acc)[3][BN / 2],
                                           Consumer& c, int t, T* st,
                                           const float* bias_s,
                                           T* __restrict__ y, long long pix,
                                           int W, int npx, int O, int n0) {
  constexpr int kFresh = P, kMid = (P + 2) % 3, kDone = (P + 1) % 3;
  mbar_wait(c.full + 8 * c.s, c.ph);
  const uint32_t slot = c.slots + c.s * kSlotBytes;
  const uint32_t empty = c.empty + 8 * c.s;
  uint32_t a[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int p = c.p0 + dx;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ldsm_x4(a[dx][k], slot + p * 128 + (((2 * k + c.hi) ^ (p & 7)) << 4));
  }
  // The row is in registers: release the slot.  The fence orders these
  // generic-proxy reads before the next TMA (async-proxy) write into it;
  // without it the last pixels of a row could be overwritten before they
  // were read.
  fence_async_shared();
  __syncwarp();
  if (c.lane == 0) mbar_arrive(empty);
  if (++c.s == kSlots) {
    c.s = 0;
    c.ph ^= 1;
  }
  fence_regs(acc);
  wgmma_fence();
  issue_row<T, BN, kFresh, kMid, kDone>(acc, a, c.desc0,
                                        std::make_integer_sequence<int, 12>{});
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  if (t >= 2)
    stream_store<T, BN>(acc[kDone], c, st, bias_s, y,
                        pix + (long long)(t - 2) * W, npx, O, n0);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kStreamThreads, 1) conv3x3_stream_kernel(
    const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ y, int B, int H, int W, int O,
    int R) {
  constexpr int LDO = BN + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* slots = ws + 9 * BN * 128;
  T* stage = reinterpret_cast<T*>(slots + kSlots * kSlotBytes);
  float* bias_s = reinterpret_cast<float*>(stage + 2 * 64 * LDO);
  const uint32_t full = smem_addr(bias_s + BN), empty = full + 8 * kSlots;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const T zero = rr_from_float<T>(0.f);

  // The nine taps of output channels n0 .. n0 + BN - 1, once per block:
  // tap t, channel n, input channel c at t BN 128 + n 128 + 16 ((c / 8) ^
  // (n % 8)) + 2 (c % 8) bytes, wgmma's K-major 128B-swizzled layout (the
  // HWIO layout's O-contiguous rows transposed on the way in).
  for (int i = tid; i < 9 * kC * BN; i += kStreamThreads) {
    const int n = i % BN, ch = (i / BN) % kC, tap = i / (BN * kC);
    const int o = n0 + n;
    T* dst = reinterpret_cast<T*>(ws + tap * BN * 128 + n * 128 +
                                  (((ch >> 3) ^ (n & 7)) << 4)) +
             (ch & 7);
    *dst = o < O ? w[((long long)tap * kC + ch) * O + o] : zero;
  }
  for (int n = tid; n < BN; n += kStreamThreads)
    bias_s[n] = bias != nullptr && n0 + n < O ? rr_to_float(bias[n0 + n]) : 0.f;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  fence_async_shared();
  __syncthreads();

  const int strips = (W + kTW - 1) / kTW;
  const int bands = (H + R - 1) / R;
  const long long units = (long long)B * bands * strips;

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every unit's rows y0 - 1 ..
    // y0 + rows, pixels x0 - 1 .. x0 + 128, into the ring of slots.
    regs_release();
    if (tid == kConsumerThreads) {
      int s = 0;
      uint32_t ph = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_of(u, strips, bands, R, H);
        for (int t = 0; t < un.rows + 2; ++t) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, kBoxBytes);
          tma_load_4d(smem_addr(slots) + s * kSlotBytes, &xmap, full + 8 * s,
                      0, un.x0 - 1, un.y0 - 1 + t, un.b);
          if (++s == kSlots) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes pixels x0 + 64 wg .. + 63.
  regs_claim();
  Consumer c;
  c.slots = smem_addr(slots);
  c.full = full;
  c.empty = empty;
  c.desc0 = wgmma_desc(smem_addr(ws));
  c.lane = tid & 31;
  c.warp = (tid >> 5) & 3;
  c.wg = tid >> 7;
  c.tid = tid & 127;
  c.p0 = c.wg * 64 + c.warp * 16 + (c.lane & 15);
  c.hi = c.lane >> 4;
  c.s = 0;
  c.ph = 0;
  T* st = stage + c.wg * 64 * LDO;
  float acc[3][BN / 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;

  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, strips, bands, R, H);
    const int xw = un.x0 + c.wg * 64;
    const long long pix = ((long long)un.b * H + un.y0) * W + xw;
    const int npx = min(64, W - xw);
    const int nt = un.rows + 2;
    for (int t = 0; t < nt; t += 3) {
      stream_row<T, BN, 0>(acc, c, t, st, bias_s, y, pix, W, npx, O, n0);
      if (t + 1 < nt)
        stream_row<T, BN, 1>(acc, c, t + 1, st, bias_s, y, pix, W, npx, O, n0);
      if (t + 2 < nt)
        stream_row<T, BN, 2>(acc, c, t + 2, st, bias_s, y, pix, W, npx, O, n0);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit, C != 64 (rr_conv3x3): tiles of 128 pixels x BN channels, K in
// 32-wide chunks
// ---------------------------------------------------------------------------

// Warp tiling of a 128 x BN block tile over 8 warps: 4 x 2 warps of 32 x 32
// at BN = 64, else 8 x 1 warps of 16 x BN.
template <int BN>
struct WarpTile {
  static constexpr int kWarpsN = BN == 64 ? 2 : 1;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;  // rows per warp
  static constexpr int kWN = BN / kWarpsN;   // columns per warp
  static constexpr int kMI = kWM / 16;       // m16 tiles per warp
  static constexpr int kNI = kWN / 8;        // n8 tiles per warp
};

// One k16 step of a warp's products: A rows from `a_row(i)` (the address of
// row (lane % 16) of m16 tile i at column 0 of this step), B from a [k][n]
// tile at `b` (row 0 of this step, the warp's first column).
template <typename T, int BN, typename ARow>
__device__ __forceinline__ void warp_k16(
    float (&acc)[WarpTile<BN>::kMI][WarpTile<BN>::kNI][4], ARow a_row,
    const T* b, int lane) {
  using WT = WarpTile<BN>;
  constexpr int LDB = ldw<BN>();
  uint32_t af[WT::kMI][4], bf[WT::kNI][2];
#pragma unroll
  for (int i = 0; i < WT::kMI; ++i) ldsm_x4(af[i], a_row(i) + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < WT::kNI; ++j)
    ldsm_x2_trans(bf[j], b + (lane & 15) * LDB + j * 8);
#pragma unroll
  for (int i = 0; i < WT::kMI; ++i)
#pragma unroll
    for (int j = 0; j < WT::kNI; ++j) mma16816<T>(acc[i][j], af[i], bf[j]);
}

// Epilogue part 1: accumulators + bias (fp32), rounded once, into a
// [128][BN + 8] tile in shared memory.
template <typename T, int BN>
__device__ __forceinline__ void stage_out(
    const float (&acc)[WarpTile<BN>::kMI][WarpTile<BN>::kNI][4], T* os,
    const T* __restrict__ bias, int n0, int O, int wm, int wn, int lane) {
  using WT = WarpTile<BN>;
  constexpr int LDO = BN + 8;
#pragma unroll
  for (int j = 0; j < WT::kNI; ++j) {
    const int col = wn * WT::kWN + j * 8 + (lane & 3) * 2;
    const int o = n0 + col;
    const float b0 = (bias != nullptr && o < O) ? rr_to_float(bias[o]) : 0.f;
    const float b1 =
        (bias != nullptr && o + 1 < O) ? rr_to_float(bias[o + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < WT::kMI; ++i) {
      const int row = wm * WT::kWM + i * 16 + (lane >> 2);
      os[row * LDO + col] = rr_from_float<T>(acc[i][j][0] + b0);
      os[row * LDO + col + 1] = rr_from_float<T>(acc[i][j][1] + b1);
      os[(row + 8) * LDO + col] = rr_from_float<T>(acc[i][j][2] + b0);
      os[(row + 8) * LDO + col + 1] = rr_from_float<T>(acc[i][j][3] + b1);
    }
  }
}

// Epilogue part 2: rows of the staged tile to y.  `pix(r)` is row r's pixel
// index into y, or -1 past the ragged edge.
template <typename T, int BN, bool VO, typename Pix>
__device__ __forceinline__ void store_out(const T* os, T* __restrict__ y,
                                          Pix pix, int n0, int O) {
  constexpr int LDO = BN + 8;
  if (VO) {  // O % 8 == 0: whole 16-byte vectors
    constexpr int VPR = BN / 8;
    for (int i = threadIdx.x; i < kBM * VPR; i += kThreads) {
      const int r = i / VPR, v = i % VPR;
      const long long m = pix(r);
      const int o = n0 + v * 8;
      if (m >= 0 && o < O)
        *reinterpret_cast<uint4*>(y + m * O + o) =
            *reinterpret_cast<const uint4*>(os + r * LDO + v * 8);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const long long m = pix(r);
      if (m >= 0 && n0 + c < O) y[m * O + n0 + c] = os[r * LDO + c];
    }
  }
}

template <typename T, int BN, bool VX, bool VO>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_igemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ y, int B, int H, int W, int C, int O) {
  using WT = WarpTile<BN>;
  constexpr int LDB = ldw<BN>();
  constexpr int kStageA = kBM * kLDA;
  constexpr int kStageB = kKC * LDB;
  static_assert(kBM * (BN + 8) <= 2 * kStageA, "epilogue tile fits");
  __shared__ __align__(16) T as[2 * kStageA];
  __shared__ __align__(16) T bs[2 * kStageB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WT::kWarpsM, wn = warp / WT::kWarpsM;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // Each thread stages one input row (pixel) of every chunk: 16 channels.
  const int arow = tid >> 1, acol = (tid & 1) * 16;
  const long long am = m0 + arow;
  const bool am_ok = am < M;
  const int ax = am_ok ? (int)(am % W) : 0;
  const long long aq = am_ok ? am / W : 0;
  const int ay = (int)(aq % H);
  const long long ab = aq / H;

  const int nkc = (C + kKC - 1) / kKC;
  const int nk = 9 * nkc;
  const T zero = rr_from_float<T>(0.f);

  auto load = [&](int stage, int kt) {
    const int tap = kt / nkc, c0 = (kt % nkc) * kKC;
    const int yy = ay + tap / 3 - 1, xx = ax + tap % 3 - 1;
    const bool in = am_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* src = x + ((ab * H + yy) * W + xx) * C;
    T* dst = as + stage * kStageA + arow * kLDA + acol;
    if (VX) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = c0 + acol + v * 8;
        const bool ok = in && c < C;
        cp_async16(dst + v * 8, ok ? src + c : x, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + acol + j;
        dst[j] = (in && c < C) ? src[c] : zero;
      }
    }
    constexpr int VPR = BN / 8;  // 8-wide weight vectors per row
    if (tid < kKC * VPR) {
      const int r = tid / VPR, o = n0 + (tid % VPR) * 8, c = c0 + r;
      const T* wsrc = w + ((long long)tap * C + c) * O + o;
      T* wdst = bs + stage * kStageB + r * LDB + (tid % VPR) * 8;
      if (VO) {
        const bool ok = c < C && o < O;
        cp_async16(wdst, ok ? wsrc : w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wdst[j] = (c < C && o + j < O) ? wsrc[j] : zero;
      }
    }
  };

  float acc[WT::kMI][WT::kNI][4];
#pragma unroll
  for (int i = 0; i < WT::kMI; ++i)
#pragma unroll
    for (int j = 0; j < WT::kNI; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* a = as + (kt & 1) * kStageA;
    const T* b = bs + (kt & 1) * kStageB + wn * WT::kWN;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      auto a_row = [&](int i) {
        return a + (wm * WT::kWM + i * 16 + (lane & 15)) * kLDA + kk;
      };
      warp_k16<T, BN>(acc, a_row, b + kk * LDB, lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  cp_async_wait<0>();

  T* os = as;
  stage_out<T, BN>(acc, os, bias, n0, O, wm, wn, lane);
  __syncthreads();
  store_out<T, BN, VO>(
      os, y, [&](int r) { return m0 + r < M ? m0 + r : -1LL; }, n0, O);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs, tiles of 64 pixels x 64 channels, 4 x 4 per thread
// ---------------------------------------------------------------------------

constexpr int kF32M = 64, kF32N = 64, kF32K = 16;

__global__ void __launch_bounds__(kThreads) conv3x3_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, int B, int H, int W,
    int C, int O) {
  __shared__ __align__(16) float as[kF32K][kF32M + 4];  // [c][pixel]
  __shared__ __align__(16) float bs[kF32K][kF32N];      // [c][o]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 4 channels, 4 pixels each
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kF32M;
  const int n0 = blockIdx.y * kF32N;

  // Staging roles: input pixel tid / 4 (channels 4 (tid % 4) .. +3), weight
  // row tid / 16 (outputs 4 (tid % 16) .. +3).
  const int arow = tid >> 2, acol = (tid & 3) * 4;
  const long long am = m0 + arow;
  const bool am_ok = am < M;
  const int ax = am_ok ? (int)(am % W) : 0;
  const long long aq = am_ok ? am / W : 0;
  const int ay = (int)(aq % H);
  const long long ab = aq / H;
  const int brow = tid >> 4, bcol = (tid & 15) * 4;

  const int nkc = (C + kF32K - 1) / kF32K;
  const int nk = 9 * nkc;
  float ra[4], rb[4];
  auto fetch = [&](int kt) {
    const int tap = kt / nkc, c0 = (kt % nkc) * kF32K;
    const int yy = ay + tap / 3 - 1, xx = ax + tap % 3 - 1;
    const bool in = am_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const float* src = x + ((ab * H + yy) * W + xx) * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + acol + j;
      ra[j] = (in && c < C) ? src[c] : 0.f;
    }
    const int c = c0 + brow;
    const float* wsrc = w + ((long long)tap * C + c) * O;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + bcol + j;
      rb[j] = (c < C && o < O) ? wsrc[o] : 0.f;
    }
  };

  float acc[4][4] = {};
  fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) as[acol + j][arow] = ra[j];
    *reinterpret_cast<float4*>(&bs[brow][bcol]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (kt + 1 < nk) fetch(kt + 1);  // in flight while this chunk computes
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const int o0 = n0 + tx * 4;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bv[j] = (bias != nullptr && o0 + j < O) ? bias[o0 + j] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) break;
    float* dst = y + m * O + o0;
    if (O % 4 == 0 && o0 < O) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0] + bv[0], acc[i][1] + bv[1], acc[i][2] + bv[2],
                      acc[i][3] + bv[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o0 + j < O) dst[j] = acc[i][j] + bv[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

cudaError_t launch_f32(const void* x, const void* w, const void* b, void* y,
                       int B, int H, int W, int C, int O, cudaStream_t st) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + kF32M - 1) / kF32M), (O + kF32N - 1) / kF32N);
  conv3x3_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), B, H, W, C, O);
  return cudaGetLastError();
}

template <typename T, int BN, bool VX, bool VO>
cudaError_t launch_igemm(const void* x, const void* w, const void* b, void* y,
                         int B, int H, int W, int C, int O, cudaStream_t st) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (O + BN - 1) / BN);
  conv3x3_igemm_kernel<T, BN, VX, VO><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), B, H, W, C, O);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t igemm_vec(const void* x, const void* w, const void* b, void* y,
                      int B, int H, int W, int C, int O, cudaStream_t st) {
  const bool vx = C % 8 == 0, vo = O % 8 == 0;
  if (vx && vo) return launch_igemm<T, BN, true, true>(x, w, b, y, B, H, W, C, O, st);
  if (vx) return launch_igemm<T, BN, true, false>(x, w, b, y, B, H, W, C, O, st);
  if (vo) return launch_igemm<T, BN, false, true>(x, w, b, y, B, H, W, C, O, st);
  return launch_igemm<T, BN, false, false>(x, w, b, y, B, H, W, C, O, st);
}

template <typename T>
cudaError_t igemm(const void* x, const void* w, const void* b, void* y, int B,
                  int H, int W, int C, int O, cudaStream_t st) {
  if (O <= 8) return igemm_vec<T, 8>(x, w, b, y, B, H, W, C, O, st);
  if (O <= 32) return igemm_vec<T, 32>(x, w, b, y, B, H, W, C, O, st);
  return igemm_vec<T, 64>(x, w, b, y, B, H, W, C, O, st);
}

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the static runtime, so it is fetched through the runtime once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The streamed C = 64 kernel: `grid` persistent blocks per tile of BN output
// channels, bands of R rows.  The tensor map holds x's pointer, so it is
// encoded at every call.
template <typename T, int BN>
cudaError_t launch_stream(const void* x, const void* w, const void* b, void* y,
                          int B, int H, int W, int O, int R, int grid,
                          cudaStream_t st) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {kC * 2ull, kC * 2ull * W, kC * 2ull * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)kC, (cuuint32_t)kBoxPix, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      &map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(x), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  constexpr size_t bytes = stream_smem_bytes<BN>();
  // Above 48 KB a block gets dynamic shared memory only after this call
  // (on the current device); without it the launch is refused.
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_stream_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 g((unsigned)grid, (unsigned)((O + BN - 1) / BN));
  conv3x3_stream_kernel<T, BN><<<g, kStreamThreads, bytes, st>>>(
      map, static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), B, H, W, O, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stream(const void* x, const void* w, const void* b, void* y, int B,
                   int H, int W, int O, int R, int grid, cudaStream_t st) {
  if (R <= 0 || grid <= 0) return cudaErrorInvalidValue;
  if (O <= 8) return launch_stream<T, 8>(x, w, b, y, B, H, W, O, R, grid, st);
  if (O <= 16) return launch_stream<T, 16>(x, w, b, y, B, H, W, O, R, grid, st);
  if (O <= 32) return launch_stream<T, 32>(x, w, b, y, B, H, W, O, R, grid, st);
  return launch_stream<T, 64>(x, w, b, y, B, H, W, O, R, grid, st);
}

}  // namespace

// x [B,H,W,C], w [3,3,C,O], b [O] or null (all in the storage dtype),
// y [B,H,W,O]; every pointer 16-byte aligned.  `R` and `grid` are the
// wrapper's plan for the streamed C = 64 kernel (read only there).
extern "C" int rr_conv3x3(int dtype, const void* x, const void* w,
                          const void* b, void* y, int B, int H, int W, int C,
                          int O, int R, int grid, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  switch (dtype) {
    case RR_F32:
      return launch_f32(x, w, b, y, B, H, W, C, O, st);
    case RR_F16:
      return C == kC ? stream<__half>(x, w, b, y, B, H, W, O, R, grid, st)
                     : igemm<__half>(x, w, b, y, B, H, W, C, O, st);
    case RR_BF16:
      return C == kC
                 ? stream<__nv_bfloat16>(x, w, b, y, B, H, W, O, R, grid, st)
                 : igemm<__nv_bfloat16>(x, w, b, y, B, H, W, C, O, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same with C = 64 and O <= 64.
extern "C" int rr_conv3x3_c64(int dtype, const void* x, const void* w,
                              const void* b, void* y, int B, int H, int W,
                              int O, int R, int grid, void* stream_) {
  if (O > kC) return cudaErrorInvalidValue;
  return rr_conv3x3(dtype, x, w, b, y, B, H, W, kC, O, R, grid, stream_);
}
