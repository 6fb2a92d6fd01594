// SAME-padded 3x3 convolution, NHWC x HWIO -> NHWC, with an optional bias:
//
//   y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] w[dy, dx, c, o]
//
// (x is zero outside each image), accumulated in fp32, the bias added in
// fp32, and the sum rounded once to the storage dtype.  The weights are read
// in the HWIO [3, 3, C, O] layout the checkpoints hold, with no relayout per
// call.  Two entry points, one implicit-GEMM design (M = output pixels,
// N = O, K = 9 C, the K loop over the nine taps and over channel chunks):
//
// rr_conv3x3 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_implicit_gemm
// (nine accumulated [tile_h W, C] x [C, O] MXU products over a halo'd row
// slab).  It takes any C and any O.  A block computes 128 consecutive output
// pixels (flattened over batch, rows and columns, so a tile may span rows
// and images) by up to 64 output channels.  Each K step stages a 128 x 32
// input chunk, gathered straight from x with the halo's zeros, and a 32 x N
// weight chunk in shared memory, double-buffered with cp.async (16-byte
// copies whose out-of-image and past-C parts are zero-filled by the copy
// itself; scalar loads where C or O is not a multiple of 8, as for VGG's
// conv1_1 with C = 3).  C is zero-padded to the chunk depth and O to the
// tile width in shared memory; the ragged M and N edges are masked.
//
// rr_conv3x3_c64 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_pairlane,
// the same function for C = 64, O <= 64 (the full-resolution 64-channel
// layers: encoder conv1_2, decoder res2.conv2 and the 64->3 out conv).  The
// TPU kernel's lane pairing of two W-adjacent pixels only fills the MXU's
// 128 lanes and has no counterpart here.  What carries over is the
// specialisation: all nine 64 x O weight taps stay in shared memory for the
// block's life (72 KB at O = 64, so the launch raises the block's dynamic
// shared-memory limit), the grid is persistent, and each block walks over
// row segments of 128 output pixels, staging for each a 3-row halo slab
// (3 x 130 x 64 values, 56 KB) with cp.async while it computes the previous
// one.  Every input value the nine taps need is then read from device memory
// or L2 once per segment instead of nine times.
//
// 16-bit storage (f16, bf16): tensor-core products through mma.sync
// m16n8k16 with fp32 accumulation, operands from shared memory through
// ldmatrix (rows padded by 16 bytes, so neither the copies nor ldmatrix
// conflict on banks).  O <= 8 pads N to 8 and O <= 32 to 32, so the out
// conv's O = 3 computes one 8-wide column of products, not 64.  The
// epilogue adds the bias in fp32, rounds once, stages the tile in shared
// memory, and stores it with 16-byte vectors where O % 8 = 0 (scalar
// stores otherwise).
//
// fp32 storage: true fp32 CUDA-core FMAs (the counterpart of the JAX
// package's HIGHEST precision), in one 64 x 64-tile kernel that both entry
// points use; no model path runs the pair-lane conv in fp32.
//
// What bounds it on the H100 (989 TFLOP/s dense f16/bf16, 3.35 TB/s): at
// 64 -> 64 channels a pixel costs 2 x 576 x 64 = 73.7 kflop against 256
// bytes moved in f16, 288 flop/byte, so bytes and operations nearly tie
// (0.50 ms each for a batch of 16 frames of 640^2).  At 64 -> 3 the
// 134 bytes per pixel bound it.  This first design reaches neither: it uses
// mma.sync rather than wgmma and TMA, one block of 8 warps per SM, and
// re-reads each input row for three output rows (from L2).  Its times stand
// in PERF.md beside the bound; wgmma, TMA and row reuse are later work.
//
// Offsets are 64-bit: a batch of 16 frames of 640^2 x 64 holds 4.2e8
// values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels per block tile (16-bit)
constexpr int kKC = 32;        // channels per K step (rr_conv3x3, 16-bit)
constexpr int kLDA = kKC + 8;  // padded row of the staged input chunk
constexpr int kC64 = 64;       // channels of rr_conv3x3_c64
constexpr int kLDS = kC64 + 8; // padded pixel row of the halo slab
constexpr int kTW = kBM;       // output pixels per row segment (c64)

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

// A fragment of m16n8k16: a 16 x 16 row-major tile; lane l names row l % 16,
// columns 8 (l / 16) .. +7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// ---------------------------------------------------------------------------
// rr_conv3x3, 16-bit: tiles of 128 pixels x BN channels, K in 32-wide chunks
// ---------------------------------------------------------------------------

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
// rr_conv3x3_c64, 16-bit: resident weights, persistent 3-row halo slabs
// ---------------------------------------------------------------------------

template <typename T, int BN>
constexpr size_t c64_smem_bytes() {
  return sizeof(T) * (9 * kC64 * ldw<BN>()          // weights
                      + 2 * 3 * (kTW + 2) * kLDS    // two halo slabs
                      + kBM * (BN + 8));            // epilogue tile
}

template <typename T, int BN, bool VO>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_c64_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ y, int B, int H, int W, int O) {
  using WT = WarpTile<BN>;
  constexpr int LDW = ldw<BN>();
  constexpr int kSlab = 3 * (kTW + 2) * kLDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* slabs = ws + 9 * kC64 * LDW;
  T* os = slabs + 2 * kSlab;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WT::kWarpsM, wn = warp / WT::kWarpsM;
  const int segs_w = (W + kTW - 1) / kTW;
  const long long nseg = (long long)B * H * segs_w;
  const T zero = rr_from_float<T>(0.f);

  // All nine taps, [tap * 64 + c][o], O zero-padded to BN: once per block.
  {
    constexpr int VPR = BN / 8;
    for (int i = tid; i < 9 * kC64 * VPR; i += kThreads) {
      const int r = i / VPR, o = (i % VPR) * 8;
      const T* src = w + (long long)r * O + o;
      T* dst = ws + r * LDW + o;
      if (VO) {
        cp_async16(dst, o < O ? src : w, o < O);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = o + j < O ? src[j] : zero;
      }
    }
  }

  // Rows y-1, y, y+1 of pixels x0-1 .. x0+128 of one segment, zero outside
  // the image (the halo never reads across rows or images).
  auto load_slab = [&](int buf, long long seg) {
    const int x0 = (int)(seg % segs_w) * kTW;
    const long long q = seg / segs_w;
    const int yq = (int)(q % H);
    const long long bq = q / H;
    T* dst = slabs + buf * kSlab;
    constexpr int kVecs = 3 * (kTW + 2) * (kC64 / 8);
    for (int i = tid; i < kVecs; i += kThreads) {
      const int r = i / ((kTW + 2) * 8), rem = i % ((kTW + 2) * 8);
      const int p = rem >> 3, v = rem & 7;
      const int yy = yq + r - 1, xx = x0 + p - 1;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src = x + ((bq * H + yy) * W + xx) * kC64 + v * 8;
      cp_async16(dst + (r * (kTW + 2) + p) * kLDS + v * 8, ok ? src : x, ok);
    }
  };

  long long seg = blockIdx.x;
  if (seg < nseg) load_slab(0, seg);
  cp_async_commit();  // group 0: the weights and the first slab
  for (int it = 0; seg < nseg; seg += gridDim.x, ++it) {
    const long long nxt = seg + gridDim.x;
    if (nxt < nseg) load_slab((it + 1) & 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float acc[WT::kMI][WT::kNI][4];
#pragma unroll
    for (int i = 0; i < WT::kMI; ++i)
#pragma unroll
      for (int j = 0; j < WT::kNI; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

    const T* slab = slabs + (it & 1) * kSlab;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const T* wt = ws + tap * kC64 * LDW + wn * WT::kWN;
#pragma unroll
      for (int kk = 0; kk < kC64; kk += 16) {
        auto a_row = [&](int i) {
          const int p = wm * WT::kWM + i * 16 + (lane & 15) + dx;
          return slab + (dy * (kTW + 2) + p) * kLDS + kk;
        };
        warp_k16<T, BN>(acc, a_row, wt + kk * LDW, lane);
      }
    }

    stage_out<T, BN>(acc, os, bias, 0, O, wm, wn, lane);
    __syncthreads();
    const int x0 = (int)(seg % segs_w) * kTW;
    const long long row0 = (seg / segs_w) * W + x0;  // (b H + y) W + x0
    store_out<T, BN, VO>(
        os, y, [&](int r) { return x0 + r < W ? row0 + r : -1LL; }, 0, O);
    __syncthreads();  // the next iteration's copies and epilogue reuse smem
  }
  cp_async_wait<0>();
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

template <typename T, int BN, bool VO>
cudaError_t launch_c64(const void* x, const void* w, const void* b, void* y,
                       int B, int H, int W, int O, int grid, cudaStream_t st) {
  constexpr size_t bytes = c64_smem_bytes<T, BN>();
  // Above 48 KB a block gets dynamic shared memory only after this call
  // (on the current device); without it the launch is refused.
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_c64_kernel<T, BN, VO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  conv3x3_c64_kernel<T, BN, VO><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), B, H, W, O);
  return cudaGetLastError();
}

template <typename T>
cudaError_t c64(const void* x, const void* w, const void* b, void* y, int B,
                int H, int W, int O, int grid, cudaStream_t st) {
  const bool vo = O % 8 == 0;
  if (O <= 8)
    return vo ? launch_c64<T, 8, true>(x, w, b, y, B, H, W, O, grid, st)
              : launch_c64<T, 8, false>(x, w, b, y, B, H, W, O, grid, st);
  if (O <= 32)
    return vo ? launch_c64<T, 32, true>(x, w, b, y, B, H, W, O, grid, st)
              : launch_c64<T, 32, false>(x, w, b, y, B, H, W, O, grid, st);
  return vo ? launch_c64<T, 64, true>(x, w, b, y, B, H, W, O, grid, st)
            : launch_c64<T, 64, false>(x, w, b, y, B, H, W, O, grid, st);
}

}  // namespace

// x [B,H,W,C], w [3,3,C,O], b [O] or null (all in the storage dtype),
// y [B,H,W,O]; every pointer 16-byte aligned.
extern "C" int rr_conv3x3(int dtype, const void* x, const void* w,
                          const void* b, void* y, int B, int H, int W, int C,
                          int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RR_F32:
      return launch_f32(x, w, b, y, B, H, W, C, O, st);
    case RR_F16:
      return igemm<__half>(x, w, b, y, B, H, W, C, O, st);
    case RR_BF16:
      return igemm<__nv_bfloat16>(x, w, b, y, B, H, W, C, O, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same with C = 64 and O <= 64; `grid` persistent blocks (at most one
// per row segment of 128 pixels).
extern "C" int rr_conv3x3_c64(int dtype, const void* x, const void* w,
                              const void* b, void* y, int B, int H, int W,
                              int O, int grid, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || O <= 0 || O > kC64 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RR_F32:
      return launch_f32(x, w, b, y, B, H, W, kC64, O, st);
    case RR_F16:
      return c64<__half>(x, w, b, y, B, H, W, O, grid, st);
    case RR_BF16:
      return c64<__nv_bfloat16>(x, w, b, y, B, H, W, O, grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}
