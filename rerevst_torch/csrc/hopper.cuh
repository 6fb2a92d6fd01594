// Hopper helpers shared by the fp32 conv kernels (csrc/conv3x3.cu,
// csrc/conv3x3_rows.cu): warpgroup barriers and setmaxnreg, K-major wgmma
// descriptors, 3-D TMA loads and tensor maps, TF32 rounding and splitting
// of fp32 values, and the split-K walk and its ordered sum.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace {

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

// Shared-memory matrix descriptor of a K-major operand with the S-byte
// swizzle (S = 128 for the streamed and wide designs, 32 or 64 for the
// sliced one), as TMA lands boxes whose inner extent is S bytes: start
// address >> 4, leading offset 1 (unused), each row one S-byte swizzle
// row, eight rows a group 8 S bytes apart (the stride offset), layout 1, 2
// or 3 (128B, 64B, 32B).  A start must sit on a whole group of the
// pattern; a k16 step adds 32 bytes to it.
template <int S = 128>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  constexpr uint64_t layout = S == 128 ? 1 : S == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(S / 2) << 32) | (layout << 62);
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// A tiled tensor map over T (f16, bf16 or fp32) data with the 128-byte
// swizzle (or `swizzle`) and zero fill out of bounds.  The map holds the
// data's pointer, so it is encoded at every call.
template <typename T>
cudaError_t encode_map(
    CUtensorMap* map, const void* p, cuuint32_t rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(p), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A swizzle mode by span in bytes (16: none).
CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// TF32 of the fp32 bits v rounded to nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives (its low 13 bits are 0), in two integer
// operations.  For |v| below 0x7f7ff000: larger finite values would round
// up to inf.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) {
  return (v + 0x1000u) & 0xffffe000u;
}

// An input value's one-pass TF32 value (bits v): rounded to nearest,
// truncated where rounding would overflow (|v| >= 0x7f7ff000, inf kept),
// a NaN kept as one (0x7fffe000: truncation may leave a NaN no payload).
__device__ __forceinline__ uint32_t tf32_round_x(uint32_t v) {
  const uint32_t a = v & 0x7fffffffu;
  return a > 0x7f800000u ? 0x7fffe000u
                         : a >= 0x7f7ff000u ? v & 0xffffe000u : tf32_rna(v);
}

// An input value's lo (bits v): hi is v truncated to TF32, as the tensor
// cores read v; lo = v - hi (exact, with v's sign) truncated to TF32; 0
// where v is a TF32 value, inf or a NaN whose payload TF32 keeps (any
// other NaN gives lo = NaN).
__device__ __forceinline__ uint32_t tf32_lo(uint32_t v) {
  const uint32_t hi = v & 0xffffe000u;
  const float r = __uint_as_float(v) - __uint_as_float(hi);
  return hi == v ? 0u : __float_as_uint(r) & 0xffffe000u;
}

// A weight's one-pass TF32 value: w rounded to nearest (its error is half
// of truncation's and unbiased), truncated where rounding would overflow
// (|w| >= 0x7f7ff000) and for NaN.
__device__ __forceinline__ float tf32_round_w(float w) {
  const uint32_t v = __float_as_uint(w);
  return __uint_as_float((v & 0x7fffffffu) >= 0x7f7ff000u ? v & 0xffffe000u
                                                          : tf32_rna(v));
}

// A weight's split: hi = w truncated to TF32 (NaN kept), lo = rna TF32 of
// the rest, which never has hi's opposite sign; a lo of 0 for a non-zero
// finite w becomes hi 2^-30, so that an infinite x meets w as two infinities
// of one sign.  0 for +-inf (an infinite weight is outside the contract).
__device__ __forceinline__ void tf32_split_w(float w, float& hi, float& lo) {
  const uint32_t v = __float_as_uint(w), a = v & 0x7fffffffu;
  hi = __uint_as_float(a > 0x7f800000u ? 0x7fffe000u : v & 0xffffe000u);
  uint32_t l = a >= 0x7f800000u ? 0u : tf32_rna(__float_as_uint(w - hi));
  if (l == 0u && a != 0u && a < 0x7f800000u)
    l = __float_as_uint(hi * 0x1p-30f);  // a TF32 value scaled by 2^-30
  lo = __uint_as_float(l);
}

// Unit i of a walk of `splits` K splits a tile (split fastest): tile t,
// split sp, and its stages [k0, k1) (3 a slice, the run of slices
// [sp slices / splits, (sp + 1) slices / splits)).  Without kSplit, unit
// i is tile i with all its stages, in constants the compiler folds.
template <bool kSplit>
struct SplitUnit {
  long long t;
  int sp, k0, k1;
  __device__ __forceinline__ SplitUnit(long long i, int splits, int slices) {
    if constexpr (kSplit) {
      t = i / splits;
      sp = (int)(i - t * splits);
      k0 = 3 * (sp * slices / splits);
      k1 = 3 * ((sp + 1) * slices / splits);
    } else {
      t = i;
      sp = 0;
      k0 = 0;
      k1 = 3 * slices;
    }
  }
};

// Whether `v` is non-zero in any of a warpgroup's 128 threads, as a
// barrier of them (named barrier `id`): bar.red.or.
__device__ __forceinline__ bool bar_any_wg(int id, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred q, p;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 128, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(id)
      : "memory");
  return r != 0;
}

// Split K (csrc/conv3x3.cu's header, "Split K"): a warpgroup's (wg,
// thread wtid) sums `acc` of split `sp` of tile t go to its slot of the
// workspace `part`, in
// 16-byte vectors in register order (vector i of thread wtid at i 128 +
// wtid); the half tile's counter cnt[2 t + wg] counts the warpgroup in.
// The last of the `splits` to count in gets true, with acc the sum of
// every split's slot in split order; the others get false (their sums are
// in the workspace).  Non-finite sums pass through unchanged.
template <int R, int E>
__device__ __forceinline__ bool split_sum(float (&acc)[R][E],
                                          float* __restrict__ part,
                                          int* __restrict__ cnt, long long t,
                                          int wg, int sp, int splits,
                                          int wtid) {
  static_assert(E % 4 == 0, "16-byte vectors");
  constexpr int V = R * E / 4;  // vectors a thread
  const long long q = 2 * t + wg;  // the half tile
  float4* slot0 = reinterpret_cast<float4*>(part) + q * splits * (V * 128LL)
                  + wtid;
  float4* mine = slot0 + (long long)sp * (V * 128);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E / 4; ++e)
      __stcg(mine + (r * (E / 4) + e) * 128,
             make_float4(acc[r][4 * e], acc[r][4 * e + 1], acc[r][4 * e + 2],
                         acc[r][4 * e + 3]));
  __threadfence();  // the partial, before the count that announces it
  bar_sync_wg(1 + wg);
  bool last = false;
  if (wtid == 0) last = atomicAdd(cnt + q, 1) == splits - 1;
  if (!bar_any_wg(4 + wg, last)) return false;
  __threadfence();  // the count, before the reads of the others' partials
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E / 4; ++e) {
      const float4 v = __ldcg(slot0 + (r * (E / 4) + e) * 128);
      acc[r][4 * e] = v.x;
      acc[r][4 * e + 1] = v.y;
      acc[r][4 * e + 2] = v.z;
      acc[r][4 * e + 3] = v.w;
    }
  for (int k = 1; k < splits; ++k) {
    const float4* src = slot0 + (long long)k * (V * 128);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < E / 4; ++e) {
        const float4 v = __ldcg(src + (r * (E / 4) + e) * 128);
        acc[r][4 * e] += v.x;
        acc[r][4 * e + 1] += v.y;
        acc[r][4 * e + 2] += v.z;
        acc[r][4 * e + 3] += v.w;
      }
  }
  return true;
}

// The split workspace after the weights' scratch (`wfloats` floats of
// ws): the partials of `tiles` x `splits` units of `tile` floats each,
// then 2 counters a tile (split_sum); none where splits = 1.  Refuses
// splits outside [1, slices].
struct SplitSpace {
  float* part = nullptr;
  int* cnt = nullptr;
  long long ncnt = 0;
};

cudaError_t split_space(void* ws, long long wfloats, long long tiles,
                        int splits, int slices, long long tile,
                        SplitSpace* out) {
  if (splits < 1 || splits > slices) return cudaErrorInvalidValue;
  if (splits == 1) return cudaSuccess;
  out->part = static_cast<float*>(ws) + wfloats;
  out->cnt = reinterpret_cast<int*>(out->part + tiles * splits * tile);
  out->ncnt = 2 * tiles;
  return cudaSuccess;
}

}  // namespace
