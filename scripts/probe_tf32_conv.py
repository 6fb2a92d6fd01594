#!/usr/bin/env python3
"""What the split-TF32 conv kernel (fp32, ``csrc/conv3x3.cu``
conv3x3_tf32x3_kernel) costs on an NVIDIA H100, against the design it was
chosen over.

    python3 scripts/probe_tf32_conv.py

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  fp32,
device time from CUDA events over back-to-back calls queued behind a sleep
kernel (``chip_smoke.time_ms``), at [16,640,640,64] -> 64 (row 3j of
PERF.md section 6):

1. the kernel as the wrapper plans it (``kernels/conv3x3.py:
   tf32x3_plan``), checked against its plain version, beside one
   ``F.conv2d`` with bias (channels_last) with TF32 off (the JAX package's
   HIGHEST: the same function) and on (one TF32 pass: not the same
   function, for scale), and the bounds: three TF32 passes at 495 TFLOP/s,
   fp32 FMAs at 67 TFLOP/s, bytes at 3.35 TB/s; its max |error| and
   ``F.conv2d``'s against a float64 conv of the same inputs (two frames);
2. every tile width (16, 32, 64, 128 columns) and K slice (8, 16) the
   kernel takes, through ``rr_conv3x3`` directly;
3. variants of ``csrc/conv3x3.cu``, each built from the committed source
   with its edits into ``rerevst_torch/_build/probe/``:
   ``a_from_registers`` (the rejected design: each warp loads its tap
   fragments with ldmatrix, splits them in registers and issues register-A
   wgmmas; checked against the plain version too), ``no_split`` (the
   consumers' lo pass skipped, the barrier kept), ``loads_only`` (no
   wgmma: the loads, the lo pass, the barriers and the stores remain),
   ``no_a_load`` and
   ``no_b_load`` (the producer skips the box of x, or the six weight
   boxes, of every stage: what staging each costs) and ``no_store`` (the
   epilogue skipped);
4. ``one_pass``, with ``--parent``: the split-TF32 kernel's own one-pass
   instance (``passes`` = 1, x w with both rounded, pixels as wgmma's A, N
   = 64; the old orientation of row 3k) through the parent tree's
   ``rr_conv3x3`` directly (``R`` = 0): what two more passes cost;
5. the one-pass design (``conv3x3_tf32x1_kernel``, row 3k: the weights as
   wgmma's A over 128 or 256 pixels as N) as the wrapper plans it
   (``tf32x1_plan``), checked against its plain version, beside
   ``F.conv2d`` with cuDNN's TF32 on; each of its tile shapes (MB x NPX of
   ``TF32X1_SHAPES`` the shape allows) x tile width through
   ``rr_conv3x3`` directly; and its variants: ``x1_no_round`` (no
   rounding, the fence and barrier kept: what the rounding still costs),
   ``x1_loads_only`` (no wgmma), ``x1_no_store`` (the epilogue skipped),
   ``x1_lockstep`` (the two warpgroups round half the box each and meet at
   the 256-thread barrier, as the old orientation did: what rounding each
   warpgroup's own rows buys), ``x1_no_fence`` (the proxy fence after the
   rounding dropped: what it costs; its results are not checked) and
   ``x1_wait2`` (two groups of wgmmas in flight a warpgroup, checked).

``--variants a,b,...`` builds and times only those variants (default:
every one); ``--shape B,H,W,C,O`` (O > 32) another shape for parts 4 and
5.

``--parent DIR`` names the root of an unpacked ``git archive`` of a commit
whose ``csrc/conv3x3.cu`` still has the split-TF32 kernel's one-pass and
N <= 32 instances (a commit before the rows design took O <= 32); its
``conv3x3.cu`` is built into ``rerevst_torch/_build/probe/parent*``.
``--small-o --parent DIR`` times, instead of the parts above, that tree's
instance at N = O rounded up to 8, 16 or 32 at each of SMALL_O_SHAPES and
pass count, and its variants ``PARENT_VARIANTS`` (edits of that tree's
``conv3x3.cu``), beside this tree's route and one ``F.conv2d``.
``--split-units --parent DIR`` times, instead, the one-pass design at
SPLIT_UNIT_SHAPES (its split instances at MB = 1 and 2, and an unsplit
one) through this tree's wrapper and through that tree's build of the
same plan, in turns (parent, tree, tree, parent), each checked against
the plain version and compared bit for bit.

Prints the card's name and power limit and one JSON line; the same lands in
``chiprun_out/probe_tf32_conv.json``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPE, O = (16, 640, 640, 64), 64

#: The rejected design: A from registers.  Each consumer warp loads its
#: 16 x 8 fragment of each tap's operand from the swizzled box with one
#: ldmatrix (an 8 x 8 b16 matrix is 8 rows of four fp32 values: the m16n8k8
#: TF32 A layout), splits it in registers (three times a stage per value:
#: once per tap), and issues three register-A wgmmas; each tap has a
#: register set of its own, refilled once wgmma.wait_group 2 says its
#: readers are done.  A stage holds no lo box.
RS_TAP = r'''
#define RR_TF32_RS(NS, ACC, D, IA, ID, IO, IS)                            \
  asm volatile("{\n.reg .pred p;\n.reg .b64 dd;\n"                         \
               "setp.ne.b32 p, %" IS ", 0;\nadd.s64 dd, %" ID ", %" IO ";\n" \
               "wgmma.mma_async.sync.aligned.m64n" NS "k8.f32.tf32.tf32 "  \
               "{" ACC "}, {" IA "}, dd, p, 1, 1;\n}\n"                     \
               : D                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),   \
                 "n"(Off), "r"(1))

template <int N, int Off>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 8)
    RR_TF32_RS("8", RR_ACC4, RR_D4(0), "%4, %5, %6, %7", "8", "9", "10");
  else if constexpr (N == 16)
    RR_TF32_RS("16", RR_ACC8, RR_D8(0), "%8, %9, %10, %11", "12", "13", "14");
  else if constexpr (N == 32)
    RR_TF32_RS("32", RR_ACC16, RR_D16(0), "%16, %17, %18, %19", "20", "21",
               "22");
  else
    RR_TF32_RS("64", RR_ACC32, RR_D32(0), "%32, %33, %34, %35", "36", "37",
               "38");
}

template <int KK>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[KK][2][4]) {
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][m][i])::"memory");
}

template <int N, int KS, int DY>
__device__ __forceinline__ void tf32x3_tap(float (&acc)[2][N / 2],
                                           uint32_t (&xh)[KS / 8][2][4],
                                           uint32_t (&xl)[KS / 8][2][4],
                                           uint32_t a, uint64_t db, int cols,
                                           int lrow, int lchunk,
                                           uint32_t release, int lane) {
  using P = Tf32<N, KS>;
  wgmma_wait<2>();
  fence_frags(xh);
  fence_frags(xl);
  if (DY == 2 && release != 0u) {
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(release);
  }
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int q = DY * cols + lrow + 64 * m, c = 2 * kk + lchunk;
      const int sw = (q * P::kS >> 7) & (P::kS / 16 - 1);
      uint32_t v[4];
      ldsm_x4(v, a + q * P::kS + ((c ^ sw) << 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xh[kk][m][i] = v[i] & 0xffffe000u;
        xl[kk][m][i] = tf32_lo(v[i]);
      }
    }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      constexpr int hi = DY * P::kBBox / 16, lo = (3 + DY) * P::kBBox / 16;
      const uint64_t dk = db + 2 * kk;
      wgmma_tf32<N, hi>(acc[m], xh[kk][m], dk);
      wgmma_tf32<N, lo>(acc[m], xh[kk][m], dk);
      wgmma_tf32<N, hi>(acc[m], xl[kk][m], dk);
    }
  wgmma_commit();
}

// xmap: x as [B][H][W][Cp] fp32'''

SS_STAGE = '''      {
        uint4* xv = reinterpret_cast<uint4*>(base + (a - ring));
        uint4* lv = reinterpret_cast<uint4*>(base + (a - ring) + a_slot);
        for (int i = tid; i < box_bytes / 16; i += kConsumerThreads) {
          const uint4 v = xv[i];
          lv[i] = make_uint4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z),
                             tf32_lo(v.w));
        }
        fence_async_shared();  // the generic writes, before wgmma reads them
        bar_sync_consumers();
      }
      const uint64_t da = wgmma_desc<P::kS>(a + wg * 128 * P::kS);
      const uint64_t db = wgmma_desc<P::kS>(a + P::kABoxes * a_slot);
      fence_regs(acc);
      fence_regs(cor);
      wgmma_fence();
      tf32x3_stage<N, KS>(acc, cor, da, db, drow, dlo);
      wgmma_commit();
      if (k > k0) {
        // The previous stage's group is done: it may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(cor);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
'''

RS_STAGE = '''      const uint64_t db = wgmma_desc<P::kS>(a + a_slot);
      const uint32_t rel = k > k0 ? empty + 8 * prev : 0u;
      tf32x3_tap<N, KS, 0>(acc, xh[0], xl[0], a, db, cols, lrow, lchunk, 0u,
                           lane);
      tf32x3_tap<N, KS, 1>(acc, xh[1], xl[1], a, db, cols, lrow, lchunk, 0u,
                           lane);
      tf32x3_tap<N, KS, 2>(acc, xh[2], xl[2], a, db, cols, lrow, lchunk, rel,
                           lane);
      if (k == k1 - 1) fence_async_shared();  // before the last release
'''

RS_DECLS = '''  float acc[2][N / 2], cor[2][N / 2];
  uint32_t xh[3][KS / 8][2][4], xl[3][KS / 8][2][4];
  const int lrow = 128 * wg + ((tid >> 5) & 3) * 16 + (lane & 7) +
                   8 * ((lane >> 3) & 1);
  const int lchunk = lane >> 4;
'''

PRODUCER = '''          tma_load_4d(a, &xmap, full + 8 * s, sl * KS, u.x0 + dx - 1,
                      u.y0 - 1, u.b);
#pragma unroll
          for (int p = 0; p < P::kPlanes; ++p)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              tma_load_3d(a + P::kABoxes * a_slot + (3 * p + dy) * P::kBBox,
'''

WGMMAS = '''        wgmma_ss<float, N>(acc[m], ah, bh, 1);
        wgmma_ss<float, N>(cor[m], ah, bl, 1);
        wgmma_ss<float, N>(cor[m], ah + dlo, bh, 1);
'''

SPLIT = '''          lv[i] = make_uint4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z),
                             tf32_lo(v.w));
'''

#: The one-pass design's rounding, fence and warpgroup barrier a stage.
X1_ROUND = '''      round_box_x(reinterpret_cast<uint4*>(base + (a - ring)), r0, r1, wtid);
      fence_async_shared();  // the generic writes, before wgmma reads them
      bar_sync_wg(1 + wg);
'''

#: The one-pass design with two groups of wgmmas in flight a warpgroup (a
#: stage is released two stages after its products were issued).
X1_WAIT2 = [
    ("    int prev = 0;\n    for (int k = k0; k < k1; ++k) {\n"
     "      mbar_wait(full + 8 * s, ph);\n"
     "      const uint32_t a = ring + s * stage_bytes;\n"
     "      // Round the box pixels this warpgroup's taps read",
     "    int prev = 0, prev2 = 0;\n    for (int k = k0; k < k1; ++k) {\n"
     "      mbar_wait(full + 8 * s, ph);\n"
     "      const uint32_t a = ring + s * stage_bytes;\n"
     "      // Round the box pixels this warpgroup's taps read"),
    ('''      tf32x1_stage<MB, NPX, KS>(acc, da, db, drow);
      wgmma_commit();
      if constexpr (kSplit && MB == 1) {
        // This stage's group done, before the loop's back edge: with a
        // group in flight across it, ptxas serialized these instances'
        // wgmmas (note C7515: non-wgmma instructions defining the
        // accumulators within a pipeline stage), as it did the rows
        // kernel's split instances.
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      } else if (k > k0) {
        // The previous stage's group is done: it may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
''', '''      tf32x1_stage<MB, NPX, KS>(acc, da, db, drow);
      wgmma_commit();
      if (k > k0 + 1) {
        wgmma_wait<2>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev2);
      }
      prev2 = prev;
      prev = s;
'''),
    ('''    if (!(kSplit && MB == 1) && lane == 0) mbar_arrive(empty + 8 * prev);
    if constexpr (kSplit) {
      if (!split_sum(acc, part, cnt, q.t, wg, q.sp, splits, wtid))''',
     '''    if (lane == 0 && k1 - k0 > 1) mbar_arrive(empty + 8 * prev2);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    if constexpr (kSplit) {
      if (!split_sum(acc, part, cnt, q.t, wg, q.sp, splits, wtid))'''),
]

#: name -> [(old, new), ...]: edits of csrc/conv3x3.cu.
VARIANTS = {
    "a_from_registers": [
        ("\n// xmap: x as [B][H][W][Cp] fp32", RS_TAP),
        ("  static constexpr int kABoxes = 2;  // x and its lo",
         "  static constexpr int kABoxes = 1;  // x; its lo stays in registers"),
        ("  float acc[2][N / 2], cor[2][N / 2];\n", RS_DECLS),
        (SS_STAGE, RS_STAGE),
    ],
    "no_split": [(SPLIT, "          (void)v;\n")],
    "loads_only": [(WGMMAS, "")],
    "no_a_load": [
        ("      const uint32_t tx = box_bytes + P::kBTx;",
         "      const uint32_t tx = P::kBTx;"),
        (PRODUCER, PRODUCER.replace("          tma_load_4d(",
                                    "          if (k < 0) tma_load_4d("))],
    "no_b_load": [
        ("      const uint32_t tx = box_bytes + P::kBTx;",
         "      const uint32_t tx = box_bytes;"),
        (PRODUCER, PRODUCER.replace("              tma_load_3d(",
                                    "              if (k < 0) tma_load_3d("))],
    "no_store": [
        ("    // The epilogue: accumulator pairs (columns 8 j + 2 (lane % 4), + 1) of",
         "    if (O >= 0) continue;\n"
         "    // The epilogue: accumulator pairs (columns 8 j + 2 (lane % 4), + 1) of")],
    # The one-pass design (conv3x3_tf32x1_kernel).
    "x1_no_round": [(X1_ROUND, X1_ROUND.replace(
        "      round_box_x(", "      if (O < 0) round_box_x("))],
    "x1_loads_only": [("      tf32x1_stage<MB, NPX, KS>(acc, da, db, drow);\n",
                       "")],
    "x1_no_store": [
        ("    // The epilogue.  The sums lie [channel][pixel] (thread: channels orow,",
         "    if (O >= 0) continue;\n"
         "    // The epilogue.  The sums lie [channel][pixel] (thread: channels orow,")],
    "x1_no_fence": [(X1_ROUND, X1_ROUND.replace(
        "      fence_async_shared();  // the generic writes, before wgmma reads "
        "them\n", ""))],
    "x1_wait2": X1_WAIT2,
    "x1_lockstep": [(X1_ROUND, '''      round_box_x(reinterpret_cast<uint4*>(base + (a - ring)),
                  wg * (box_bytes / 32), (wg + 1) * (box_bytes / 32), wtid);
      fence_async_shared();
      bar_sync_consumers();
''')],
}


#: The parent tree's split-TF32 kernel (``--small-o``): its one-pass
#: rounding of the box in place, its lo pass and its products, as they
#: read in its ``conv3x3.cu``.
PARENT_ROUND = '''            xv[i] = make_uint4(tf32_round_x(v.x), tf32_round_x(v.y),
                               tf32_round_x(v.z), tf32_round_x(v.w));
'''
PARENT_SPLIT = '''            lv[i] = make_uint4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z),
                               tf32_lo(v.w));
'''
PARENT_WGMMAS = '''        wgmma_ss<float, N>(acc[m], ah, bh, 1);
        if constexpr (NP == 3) {
          const uint64_t bl = bh + 3 * (P::kBBox / 16);
          wgmma_ss<float, N>(cor[m], ah, bl, 1);
          wgmma_ss<float, N>(cor[m], ah + dlo, bh, 1);
        }
'''

#: name -> [(old, new), ...]: edits of the parent tree's conv3x3.cu
#: (``--small-o``; ``as_is``: none): ``no_split`` (the lo pass skipped),
#: ``no_round`` (the one-pass rounding skipped), ``loads_only`` (no
#: wgmma), and ``no_a_load``, ``no_b_load`` and ``no_store`` as above.
PARENT_VARIANTS = {
    "as_is": [],
    "no_split": [(PARENT_SPLIT, "            (void)v;\n")],
    "no_round": [(PARENT_ROUND, "            (void)v;\n")],
    "loads_only": [(PARENT_WGMMAS, "")],
    "no_a_load": VARIANTS["no_a_load"],
    "no_b_load": VARIANTS["no_b_load"],
    "no_store": VARIANTS["no_store"],
}


def build_variant(build, name: str, edits, src_dir=None) -> ctypes.CDLL:
    """The kernel library with `edits` of conv3x3.cu, the tree's or, with
    `src_dir`, that directory's (and its headers)."""
    src_dir = Path(src_dir or build.SRC_DIR)
    d = build.BUILD_DIR / "probe" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (src_dir / "conv3x3.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: an edit does not match conv3x3.cu")
        src = src.replace(old, new)
    (d / "conv3x3.cu").write_text(src)
    for header in src_dir.glob("*.cuh"):
        shutil.copy(header, d)
    so = d / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(d / "conv3x3.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rr_conv3x3.argtypes = build.SIGNATURES["rr_conv3x3"]
    lib.rr_conv3x3.restype = ctypes.c_int
    return lib


#: The O <= 32 shapes of an fp32 Pass-2 batch (``--small-o``): the filter
#: blocks' `down` conv and the decoder's `out` conv.
SMALL_O_SHAPES = ((16, 80, 80, 512, 32), (16, 640, 640, 64, 3))


def parent_plan(shp, sms):
    """The plan the parent tree's wrapper gave its split-TF32 instance at
    shp = (B, H, W, C, O), O <= 32 (its ``tf32x3_plan``): 256-pixel tiles
    of the widest fit, N = O rounded up to 8, 16 or 32, unsplit, one block
    an SM.  Only where the tiles outnumber the SMs: the parent split K
    below that, by a reckoning this tree no longer holds."""
    from rerevst_torch.kernels.conv3x3 import (
        SLICED_COLS,
        SLICED_M,
        SlicedPlan,
        out_tile,
        tf32_slice_width,
        wide_cols,
    )

    plan = SlicedPlan(*shp[:3], shp[4],
                      wide_cols(*shp[1:3], SLICED_M, SLICED_COLS),
                      out_tile(shp[4]), 1, shp[3], tf32_slice_width(shp[3]))
    if plan.tiles < sms:
        raise RuntimeError(f"{shp}: fewer tiles than SMs (the parent split "
                           f"K there)")
    return dataclasses.replace(plan, grid=sms)


def small_o(torch, cs, parent, sms, gen) -> int:
    """``--small-o``: at each of SMALL_O_SHAPES and pass count, the parent
    tree's split-TF32 instance at N = O rounded up to 8, 16 or 32 (``R`` =
    0, as the parent's wrapper launched every O <= 32 call; its plan
    unsplit, as the parent planned these shapes, whose tiles outnumber the
    SMs) and its variants (`parent`: variant -> library, ``as_is`` the
    unedited one), beside this tree's route and one ``F.conv2d`` with
    cuDNN's TF32 on (one pass) or off (three)."""
    import torch.nn.functional as F

    from rerevst_torch.kernels import conv3x3_implicit_gemm
    from rerevst_torch.kernels.conv3x3 import design, plan_for

    rows = []
    for shp in SMALL_O_SHAPES:
        x, w, b = cs.conv_inputs(torch, shp[:4], shp[4], torch.float32, gen)
        y = torch.empty(shp[:3] + (shp[4],), device="cuda")
        ws = torch.empty(18 * shp[4] * (-(-shp[3] // 4) * 4), device="cuda")
        old = parent_plan(shp, sms)
        for passes in (1, 3):

            def direct(vlib, old=old, passes=passes, x=x, w=w, b=b, y=y,
                       ws=ws):
                err = vlib.rr_conv3x3(
                    1, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    y.data_ptr(), ws.data_ptr(), *x.shape, w.shape[-1], 0,
                    old.cols, old.n, old.ks, old.grid, old.splits, passes,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"rr_conv3x3: error {err}")

            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = passes == 1
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_ms = cs.time_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1),
                                iters=10)["ms"]
            torch.backends.cudnn.allow_tf32 = tf32
            plan = plan_for(x, shp[4], passes)
            row = {"shape": list(shp), "passes": passes,
                   "old_plan": {"cols": old.cols, "rows": old.rows,
                                "n": old.n, "ks": old.ks, "grid": old.grid,
                                "splits": old.splits},
                   "design": design(shp[3], torch.float32, shp[4], passes),
                   "plan": type(plan).__name__,
                   "ms": cs.time_ms(torch, lambda: conv3x3_implicit_gemm(
                       x, w, b, passes=passes), iters=10)["ms"],
                   "old_ms": cs.time_ms(torch, lambda: direct(
                       parent["as_is"]), iters=10)["ms"],
                   "cudnn_ms": lib_ms}
            for name, vlib in parent.items():
                if name != "as_is":
                    row[name + "_ms"] = cs.time_ms(
                        torch, lambda: direct(vlib), iters=10)["ms"]
            rows.append(row)
            print(json.dumps({"probe": "small_o", **row}), flush=True)
        del x, w, b, y, ws
    out = {"card": cs.nvidia_smi(), "small_o": rows}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_tf32_small_o.json").write_text(json.dumps(out, indent=1))
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0


#: ``--split-units``: one-pass shapes whose plans split K at MB = 1 (NPX
#: 256 and 128), at MB = 2, and one unsplit MB = 1 plan.
SPLIT_UNIT_SHAPES = ((4, 64, 64, 512, 64), (4, 32, 32, 512, 64),
                     (4, 32, 32, 512, 256), (4, 32, 32, 256, 512))


def split_units(torch, cs, parent, sms, gen) -> int:
    """``--split-units``: the one-pass design's plan at each of
    SPLIT_UNIT_SHAPES through this tree's wrapper and through `parent`'s
    ``rr_conv3x3`` (the parent tree's build), in turns."""
    from rerevst_torch.kernels import (
        conv3x3_implicit_gemm,
        conv3x3_implicit_gemm_plain,
    )
    from rerevst_torch.kernels.conv3x3 import tf32x1_plan

    stream = torch.cuda.current_stream().cuda_stream
    rows, ok = [], True
    for shp in SPLIT_UNIT_SHAPES:
        x, w, b = cs.conv_inputs(torch, shp[:4], shp[4], torch.float32, gen)
        p = tf32x1_plan(*shp, sms)
        y = torch.empty(shp[:3] + (shp[4],), device="cuda")
        ws = torch.empty(9 * shp[4] * shp[3] + p.workspace_bytes // 4,
                         device="cuda")

        def old(p=p, x=x, w=w, b=b, y=y, ws=ws):
            err = parent.rr_conv3x3(
                1, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                ws.data_ptr(), *x.shape, w.shape[-1], p.npx, p.cols, p.n,
                p.ks, p.grid, p.splits, 1, stream)
            if err:
                raise RuntimeError(f"rr_conv3x3: error {err}")

        def new(x=x, w=w, b=b):
            return conv3x3_implicit_gemm(x, w, b, passes=1)

        old()
        got = new()
        torch.cuda.synchronize()
        row = {"shape": list(shp), "mb": p.mb, "npx": p.npx,
               "splits": p.splits,
               "ok": cs.conv_within_tolerance(
                   torch, got, conv3x3_implicit_gemm_plain(x, w, b), x, w,
                   b, passes=1),
               "equal_bits_to_parent": bool(torch.equal(got, y))}
        for key, fn in (("parent_ms", old), ("ms", new), ("ms_2", new),
                        ("parent_ms_2", old)):
            row[key] = cs.time_ms(torch, fn, iters=20)["ms"]
        ok = ok and row["ok"]
        rows.append(row)
        print(json.dumps({"probe": "split_units", **row}), flush=True)
        del x, w, b, y, ws, got
    out = {"card": cs.nvidia_smi(), "split_units": rows}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_tf32_split_units.json").write_text(
        json.dumps(out, indent=1))
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None)
    ap.add_argument("--shape", default=None,
                    help="B,H,W,C,O (O > 32) for the one-pass parts (4 and "
                         "5)")
    ap.add_argument("--parent", default=None,
                    help="root of a tree whose conv3x3.cu has the "
                         "split-TF32 kernel's one-pass and N <= 32 "
                         "instances (part 4, --small-o)")
    ap.add_argument("--small-o", action="store_true",
                    help="the parent's O <= 32 instances at both pass "
                         "counts instead (needs --parent)")
    ap.add_argument("--split-units", action="store_true",
                    help="the one-pass design's split instances against "
                         "the parent's instead (needs --parent)")
    args = ap.parse_args()
    if (args.small_o or args.split_units) and args.parent is None:
        print("probe_tf32_conv: --small-o and --split-units need --parent",
              file=sys.stderr)
        return 2
    if args.split_units:
        args.variants = ""
    known = PARENT_VARIANTS if args.small_o else VARIANTS
    names = list(known) if args.variants is None \
        else [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(known)
    if unknown:
        print(f"probe_tf32_conv: unknown variants {sorted(unknown)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_tf32_conv: CUDA is not available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from rerevst_torch.kernels import (
        _build,
        conv3x3_implicit_gemm,
        conv3x3_implicit_gemm_plain,
    )
    from rerevst_torch.kernels.conv3x3 import (
        SLICED_COLS,
        TF32X1_SHAPES,
        Tf32x1Plan,
        tf32x1_plan,
        tf32x3_plan,
    )

    parent_src = None if args.parent is None \
        else Path(args.parent).resolve() / "rerevst_torch" / "csrc"
    with ThreadPoolExecutor(len(names) + 2) as pool:  # nvcc at once
        lib = pool.submit(_build.library)
        if args.small_o:
            built = {name: pool.submit(build_variant, _build,
                                       "parent_" + name,
                                       PARENT_VARIANTS[name], parent_src)
                     for name in set(names) | {"as_is"}}
        else:
            built = {name: pool.submit(build_variant, _build, name,
                                       VARIANTS[name]) for name in names}
            if parent_src is not None:
                built["parent"] = pool.submit(build_variant, _build,
                                              "parent_as_is", [], parent_src)
        variants = {name: f.result() for name, f in built.items()}
        lib = lib.result()
    parent = variants.pop("parent", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    if args.small_o:
        return small_o(torch, cs, variants, sms, gen)
    if args.split_units:
        return split_units(torch, cs, parent, sms, gen)
    x, w, b = cs.conv_inputs(torch, SHAPE, O, torch.float32, gen)
    y = torch.empty(SHAPE[:3] + (O,), device="cuda")
    ws = torch.empty(18 * O * SHAPE[-1], device="cuda")
    plan = tf32x3_plan(*SHAPE, O, sms)

    def direct(cols, ks, lib=lib, passes=3, x=x, w=w, b=b, y=y, npx=0,
               n=plan.n, grid=plan.grid):
        bb, h, wd, c = x.shape
        err = lib.rr_conv3x3(1, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), ws.data_ptr(), bb, h, wd, c,
                             w.shape[-1], npx, cols, n, ks, grid, 1, passes,
                             torch.cuda.current_stream().cuda_stream)
        _build.check(err, "rr_conv3x3")

    out = {"card": cs.nvidia_smi(), "shape": SHAPE, "O": O}
    if any(not n.startswith("x1_") for n in names) or not names:
        # The three-pass parts, at row 3j's shape.
        got = conv3x3_implicit_gemm(x, w, b)
        want = conv3x3_implicit_gemm_plain(x, w, b)
        ok = cs.conv_within_tolerance(torch, got, want, x, w, b)
        del got, want
        # Errors against float64 on two frames, the kernel's and cuDNN's.
        xd, wd_ = x[:2].double(), w.double()
        ref = F.conv2d(xd.permute(0, 3, 1, 2), wd_.permute(3, 2, 0, 1),
                       b.double(), padding=1).permute(0, 2, 3, 1)
        kern_err = (conv3x3_implicit_gemm(x[:2].contiguous(), w, b).double()
                    - ref).abs().max().item()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        lib_err = (F.conv2d(x[:2].permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                            b, padding=1).permute(0, 2, 3, 1).double()
                   - ref).abs().max().item()
        scale = F.conv2d(xd.abs().permute(0, 3, 1, 2),
                         wd_.abs().permute(3, 2, 0, 1), b.double().abs(),
                         padding=1)
        bar = (9 * SHAPE[-1] * 2.0 ** -22 * scale).min().item()
        del xd, wd_, ref, scale
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_ms = cs.time_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1),
                            iters=10)["ms"]
        torch.backends.cudnn.allow_tf32 = tf32
        m = x.numel() // SHAPE[-1]
        flops = 2 * m * 9 * SHAPE[-1] * O
        out.update({
            "ok": ok, "plan": {"cols": plan.cols, "rows": plan.rows,
                               "n": plan.n, "ks": plan.ks, "grid": plan.grid},
            "ms": cs.time_ms(torch, lambda: conv3x3_implicit_gemm(x, w, b),
                             iters=10)["ms"],
            "library_ms_tf32_off": lib_ms,
            "bound_tf32x3_ms": 3 * flops / cs.TF32_FLOP_PER_S * 1e3,
            "bound_fp32_cores_ms": flops / cs.FP32_FLOP_PER_S * 1e3,
            "bound_bytes_ms": (x.numel() + w.numel() + O + m * O) * 4
            / cs.HBM_BYTES_PER_S * 1e3,
            "max_abs_err_vs_f64": kern_err,
            "library_max_abs_err_vs_f64": lib_err,
            "least_bar_9c_2m22_sum_abs": bar})
        sweep = {}
        for cols in (16, 32, 64, 128):
            for ks in (8, 16):
                sweep[f"cols={cols},ks={ks}"] = cs.time_ms(
                    torch, lambda: direct(cols, ks), iters=10)["ms"]
        out["sweep_ms"] = sweep
    else:
        ok = True

    # The one-pass parts, at --shape or row 3k's.
    shp = tuple(int(v) for v in args.shape.split(",")) if args.shape \
        else SHAPE + (O,)
    if shp[4] <= 32:
        print(f"probe_tf32_conv: {shp} takes the rows design, no one-pass "
              f"design (scripts/probe_rows_conv.py)", file=sys.stderr)
        return 2
    x3, w3, b3, y3 = x, w, b, y  # row 3j's inputs (the three-pass parts)
    if shp != SHAPE + (O,):
        x, w, b = cs.conv_inputs(torch, shp[:4], shp[4], torch.float32, gen)
        y = torch.empty(shp[:3] + (shp[4],), device="cuda")
    ws = torch.empty(9 * shp[4] * (-(-shp[3] // 4) * 4), device="cuda")
    old = tf32x3_plan(*shp, sms)  # the split-TF32 walk's plan at N = 64
    x1 = tf32x1_plan(*shp, sms)
    got = conv3x3_implicit_gemm(x, w, b, passes=1)
    want = conv3x3_implicit_gemm_plain(x, w, b)
    x1_ok = cs.conv_within_tolerance(torch, got, want, x, w, b, passes=1)
    del got, want
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_tf32_ms = cs.time_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1),
                             iters=10)["ms"]
    torch.backends.cudnn.allow_tf32 = tf32
    one = {"shape": list(shp), "ok": x1_ok, "library_ms_tf32_on": lib_tf32_ms,
           "ms": cs.time_ms(torch, lambda: conv3x3_implicit_gemm(
               x, w, b, passes=1), iters=10)["ms"]}
    if parent is not None:
        one["old_orientation_ms"] = cs.time_ms(
            torch, lambda: direct(old.cols, old.ks, parent, passes=1,
                                  n=old.n, grid=old.grid, x=x, w=w, b=b,
                                  y=y), iters=10)["ms"]
    one["plan"] = {"mb": x1.mb, "npx": x1.npx, "cols": x1.cols,
                   "rows": x1.rows, "ks": x1.ks, "grid": x1.grid,
                   "smem": list(x1.smem())}
    sweep = {}
    for mb, npx in TF32X1_SHAPES:
        if mb > 1 and shp[4] <= 64:
            continue
        for cols in SLICED_COLS:
            p = Tf32x1Plan(*shp[:3], shp[4], cols, 64 * mb, 1, shp[3],
                           x1.ks, mb, npx)
            sweep[f"mb={mb},npx={npx},cols={cols}"] = cs.time_ms(
                torch, lambda: direct(cols, x1.ks, passes=1, x=x, w=w, b=b,
                                      y=y, npx=npx, n=64 * mb,
                                      grid=min(p.tiles, sms)),
                iters=10)["ms"]
    one["sweep_ms"] = sweep
    out["one_pass"] = one
    print(json.dumps({"probe": "one_pass", **one}), flush=True)
    for name, vlib in variants.items():
        if name.startswith("x1_"):
            row = {"ms": cs.time_ms(torch, lambda: direct(
                x1.cols, x1.ks, vlib, passes=1, x=x, w=w, b=b, y=y,
                npx=x1.npx, n=x1.n, grid=x1.grid), iters=10)["ms"]}
        else:
            row = {"ms": cs.time_ms(torch, lambda: direct(
                plan.cols, plan.ks, vlib), iters=10)["ms"]}
        if name == "a_from_registers":
            direct(plan.cols, plan.ks, vlib)
            torch.cuda.synchronize()
            row["ok"] = cs.conv_within_tolerance(
                torch, y3, conv3x3_implicit_gemm_plain(x3, w3, b3), x3, w3,
                b3)
            ok = ok and row["ok"]
        if name in ("x1_lockstep", "x1_wait2"):
            direct(x1.cols, x1.ks, vlib, passes=1, x=x, w=w, b=b, y=y,
                   npx=x1.npx, n=x1.n, grid=x1.grid)
            torch.cuda.synchronize()
            row["ok"] = cs.conv_within_tolerance(
                torch, y, conv3x3_implicit_gemm_plain(x, w, b), x, w, b,
                passes=1)
            ok = ok and row["ok"]
        out[name] = row
        print(json.dumps({"probe": name, **row}), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_tf32_conv.json").write_text(json.dumps(out, indent=1))
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok and x1_ok else 1


if __name__ == "__main__":
    sys.exit(main())
