#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rerevst_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device  — the card's name, compute capability (must be 9.0) and power limit;
2. build   — compiles ``rerevst_torch/csrc/*.cu`` for sm_90a (first use),
             and reports the registers and spills of the streamed, wide
             and narrow conv kernels and the filter pair kernel (``nvcc
             -Xptxas -v``; a spill fails, and so does a serialized wgmma in
             the wide kernel);
3. check   — each kernel against its plain PyTorch version on the card, at the
             main path's shapes (batch 16, 512x512 content padded to 640x640)
             plus ragged ones and inf/NaN inputs, in f16, bf16 and fp32;
4. e2e     — ``Stylization.stylize_video`` on a seeded 33-frame 512x512 clip
             with the bundled checkpoint: the global (two-pass) default
             path in f16 and in fp32 and its pair-lane route
             (``ModelConfig(pairlane=True)``) in f16, then the same three
             sessions in per-frame mode (``use_global=False``) — shapes,
             launch counts, each low-precision session's pixel error
             against fp32; small clips held against the port's plain CPU
             path (global fp32, per-frame fp32, and per-frame under both
             ablation switches); a ``.pth`` written by the port read back
             into a session bit-equal to the ``.msgpack`` one; E_warp and
             temporal SSIM of both modes on a seeded exact-translation clip
             (exact flows, no cv2), on the card and on the CPU; then
             ``conv3x3_implicit_gemm``, which no model path runs, driven
             alone at the shapes of the JAX package's conv benchmark
             (``scripts/bench_conv3x3.py``), at VGG conv2_2 and conv1_1 and
             at C = 32, so that each of its four 16-bit designs (streamed,
             wide, narrow, cp.async) launches; every global session's Pass-2
             host prep must have gone through the native library;
   long_clip   — f16 and fp32 ``stylize_video`` of a seeded 65-frame 512x512
             clip at ``sample_interval=1``: 65 samples spill to the host
             spool and stream ('streaming-spill'); launches of the path and
             of Pass 1 alone against the count the stage plan gives, Pass 1's
             wall time, f16 against fp32, and the streamed SeqStats against
             the batched ``collect_stats`` over the same features;
   native_prep — the native host library loads; one 16-frame batch's prep,
             native and numpy, timed and compared; frames of both paths;
   multistyle  — ``MultiStylization.interpolate_video`` of the 33-frame clip
             under two seeded styles (linear sweep, batch 16: the
             per-sample route), f16 and fp32, launches counted; the card's
             fp32 against the CPU's on a 9-frame 64x112 clip; the per-sample
             kernels against their plain versions at batch 16; one decode
             on the shared and on the per-sample route;
   serve       — the HTTP service (``rerevst_torch.serve``) in f16 on the
             33-frame clip: warmup, style and Pass 1, 8 concurrent
             micro-batched /stylize calls (within 1 count of
             ``transfer_batch``), a lone call, /video over HTTP and an async
             clip session (both bit-equal to a direct ``stylize_video``),
             /styles + /interpolate (equal to ``MultiStylization``) and a
             pair-lane /video; launches per endpoint; one ``{"serve": ...}``
             line;
   train       — the trainer (``rerevst_torch.train``): eight
             ``TrainConfig()`` steps (batch 4 of 256x256 crops, fp32, every
             default loss, the 16-step relaxed loop) from the bundled
             checkpoint through ``load_pretrained`` (``vgg_loss``
             regenerated, he_relu), on seeded batches in the loader's
             format; each step's metrics (finite), ``vgg_loss`` bit-equal
             and the encoders and decoder moved, the median step ms of
             steps 2-8 (CUDA events), images/s and peak memory; one step
             each with ``remat=True`` and ``grad_accum=2`` and their peak
             memory; the card's step against the CPU's (64x64, flow_iter 2,
             an injected fake pair, deterministic algorithms: losses to
             1e-4 relative, selected gradients to 1e-3 of their max-abs);
             a checkpoint saved after step 2 and resumed into a fresh
             state, one more step on both (params to 1e-6 relative); 0
             launches of the hand-written kernels over the timed steps; a
             profile of one step (device busy share, the relaxed inner
             loop's share); the decoder's upsample conv at res3 in its
             plain and its parity-folded form, timed;
   adversarial — eight ``LossConfig(adversarial_loss=True)`` steps (batch
             4 of 256x256, fp32, flow_iter 16) from the same generator and
             a seeded PatchGAN (ndf 64, 3 layers, 'normal'): the median
             step ms, images/s, peak memory, D's share of a profiled step
             (its profiler range), the first and last loss_d and
             loss_G_GAN (finite); each gan_mode's step at 64x64 (flow_iter
             2, an injected pair, deterministic algorithms) against the
             CPU's, part by part on the same inputs: losses to 1e-4
             relative, every D gradient, G's GAN cotangent and the
             selected G gradients to 1e-3 of their max-abs, or to twice
             the largest change of the CPU's own result over four draws
             of 2^-20 relative noise at every conv output where the
             step's conditioning makes that larger, on phase train's
             check batch; a second batch's parts and whole step
             recorded, not held); G's checkpoint and
             D's ``netD-step*.msgpack`` saved after one step and restored,
             the next step's D bit-equal to the uninterrupted one (G's
             params to 1e-6 relative); 0 kernel launches;
   ablation    — a ``use_mpi`` and a ``use_video`` step at 4 x 256x256 on
             synthetic pairs made on the host (seeded frames, smooth
             whole-pixel flows, disc occlusion masks), each run twice and
             the second timed; each at 64x64
             against the CPU (the bars and the allowance above, on
             phase train's check batch; a second batch recorded); one
             U-Net forward at
             256x256 (num_downs 8, ngf 64) against the CPU, to 1e-4 of its
             max-abs, timed; 0 kernel launches;
5. times   — each kernel and its plain version at every main-path site
             (device time from CUDA events, and the host's own cost per
             call), the bound (the filter pair's products as three TF32
             passes), one ``F.conv2d`` call beside each conv as a
             yardstick, Pass-2 frames/s of the global default, global
             pair-lane and per-frame f16 paths, and torch.profiler traces
             of one f16 stylize_video (device busy vs wall clock) and of
             Pass 2 alone on those three paths (where a batch's time goes);
             ``rr_conv3x3`` at the VGG shapes conv1_1 (C = 3, the narrow
             kernel), conv2_1 (C = 64) and conv2_2, conv3_1, conv3_2 and
             conv4_1 (C >= 128, the wide kernel), and the cp.async kernel at
             C = 32, beside ``F.conv2d``;
             and (phase pipeline) the warm f16 stylize_video's wall time
             and idle share;
6. a ``{"phase": "done", "seconds": ...}`` line (the script's wall time),
   the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last
   line ``{"ok": true, "device": {...}}``.

Tolerances: a kernel agrees with its plain version to 1e-5 of the output's
scale in fp32, and within one ulp of the storage dtype in f16/bf16 (both
compute in fp32 and round once).  The 3x3 convs sum K = 9 C products in
other orders on the two sides, each within K 2^-23 of sum |x||w| (the
standard bound, doubled for the tensor cores' accumulation): they agree to
K 2^-22 sum |x||w| (+ |b|), plus one ulp of the storage dtype in f16/bf16.
End to end, global-mode f16 stays within 1e-3 mean |delta| per pixel ([0,1]
scale) of fp32, the repository's precision bar, on both routes (per-frame
mode's is recorded, not barred: the bar is the global pipeline's); the
card's fp32 frames stay within 1 count of the CPU path's in every mode and
ablation; the ``.pth`` session's frames equal the ``.msgpack`` session's;
the card's E_warp and temporal SSIM match the CPU's to 1e-4 relative; the
streamed statistics match the batched ones at rtol = atol = 2e-4 (the JAX
package's bar: the sums run in other orders); native prep matches numpy
to 1e-6; the long-clip and multi-style f16 frames stay within 1e-3 of fp32.

Needs one CUDA card and the repository beside this file; imports nothing
of JAX.  Detailed results go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
F16_FLOP_PER_S = 989e12        # H100 SXM dense f16/bf16 tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM dense TF32 tensor cores
BATCH = 16
PAD_HW = 640                   # 512x512 content, reflect-padded to 640x640
CLIP_FRAMES = 33
CONTENT = 512

#: The 11 norm sites of decode_global per Pass-2 batch: (site, C, scale
#: divisor of the padded frame, variant).
NORM_SITES = [
    ("pre", 512, 8, "identity"), ("ada4", 512, 8, "affine"),
    ("res4a", 256, 4, "leaky"), ("res4b", 256, 4, "leaky"),
    ("ada3", 256, 4, "affine"),
    ("res3a", 128, 2, "leaky"), ("res3b", 128, 2, "leaky"),
    ("ada2", 128, 2, "affine"),
    ("res2a", 64, 1, "leaky"), ("res2b", 64, 1, "leaky"),
    ("ada1", 64, 1, "affine"),
]
FILTER_SITES = 3  # filter1..3, each at [B, H/8, W/8, 32]
#: The pair-lane conv sites per Pass-2 batch: (sites, O), all at
#: [B, 640, 640, 64].
PAIRLANE_SITES = [("conv1_2, res2.conv2", 2, 64), ("out", 1, 3)]
#: The shapes of rerevst_tpu's scripts/bench_conv3x3.py, the implicit-GEMM
#: conv's only driver in the JAX package: (x shape, O).
IGEMM_BENCH = [((BATCH, PAD_HW, PAD_HW, 64), 64), ((BATCH, PAD_HW, PAD_HW, 64), 3)]
#: The VGG encoder's convs of one 16-frame batch of 640^2 that run
#: ``rr_conv3x3`` standalone: (site, x shape, O).  conv1_1 takes the narrow
#: kernel (C = 3), conv2_1 the streamed kernel (C = 64), the rest the wide
#: kernel (conv2_2 also stands for the decoder's res3.conv2, conv3_2 for
#: conv3_3, conv3_4 and res4.conv2).
VGG_CONVS = [("VGG conv1_1", (BATCH, PAD_HW, PAD_HW, 3), 64),
             ("VGG conv2_1", (BATCH, 320, 320, 64), 128),
             ("VGG conv2_2", (BATCH, 320, 320, 128), 128),
             ("VGG conv3_1", (BATCH, 160, 160, 128), 256),
             ("VGG conv3_2", (BATCH, 160, 160, 256), 256),
             ("VGG conv4_1", (BATCH, 80, 80, 256), 512)]
#: One call of the cp.async implicit GEMM (C = 32, no VGG site) at conv2_x
#: scale: it is driven and timed beside F.conv2d so that the remaining
#: igemm design keeps a launch and a yardstick.
IGEMM_C32 = ("igemm C = 32", (BATCH, 320, 320, 32), 64)
#: inf and NaN inputs of the C = 3 checks, at [2, 19, 70, 3]: (index, value).
NARROW_NONFINITE = [((0, 3, 31, 2), "inf"), ((0, 3, 32, 0), "-inf"),
                    ((0, 7, 10, 1), "nan"), ((0, 8, 40, 2), "inf"),
                    ((1, 0, 69, 2), "inf"), ((1, 18, 0, 0), "-inf"),
                    ((1, 15, 63, 1), "inf"), ((1, 16, 64, 2), "nan")]

RESULTS: dict = {"checks": [], "times": []}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    _save()
    raise SystemExit(1)


def _save() -> None:
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def within_tolerance(torch, got, want) -> bool:
    g, w = got.float(), want.float()
    if not (torch.isfinite(g) == torch.isfinite(w)).all():
        return False
    fin = torch.isfinite(w)
    g, w = g[fin], w[fin]
    if got.dtype == torch.float32:
        return bool((g - w).abs().max() <= 1e-5 * w.abs().max().clamp_min(1e-30))
    mant = {torch.float16: 10, torch.bfloat16: 7}[got.dtype]
    tiny = {torch.float16: 2.0 ** -24, torch.bfloat16: 2.0 ** -133}[got.dtype]
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                     - mant).clamp_min(tiny)
    # One ulp of the storage dtype, plus the fp32 math's own reassociation
    # error (sums of products cancel near zero).
    slack = 1e-5 * w.abs().max()
    return bool(((g - w).abs() <= ulp + slack).all())


def conv_within_tolerance(torch, got, want, x, w, b) -> bool:
    """K 2^-22 sum |x||w| (+|b|), plus one ulp of a 16-bit storage dtype."""
    from rerevst_torch.kernels import conv3x3_implicit_gemm_plain

    k = 9 * x.shape[-1]
    scale = conv3x3_implicit_gemm_plain(
        x.abs().float(), w.abs().float(), None if b is None else b.abs().float())
    tol = k * 2.0 ** -22 * scale
    del scale
    g, v = got.float(), want.float()
    if not (torch.isfinite(g) == torch.isfinite(v)).all():
        return False
    if got.dtype != torch.float32:
        mant = {torch.float16: 10, torch.bfloat16: 7}[got.dtype]
        tiny = {torch.float16: 2.0 ** -24, torch.bfloat16: 2.0 ** -133}[got.dtype]
        tol += torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30)))
                          - mant).clamp_min(tiny)
    fin = torch.isfinite(v)
    return bool(((g - v).abs()[fin] <= tol[fin]).all())


def conv_inputs(torch, shape, o, dtype, gen, bias=True):
    dev = torch.device("cuda")
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = (torch.randn((3, 3, shape[-1], o), generator=gen, device=dev)
         * (1.0 / (3 * shape[-1] ** 0.5))).to(dtype)
    b = torch.randn(o, generator=gen, device=dev).to(dtype) if bias else None
    return x, w, b


def check_convs(torch, gen, errs):
    from rerevst_torch import kernels

    p = PAD_HW
    # (x shape, O, bias).  The cases after the main-path shapes stress the
    # streamed C = 64 kernel's work split (its plan on 132 SMs): a last band
    # shorter than the rest (H % R != 0), a last strip narrower than 128
    # columns, W < 128, B = 1, and O = 128 as two channel tiles.  C = 128,
    # 256 and 512 take the wide kernel: every tile width its plan picks,
    # ragged bands and strips, B = 1, O = 5 (a zero-padded weight copy), 16,
    # 64, 192 (a half-empty tile), 256 and 512 (two 256-wide tiles).  C = 32
    # takes the cp.async implicit GEMM.  C = 1 .. 7 take the narrow kernel
    # (8 x 32 tiles): ragged last bands and strips, W narrower than a tile,
    # B = 1, O = 3 and 5 (scalar stores), 16, 64 and 128 (two channel tiles).
    igemm = [((BATCH, p, p, 64), 64, True), ((BATCH, p, p, 64), 3, True),
             ((2, 64, 64, 3), 64, True), ((2, 80, 80, 128), 128, False),
             ((2, 40, 40, 256), 512, True),
             ((3, 37, 53, 64), 64, True), ((2, 13, 7, 128), 5, False),
             ((1, 75, 300, 64), 128, True), ((1, 75, 300, 64), 128, False),
             ((1, 37, 53, 128), 64, True), ((1, 9, 33, 128), 16, True),
             ((2, 11, 9, 128), 192, True), ((1, 5, 640, 128), 128, True),
             ((2, 6, 320, 256), 256, False), ((1, 19, 150, 256), 256, True),
             ((1, 23, 45, 512), 128, False), ((2, 12, 80, 256), 512, True),
             ((1, 3, 161, 512), 512, True), ((2, 13, 7, 512), 5, True),
             ((2, 21, 19, 32), 24, True)] \
        + [((2, 13, 45, 3), 64, True), ((2, 13, 45, 3), 64, False),
           ((1, 9, 7, 1), 5, True), ((1, 37, 70, 4), 128, True),
           ((1, 37, 70, 4), 128, False), ((3, 5, 33, 7), 16, True),
           ((1, 40, 33, 3), 3, False), ((1, 21, 100, 7), 64, True),
           ((1, 8, 20, 1), 3, True), ((2, 17, 64, 4), 5, False)]
    pair = [((BATCH, p, p, 64), 64, True), ((BATCH, p, p, 64), 3, True),
            ((3, 37, 53, 64), 64, True), ((2, 19, 150, 64), 32, True),
            ((1, 131, 200, 64), 64, False), ((1, 130, 257, 64), 5, True),
            ((2, 97, 129, 64), 32, False), ((1, 37, 100, 64), 8, True),
            ((3, 5, 7, 64), 3, False), ((1, 200, 64, 64), 3, True)]
    cases = [("conv3x3_implicit_gemm", s, o, bias, False)
             for s, o, bias in igemm] \
        + [("conv3x3_pairlane", s, o, bias, False) for s, o, bias in pair] \
        + [(name, (2, 19, 150, 64), o, True, True)  # inf and NaN inputs
           for name in ("conv3x3_implicit_gemm", "conv3x3_pairlane")
           for o in (64, 3)] \
        + [("conv3x3_implicit_gemm", (2, 19, 150, 128), o, True, True)
           for o in (128, 5)] \
        + [("conv3x3_implicit_gemm", (2, 19, 70, 3), o, True, True)
           for o in (64, 5)]  # the same through the narrow kernel
    for name, shape, o, bias, nonfinite in cases:
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        for dtype in (torch.float16, torch.bfloat16, torch.float32):
            x, w, b = conv_inputs(torch, shape, o, dtype, gen, bias=bias)
            if nonfinite and shape[-1] == 3:
                # Both sides of a narrow tile's edge columns (31 | 32) and
                # rows (7 | 8), image edges, a halo's corner.
                for idx, v in NARROW_NONFINITE:
                    x[idx] = float(v)
            elif nonfinite:
                # The interior, both sides of a strip's edge, image edges.
                x[0, 3, 5, 7] = float("inf")
                x[0, 10, 127, 1] = float("-inf")
                x[0, 10, 128, 2] = float("nan")
                x[1, 0, 149, 0] = float("nan")
                x[1, 18, 0, 63] = float("inf")
            got = kern(x, w, b)
            torch.cuda.synchronize()
            want = plain(x, w, b)
            fin = torch.isfinite(want)
            err = (got.float() - want.float()).abs()[fin].max().item()
            ok = conv_within_tolerance(torch, got, want, x, w, b)
            if shape[-1] <= 7:  # and the narrow kernel's NaNs are plain's
                ok = ok and bool((torch.isnan(got) == torch.isnan(want)).all())
            RESULTS["checks"].append(
                {"kernel": name, "shape": shape, "O": o, "dtype": str(dtype),
                 "bias": b is not None, "nonfinite_inputs": nonfinite,
                 "nonfinite_outputs": int((~fin).sum()),
                 "max_abs_err": err,
                 "scale": want.float()[fin].abs().max().item(), "ok": ok})
            if not ok:
                fail(f"{name} {shape}->{o} {dtype}: max |kernel - plain| = "
                     f"{err}, or non-finite outputs differ")
            errs[name] = max(errs.get(name, 0.0), err)
            del x, w, b, got, want
    torch.cuda.empty_cache()


def norm_inputs(torch, shape, variant, dtype, gen):
    from rerevst_torch.models.transformer import NormStats

    dev = torch.device("cuda")
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev) * 2
    mean = torch.randn(c, generator=gen, device=dev)
    rstd = 0.5 + torch.rand(c, generator=gen, device=dev)
    # A degenerate channel: rstd 1e6 with a non-zero mean.
    mean[0], rstd[0] = 0.3, 1e6
    x[..., 0] = 0.3 + 1e-6 * torch.randn(shape[:-1], generator=gen, device=dev)
    xmin = -2 - torch.rand(c, generator=gen, device=dev)
    xmax = 2 + torch.rand(c, generator=gen, device=dev)
    st = NormStats(*(v.reshape(1, 1, 1, c) for v in (mean, rstd, xmin, xmax)))
    s = m = None
    if variant == "affine":
        s = (1 + torch.rand(c, generator=gen, device=dev)).to(dtype) \
            .reshape(1, 1, 1, c)
        m = torch.randn(c, generator=gen, device=dev).to(dtype) \
            .reshape(1, 1, 1, c)
    return x.to(dtype), st, s, m


def filter_inputs(torch, shape, dtype, gen):
    dev = torch.device("cuda")
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    # Filters far outside f16's range: the kernel keeps them fp32.
    f1 = torch.randn(1, 32, 32, generator=gen, device=dev) * 1e3
    f2 = torch.randn(1, 32, 32, generator=gen, device=dev) * 1e-3
    return x, f1, f2


def check_kernels(torch):
    from rerevst_torch import kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dtypes = (torch.float16, torch.bfloat16, torch.float32)
    p = PAD_HW
    norm_shapes = [(BATCH, p // 8, p // 8, 512), (BATCH, p // 4, p // 4, 256),
                   (BATCH, p // 2, p // 2, 128), (BATCH, p, p, 64),
                   (3, 37, 53, 64), (2, 13, 7, 512)]  # the last two ragged
    errs = {"norm_affine_clamp": 0.0, "dynamic_filter_pair": 0.0}
    for shape in norm_shapes:
        for dtype in dtypes:
            for variant in ("identity", "affine", "leaky"):
                x, st, s, m = norm_inputs(torch, shape, variant, dtype, gen)
                leaky = variant == "leaky"
                got = kernels.norm_affine_clamp(x, st, s, m, leaky)
                torch.cuda.synchronize()
                want = kernels.norm_affine_clamp_plain(x, st, s, m, leaky)
                err = (got.float() - want.float()).abs().max().item()
                ok = within_tolerance(torch, got, want)
                RESULTS["checks"].append(
                    {"kernel": "norm_affine_clamp", "shape": shape,
                     "dtype": str(dtype), "variant": variant,
                     "max_abs_err": err, "ok": ok})
                if not ok:
                    fail(f"norm_affine_clamp {shape} {dtype} {variant}: "
                         f"max |kernel - plain| = {err}")
                errs["norm_affine_clamp"] = max(errs["norm_affine_clamp"], err)
                del x, got, want
    # The main path's shape; row counts that are not a multiple of the
    # kernel's 16-row tile (231 and 10,282), below it (13) and 1; and inf
    # and NaN inputs, in rows of a ragged last tile too.
    filter_cases = [((BATCH, p // 8, p // 8, 32), False),
                    ((3, 7, 11, 32), False), ((2, 53, 97, 32), False),
                    ((1, 1, 13, 32), False), ((1, 1, 1, 32), False),
                    ((3, 7, 11, 32), True)]
    for shape, nonfinite in filter_cases:
        for dtype in dtypes:
            x, f1, f2 = filter_inputs(torch, shape, dtype, gen)
            if nonfinite:
                x[0, 0, 3, 5] = float("inf")
                x[1, 4, 2, 0] = float("-inf")
                x[2, 6, 10, 31] = float("nan")
            got = kernels.dynamic_filter_pair(x, f1, f2)
            torch.cuda.synchronize()
            want = kernels.dynamic_filter_pair_plain(x, f1, f2)
            fin = torch.isfinite(want)
            err = (got.float() - want.float()).abs()[fin].max().item()
            scale = want.float()[fin].abs().max().item()
            ok = within_tolerance(torch, got, want)
            RESULTS["checks"].append(
                {"kernel": "dynamic_filter_pair", "shape": shape,
                 "dtype": str(dtype), "nonfinite_inputs": nonfinite,
                 "nonfinite_outputs": int((~fin).sum()),
                 "max_abs_err": err, "scale": scale, "ok": ok})
            if not ok:
                fail(f"dynamic_filter_pair {shape} {dtype}: max |kernel - "
                     f"plain| = {err} at scale {scale}, or non-finite "
                     f"outputs differ")
            errs["dynamic_filter_pair"] = max(errs["dynamic_filter_pair"], err)
    check_convs(torch, gen, errs)
    return errs, len(RESULTS["checks"])


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

_SLEEP_CYCLES_PER_MS: list = []


def _sleep_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 10 ** 7
        ms = _events_ms(torch, lambda: torch.cuda._sleep(cycles), 1)
        _SLEEP_CYCLES_PER_MS.append(cycles / ms)
    return _SLEEP_CYCLES_PER_MS[0]


def _events_ms(torch, fn, iters) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(torch, fn, iters=20, warmup=3) -> dict:
    """Device milliseconds per call of `fn` (CUDA events), and the host's own
    milliseconds per call (its enqueue: Python, checks, ctypes, allocation).

    The timed calls queue up behind a sleep kernel that lasts longer than
    their enqueue, so the card runs them back to back and the events read
    device time, not the host's pace.  ``host_paced`` says the sleep ran out
    before the host had queued every call (the device time is then an upper
    bound)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 2 * host_ms + 2
    torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms(torch)))
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return {"ms": start.elapsed_time(end) / iters,
            "host_ms": min(host_ms, enqueue_ms) / iters,
            "host_paced": enqueue_ms >= sleep_ms}


def time_kernels(torch):
    """Per-site times at the f16 main path's shapes; sums per Pass-2 batch."""
    from rerevst_torch import kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    dtype = torch.float16
    tot = {"norm_affine_clamp": [0.0, 0.0, 0.0],
           "dynamic_filter_pair": [0.0, 0.0, 0.0]}
    for site, c, div, variant in NORM_SITES:
        shape = (BATCH, PAD_HW // div, PAD_HW // div, c)
        x, st, s, m = norm_inputs(torch, shape, variant, dtype, gen)
        leaky = variant == "leaky"
        k = time_ms(torch, lambda: kernels.norm_affine_clamp(x, st, s, m, leaky))
        pl = time_ms(torch,
                     lambda: kernels.norm_affine_clamp_plain(x, st, s, m, leaky))
        nbytes = 2 * x.numel() * x.element_size() + 4 * c * 4 \
            + (2 * c * 2 if s is not None else 0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"kernel": "norm_affine_clamp", "site": site, "shape": shape,
               "dtype": "float16", "variant": variant,
               "launches_per_batch": 1, "ms": k["ms"],
               "plain_ms": pl["ms"], "bound_ms": bound, "bound_by": "bytes",
               "host_ms": k["host_ms"], "plain_host_ms": pl["host_ms"],
               "host_paced": k["host_paced"] or pl["host_paced"]}
        RESULTS["times"].append(row)
        emit({"phase": "time", **row})
        for i, v in enumerate((k["ms"], pl["ms"], bound)):
            tot["norm_affine_clamp"][i] += v
        del x
    shape = (BATCH, PAD_HW // 8, PAD_HW // 8, 32)
    x, f1, f2 = filter_inputs(torch, shape, dtype, gen)
    k = time_ms(torch, lambda: kernels.dynamic_filter_pair(x, f1, f2))
    pl = time_ms(torch, lambda: kernels.dynamic_filter_pair_plain(x, f1, f2))
    rows = x.numel() // 32
    flops = rows * 2 * (2 * 32 * 32)
    t_bytes = (2 * x.numel() * 2 + 2 * 32 * 32 * 4) / HBM_BYTES_PER_S * 1e3
    # fp32-accurate products on the tensor cores: three TF32 passes.
    t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = {"kernel": "dynamic_filter_pair", "site": "filter1..3 (each)",
           "shape": shape, "dtype": "float16",
           "launches_per_batch": FILTER_SITES, "ms": k["ms"],
           "plain_ms": pl["ms"], "bound_ms": bound, "bound_by": bound_by,
           "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
           "bound_fp32_cores_ms": flops / FP32_FLOP_PER_S * 1e3,
           "host_ms": k["host_ms"], "plain_host_ms": pl["host_ms"],
           "host_paced": k["host_paced"] or pl["host_paced"]}
    RESULTS["times"].append(row)
    emit({"phase": "time", **row})
    tot["dynamic_filter_pair"] = [FILTER_SITES * v
                                  for v in (k["ms"], pl["ms"], bound)]
    return tot, bound_by


def conv_bound(x, w, o):
    """Least device time of one f16 conv call: each input read once and the
    output written once over HBM, or its 2 M K O flops over the dense f16
    tensor-core peak, whichever is larger."""
    m = x.numel() // x.shape[-1]
    nbytes = (x.numel() + w.numel() + o + m * o) * x.element_size()
    flops = 2 * m * w.shape[0] * w.shape[1] * w.shape[2] * o
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_bytes, t_ops


def time_convs(torch):
    """The conv kernels at the f16 shapes: the pair-lane sites of one Pass-2
    batch, and the implicit-GEMM conv at the JAX conv benchmark's shapes.
    Beside each, its plain version and one F.conv2d call on the same inputs
    (channels_last, bias fused into the call, the OIHW weight made once
    before timing), the yardstick the port does not call."""
    import torch.nn.functional as F

    from rerevst_torch import kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dtype = torch.float16
    tot = {}
    sites = [("conv3x3_pairlane", site, n, (BATCH, PAD_HW, PAD_HW, 64), o)
             for site, n, o in PAIRLANE_SITES] \
        + [("conv3x3_implicit_gemm", "scripts/bench_conv3x3.py", 1, shape, o)
           for shape, o in IGEMM_BENCH]
    for name, site, n, shape, o in sites:
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        x, w, b = conv_inputs(torch, shape, o, dtype, gen)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        xl = x.permute(0, 3, 1, 2)
        k = time_ms(torch, lambda: kern(x, w, b), iters=10, warmup=2)
        pl = time_ms(torch, lambda: plain(x, w, b), iters=5, warmup=1)
        lib = time_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1),
                      iters=10, warmup=2)
        bound, by, t_bytes, t_ops = conv_bound(x, w, o)
        row = {"kernel": name, "site": site, "shape": shape, "O": o,
               "dtype": "float16", "launches_per_batch": n, "ms": k["ms"],
               "plain_ms": pl["ms"], "library_ms": lib["ms"],
               "bound_ms": bound, "bound_by": by, "bound_bytes_ms": t_bytes,
               "bound_ops_ms": t_ops,
               "tflops": 2 * x.numel() * 9 * o / k["ms"] / 1e9,
               "host_ms": k["host_ms"], "plain_host_ms": pl["host_ms"],
               "host_paced": k["host_paced"] or pl["host_paced"]
               or lib["host_paced"]}
        RESULTS["times"].append(row)
        emit({"phase": "time", **row})
        acc = tot.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0, "library_ms": 0.0,
                                    "bytes_ms": 0.0, "ops_ms": 0.0})
        for key, v in (("ms", k["ms"]), ("plain_ms", pl["ms"]),
                       ("bound_ms", bound), ("library_ms", lib["ms"]),
                       ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
            acc[key] += n * v
        del x, w, b, wl, xl
    torch.cuda.empty_cache()
    for acc in tot.values():
        acc["bound_by"] = ("operations" if acc["ops_ms"] >= acc["bytes_ms"]
                           else "bytes")
    return tot


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def synth_clip(n, h, w, seed):
    """A smooth seeded pattern that moves a few pixels per frame (BGR u8)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = rng.uniform(0.01, 0.05, (3, 2))
    ph = rng.uniform(0, 6.3, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(n):
        img = np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                           + (yy + 2 * i) * f[c, 1] + ph[c])
                        * np.cos(yy * f[c, 0] * 0.7 - i * 0.05)
                        for c in range(3)], -1)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def synth_style(h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / (9 + 4 * c) + c)
                    * np.cos(yy / (13 - 3 * c) - c) for c in range(3)], -1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def run_e2e(torch):
    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.data import native
    from rerevst_torch.eval.parity import pixel_error

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    style = synth_style(CONTENT, CONTENT, seed=1)
    n_batches = -(-CLIP_FRAMES // BATCH)
    n_pass1_chunks = 1  # 5 sampled frames, one Pass-1 chunk
    default = {"norm_affine_clamp": 11 * n_batches,
               "dynamic_filter_pair": 3 * n_batches,
               "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 0}
    # The pair-lane path: conv1_2 in every encoder call (Pass-1 chunks and
    # Pass-2 batches), res2.conv2 and the out conv in every Pass-2 batch.
    pairlane = dict(default, conv3x3_pairlane=n_pass1_chunks + 3 * n_batches)
    # Per-frame mode: no Pass 1, no frozen statistics, so neither the norm
    # nor the filter kernel runs; on the pair-lane route conv1_2 runs the
    # conv kernel once per Pass-2 batch (the per-frame decoder has no
    # pair-lane tail, in either package).
    per_frame = {k: 0 for k in default}
    per_frame_pl = dict(per_frame, conv3x3_pairlane=n_batches)
    runs = [("f16", torch.float16, False, True, default),
            ("fp32", torch.float32, False, True, default),
            ("f16_pairlane", torch.float16, True, True, pairlane),
            ("pf_f16", torch.float16, False, False, per_frame),
            ("pf_fp32", torch.float32, False, False, per_frame),
            ("pf_f16_pairlane", torch.float16, True, False, per_frame_pl)]
    outs, sessions, counts_by = {}, {}, {}
    for key, dtype, pl, use_global, want in runs:
        t0 = time.perf_counter()
        s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype, pairlane=pl),
                        use_global=use_global, device="cuda")
        s.prepare_style(style)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        kernels.reset_launches()
        native.reset_calls()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames = list(s.stylize_video(clip, batch_size=BATCH))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if counts != want:
            fail(f"{key}: kernel launches {counts}, expected {want} "
                 f"({n_batches} Pass-2 batches)")
        # Each Pass-2 batch's host prep is one native call.
        if native.preprocess_batch.calls != n_batches:
            fail(f"{key}: {native.preprocess_batch.calls} native prep "
                 f"calls, expected {n_batches} (the native path did not run)")
        if len(frames) != CLIP_FRAMES:
            fail(f"{key}: {len(frames)} frames out of {CLIP_FRAMES}")
        for f in frames:
            if f.shape != (CONTENT, CONTENT, 3) or f.dtype != np.uint8:
                fail(f"{key}: frame {f.shape} {f.dtype}")
        if np.stack(frames).std() < 1.0:
            fail(f"{key}: constant output")
        counts_by[key] = counts
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # The same clip again: the first call above includes cuDNN's
        # algorithm choice and CUDA module loading.
        t0 = time.perf_counter()
        for _ in s.stylize_video(clip, batch_size=BATCH):
            pass
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        emit({"phase": "e2e", "session": key, "dtype": str(dtype),
              "pairlane": pl, "use_global": use_global,
              "frames": len(frames),
              "launches": counts, "pass2_batches": n_batches,
              "setup_s": t_setup, "stylize_video_wall_s": wall,
              "stylize_video_fps_wall": CLIP_FRAMES / wall,
              "warm_wall_s": warm, "warm_fps_wall": CLIP_FRAMES / warm,
              "peak_mem_gb": peak_gb, "pass1_mode": s.pass1_mode,
              "pass2_mode": s.pass2_mode})
        outs[key], sessions[key] = frames, s
    for key in ("f16", "f16_pairlane"):
        err = pixel_error(outs[key], outs["fp32"])
        emit({"phase": "e2e", f"{key}_vs_fp32": err, "bar_mean_01": 1e-3})
        RESULTS[f"{key}_vs_fp32"] = err
        if not err["mean_01"] <= 1e-3:
            fail(f"{key} vs fp32 mean |delta| {err['mean_01']} > 1e-3")
    for key in ("pf_f16", "pf_f16_pairlane"):
        # Recorded, not barred: the 1e-3 bar is the global pipeline's.
        err = pixel_error(outs[key], outs["pf_fp32"])
        emit({"phase": "e2e", f"{key}_vs_pf_fp32": err})
        RESULTS[f"{key}_vs_pf_fp32"] = err
    for a, b in (("f16_pairlane", "f16"), ("pf_f16_pairlane", "pf_f16")):
        err = pixel_error(outs[a], outs[b])
        emit({"phase": "e2e", f"{a}_vs_{b}": err})
        RESULTS[f"{a}_vs_{b}"] = err
    return sessions, counts_by


def drive_implicit_gemm(torch):
    """conv3x3_implicit_gemm has no model path in either package; its one
    driver in the JAX package is scripts/bench_conv3x3.py.  Drive it once
    at those shapes, at VGG conv2_2 and conv1_1 and at IGEMM_C32, counts at
    0 before and read after: each 16-bit design of csrc/conv3x3.cu must have
    launched."""
    from rerevst_torch import kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    shapes = IGEMM_BENCH + [(shape, o) for site, shape, o in VGG_CONVS
                            if site in ("VGG conv2_2", "VGG conv1_1")] \
        + [IGEMM_C32[1:]]
    kernels.reset_launches()
    for shape, o in shapes:
        x, w, b = conv_inputs(torch, shape, o, torch.float16, gen)
        y = kernels.conv3x3_implicit_gemm(x, w, b)
        torch.cuda.synchronize()
        if tuple(y.shape) != shape[:3] + (o,) or not torch.isfinite(y).all():
            fail(f"conv3x3_implicit_gemm {shape}->{o}: bad output")
        del x, w, b, y
    counts = kernels.launch_counts()
    by_design = dict(kernels.conv3x3_implicit_gemm.launches_by_design)
    emit({"phase": "e2e", "path": "conv3x3_implicit_gemm standalone",
          "launches": counts, "launches_by_design": by_design})
    if counts["conv3x3_implicit_gemm"] != len(shapes) \
            or by_design != {"streamed": 2, "wide": 1, "narrow": 1,
                             "igemm": 1, "fp32": 0}:
        fail(f"conv3x3_implicit_gemm standalone launches {counts}, "
             f"by design {by_design}")
    RESULTS["implicit_gemm_launches_by_design"] = by_design
    return counts


def ablation_params(which: str) -> dict:
    """The bundled checkpoint's tree under an ablation switch (no ablation
    checkpoint exists): ``no_filter`` drops the decoder's three filter
    blocks (``dynamic_filter=False``); ``style_only`` gives each filter
    predictor the style-only FC, ic -> 9 ic ic, with seeded normal(0, 0.1)
    weights and zero bias, the JAX package's init scaled x5
    (``both_sty_con=False``)."""
    import numpy as np

    from rerevst_torch.io.checkpoint import read_msgpack

    params = read_msgpack(str(HERE / "models" / "demo_plum_4000.msgpack"))
    dec = params["decoder"]
    if which == "no_filter":
        for i in (1, 2, 3):
            del dec[f"filter{i}"]
    else:
        rng = np.random.default_rng(5)
        for i in (1, 2, 3):
            for p in ("p1", "p2"):
                dec[f"filter{i}"][p]["fc"] = {
                    "w": (rng.standard_normal((32, 9 * 32 * 32)) * 0.1)
                    .astype(np.float32),
                    "b": np.zeros(9 * 32 * 32, np.float32)}
    return params


def check_against_cpu(torch):
    """The card's fp32 path (kernels + cuDNN) against the port's plain CPU
    path on a small clip, uint8 within 1 count: the global mode, the
    per-frame mode, and the per-frame mode under each ablation switch."""
    import numpy as np

    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(9, 64, 112, seed=2)
    style = synth_style(64, 64, seed=3)
    cases = [("global", {"checkpoint": ckpt}, True),
             ("per_frame", {"checkpoint": ckpt}, False)]
    for which, kw in (("no_filter", {"dynamic_filter": False}),
                      ("style_only", {"both_sty_con": False})):
        cases.append((f"per_frame_{which}",
                      {"params": ablation_params(which),
                       "cfg": ModelConfig(**kw)}, False))
    for name, kw, use_global in cases:
        outs = []
        for dev in ("cuda", "cpu"):
            s = Stylization(use_global=use_global, device=dev, **kw)
            s.prepare_style(style)
            outs.append(list(s.stylize_video(clip, batch_size=4)))
        d = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                for a, b in zip(*outs))
        std = float(np.stack(outs[0]).std())
        emit({"phase": "e2e", "cuda_vs_cpu_fp32": name, "max_counts": d,
              "output_std": std})
        RESULTS[f"cuda_vs_cpu_fp32_{name}"] = d
        if d > 1 or std < 1.0:
            fail(f"{name}: card vs CPU path differ by {d} counts "
                 f"(output std {std})")


def check_pth(torch):
    """The bundled weights written by the port as a reference ``.pth`` and
    read back: the session's fp32 frames equal the ``.msgpack`` session's
    bit for bit, and its global path launches both kernels (11 norm and 3
    filter-pair launches per Pass-2 batch)."""
    import tempfile

    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.api import Stylization
    from rerevst_torch.io.checkpoint import read_msgpack
    from rerevst_torch.io.torch_compat import to_reference_state_dict

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(9, 64, 112, seed=2)
    style = synth_style(64, 64, seed=3)
    n_batches = 3
    outs, counts = [], None
    with tempfile.TemporaryDirectory() as tmp:
        pth = str(Path(tmp) / "style_net.pth")
        torch.save(to_reference_state_dict(read_msgpack(ckpt)), pth)
        for path in (pth, ckpt):
            s = Stylization(path, device="cuda")
            s.prepare_style(style)
            kernels.reset_launches()
            outs.append(list(s.stylize_video(clip, batch_size=4)))
            counts = counts or kernels.launch_counts()
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    want = {"norm_affine_clamp": 11 * n_batches,
            "dynamic_filter_pair": 3 * n_batches,
            "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 0}
    emit({"phase": "e2e", "pth_session_bit_equal": same, "launches": counts})
    RESULTS["pth_session_bit_equal"] = same
    if not same:
        fail(".pth session frames differ from the .msgpack session's")
    if counts != want:
        fail(f".pth session launches {counts}, expected {want}")


def pan_windows(tex, n, size, dx, dy):
    """`n` size x size windows of `tex` moving (-dx, -dy) per frame (dx, dy
    >= 0), so frame t+1 at p is frame t at p - (dx, dy): an exact pan with
    the constant flow (dx, dy)."""
    oy, ox = (n - 1) * dy, (n - 1) * dx
    return [tex[oy - t * dy:oy - t * dy + size, ox - t * dx:ox - t * dx + size]
            for t in range(n)]


def blob_texture(h, w, size, seed):
    """A seeded h x w texture (BGR u8) of broad colour blobs, about a
    `size`-window across, under finer detail, so what a window holds, and
    its channel statistics, drift as it moves."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = np.full((h, w, 3), 128.0, np.float32)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.15, 0.35) * size
        tex += (np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
                [..., None] * rng.uniform(-90, 90, 3))
    f = rng.uniform(0.04, 0.15, (3, 4))
    tex += np.stack([30 * np.sin(xx * f[c, 0] + yy * f[c, 1] + c)
                     + 20 * np.cos(xx * f[c, 2] - yy * f[c, 3])
                     for c in range(3)], -1)
    return np.clip(tex + rng.normal(0, 6, tex.shape), 0, 255).astype(np.uint8)


def pan_clip(n, size, dx, dy, seed):
    """An exact pan of `n` frames over a ``blob_texture``."""
    tex = blob_texture(size + (n - 1) * dy, size + (n - 1) * dx, size, seed)
    return pan_windows(tex, n, size, dx, dy)


def temporal(torch, sessions):
    """E_warp and temporal SSIM of both inference modes (f16) on a seeded
    17-frame 512x512 exact pan, with the exact flows (no cv2): on the card,
    and on the CPU from the same frames (they must agree to 1e-4 relative).
    The pan moves 8 px a frame, a multiple of the encoder's stride, so the
    convolutional network is shift-equivariant away from the border and
    E_warp reads what the per-frame statistics add (a 3-px pan reads the
    encoder's aliasing, common to both modes).  The margin between the
    modes is recorded, not barred."""
    import numpy as np

    from rerevst_torch.eval.ewarp import ewarp
    from rerevst_torch.eval.ssim import temporal_ssim

    dx, dy, n = 8, 8, 17
    clip = pan_clip(n, CONTENT, dx, dy, seed=6)
    flow = np.zeros((CONTENT, CONTENT, 2), np.float32)
    flow[..., 0], flow[..., 1] = dx, dy
    flows = [flow] * (n - 1)
    out = {"clip": f"{n} frames {CONTENT}x{CONTENT}, pan ({dx}, {dy}) px "
                   f"per frame", "dtype": "float16"}
    for mode, key in (("global", "f16"), ("per_frame", "pf_f16")):
        styled = list(sessions[key].stylize_video(clip, batch_size=BATCH))
        t0 = time.perf_counter()
        card = {**ewarp(styled, clip, flows=flows, device="cuda"),
                **temporal_ssim(styled, clip, flows=flows, device="cuda")}
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        cpu = {**ewarp(styled, clip, flows=flows, device="cpu"),
               **temporal_ssim(styled, clip, flows=flows, device="cpu")}
        for k, v in cpu.items():
            if abs(card[k] - v) > 1e-4 * max(abs(v), 1e-12):
                fail(f"temporal {mode}: card {k} {card[k]} vs CPU {v}")
        out[mode] = {**card, "eval_s_card": t_card,
                     "cpu_ewarp": cpu["ewarp"], "cpu_tssim": cpu["tssim"]}
    out["ewarp_improvement_pct"] = 100 * (
        1 - out["global"]["ewarp"] / out["per_frame"]["ewarp"])
    RESULTS["temporal"] = out
    emit({"phase": "temporal", **out})


def time_pass2(torch, session):
    """Device time of one Pass-2 batch (16 padded 640x640 frames, f16):
    encode + the session's decoder (decode_global, or decode in per-frame
    mode), CUDA events around the stylize call."""
    clip = synth_clip(BATCH, CONTENT, CONTENT, seed=4)
    x = session._upload(session._prep_batch_host(clip))
    t = time_ms(torch, lambda: session._stylize(x), iters=10, warmup=2)
    return {"pass2_batch_ms": t["ms"], "pass2_fps_device": BATCH / t["ms"] * 1e3,
            "host_enqueue_ms": t["host_ms"], "host_paced": t["host_paced"],
            "batch": BATCH, "padded_hw": list(x.shape[1:3]),
            "dtype": "float16", "host_prep_note": "excluded"}


def _category(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("norm_affine_kernel", "filter_pair_kernel",
                              "conv3x3_")):
        return "port kernels"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                              "dgrad", "fprop", "sm90")):
        return "convolutions"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "copy" in low:
        return "layout copies"
    if "reduce" in low or "pool" in low:
        return "reductions and pools"
    return "other elementwise"


def _device_breakdown(prof, wall_ms: float, per: int = 1,
                      skip=()) -> dict:
    """Device busy time by kernel category (divided by `per`) against the
    host wall clock, and the top kernels by device time; the ranges named
    in `skip` are annotations, not kernels."""
    by_cat, kernels_ms = {}, []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us <= 0 or e.key.startswith("aten::") or e.key in skip:
            continue
        kernels_ms.append((e.key[:160], dev_us / 1e3 / per, e.count / per))
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / per
    busy = sum(by_cat.values())
    kernels_ms.sort(key=lambda r: -r[1])
    return {"wall_ms_profiled": wall_ms / per, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (wall_ms / per),
            "busy_by_category_ms": by_cat,
            "top_kernels": [{"name": n, "ms": t, "calls": c}
                            for n, t, c in kernels_ms[:16]]}


def trace_stylize_video(torch, session):
    """torch.profiler over one warm f16 stylize_video of the 33-frame clip:
    the device's busy time against the host wall clock, by kernel
    category."""
    from torch.profiler import ProfilerActivity, profile

    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in session.stylize_video(clip, batch_size=BATCH):
            pass
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_breakdown(prof, wall_ms)


def trace_pass2(torch, session, batches=3):
    """torch.profiler over `batches` warm f16 Pass-2 steps on an uploaded
    batch (encode + decode_global, no host prep): where one batch's device
    time goes, per batch."""
    from torch.profiler import ProfilerActivity, profile

    clip = synth_clip(BATCH, CONTENT, CONTENT, seed=4)
    x = session._upload(session._prep_batch_host(clip))
    session._stylize(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            session._stylize(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_breakdown(prof, wall_ms, per=batches)


def streaming_launches(n_samples: int, chunk: int) -> dict:
    """Kernel launches of one streaming Pass 1 over `n_samples` features in
    chunks of `chunk`: every stage runs the frozen prefix over every chunk
    (a filter stage twice, once per predictor); the prefix to a norm stage
    applies the norm sites before it and, past the filters, the three
    filter pairs."""
    from rerevst_torch.parallel.streaming import STAGES

    sites = [st for st in STAGES if st not in ("f1", "f2", "f3")]
    norm = filt = 0
    for stage in STAGES:
        if stage in ("f1", "f2", "f3"):
            norm += 2 * 1
            filt += 2 * (int(stage[1]) - 1)
        else:
            norm += sites.index(stage)
            filt += 0 if stage == "pre" else 3
    chunks = -(-n_samples // chunk)
    return {"norm_affine_clamp": chunks * norm,
            "dynamic_filter_pair": chunks * filt,
            "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 0}


def _max_excess(a, b, rtol, atol) -> float:
    """max(|a - b| - atol - rtol |b|): <= 0 where assert_allclose passes."""
    a, b = a.double(), b.double()
    return ((a - b).abs() - atol - rtol * b.abs()).max().item()


def long_clip(torch):
    """Long-clip Pass 1 on the card: f16 and fp32 stylize_video of a seeded
    65-frame 512x512 clip at sample_interval=1, so Pass 1 has 65 samples,
    spills them to the host spool and streams the statistics
    ('streaming-spill').  Launch counts of the whole path and of Pass 1
    alone, each from 0; Pass 1's wall time and device busy time
    (torch.profiler); f16 against fp32 frames; and the streamed SeqStats
    against the batched collect_stats over the same features, on the card,
    at rtol = atol = 2e-4."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rerevst_torch import kernels
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import InferenceConfig, ModelConfig
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.eval.parity import pixel_error
    from rerevst_torch.models.transformer import collect_stats
    from rerevst_torch.parallel.streaming import collect_stats_streaming

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    n = 65
    clip = synth_clip(n, CONTENT, CONTENT, seed=7)
    style = synth_style(CONTENT, CONTENT, seed=1)
    infer = InferenceConfig(sample_interval=1)
    chunk = infer.pass1_chunk
    pass1 = streaming_launches(n, chunk)
    n_batches = -(-n // BATCH)
    path = {k: v + {"norm_affine_clamp": 11 * n_batches,
                    "dynamic_filter_pair": 3 * n_batches}.get(k, 0)
            for k, v in pass1.items()}
    outs, res, sess = {}, {}, {}
    for key, dtype in (("fp32", torch.float32), ("f16", torch.float16)):
        s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype), infer=infer,
                        device="cuda")
        s.prepare_style(style)
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames = list(s.stylize_video(clip, batch_size=BATCH))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if s.pass1_mode != "streaming-spill":
            fail(f"long_clip {key}: pass1_mode {s.pass1_mode}")
        if counts != path:
            fail(f"long_clip {key}: launches {counts}, expected {path}")
        if len(frames) != n or np.stack(frames).std() < 1.0:
            fail(f"long_clip {key}: {len(frames)} frames or constant output")
        kernels.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.prepare_global(clip)
            torch.cuda.synchronize()
            t_pass1 = time.perf_counter() - t0
        counts1 = kernels.launch_counts()
        trace1 = _device_breakdown(prof, t_pass1 * 1e3)
        if counts1 != pass1 or s.pass1_mode != "streaming-spill":
            fail(f"long_clip {key} Pass 1: launches {counts1}, expected "
                 f"{pass1} ({s.pass1_mode})")
        res[key] = {"stylize_video_wall_s": wall,
                    "pass1_wall_s_profiled": t_pass1,
                    "pass1_device_busy_ms": trace1["device_busy_ms"],
                    "pass1_device_idle_share": trace1["device_idle_share"],
                    "pass1_busy_by_category_ms":
                        trace1["busy_by_category_ms"],
                    "launches": counts, "launches_pass1": counts1,
                    "pass1_mode": s.pass1_mode, "samples": n,
                    "pass1_chunks": -(-n // chunk)}
        emit({"phase": "long_clip", "session": key, **res[key]})
        outs[key], sess[key] = frames, s
    err = pixel_error(outs["f16"], outs["fp32"])
    res["f16_vs_fp32"] = err
    emit({"phase": "long_clip", "f16_vs_fp32": err, "bar_mean_01": 1e-3})
    if not err["mean_01"] <= 1e-3:
        fail(f"long_clip f16 vs fp32 mean |delta| {err['mean_01']} > 1e-3")
    s = sess["fp32"]
    with torch.inference_mode():
        feats = np.concatenate([
            s._encode(s._upload(np.concatenate(
                [bgr_to_model(f) for f in clip[i:i + chunk]]))).cpu().numpy()
            for i in range(0, n, chunk)])
        streamed = collect_stats_streaming(s.params["decoder"], feats,
                                           s.style, s.cfg, chunk_size=chunk)
        batched = collect_stats(s.params["decoder"],
                                torch.from_numpy(feats).cuda(), s.style,
                                s.cfg)
    worst = {}
    for k, st in batched.norms.items():
        for f in st._fields:
            worst[f"{k}.{f}"] = _max_excess(getattr(streamed.norms[k], f),
                                            getattr(st, f), 2e-4, 2e-4)
    for k, f in batched.filters.items():
        worst[k] = _max_excess(streamed.filters[k], f, 2e-4, 2e-4)
    del feats, batched, streamed
    torch.cuda.empty_cache()
    bad = {k: v for k, v in worst.items() if v > 0}
    res["streamed_vs_batched_max_excess"] = max(worst.values())
    emit({"phase": "long_clip", "streamed_vs_batched": "rtol=atol=2e-4",
          "leaves": len(worst), "max_excess": max(worst.values()),
          "failing": bad})
    if bad:
        fail(f"long_clip: streamed SeqStats differ from batched: {bad}")
    RESULTS["long_clip"] = res
    return res


@contextlib.contextmanager
def numpy_prep():
    """Run the session's host prep on its numpy path (the native library
    hidden) inside the block."""
    from rerevst_torch.data import native

    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = saved


def native_prep(torch, session):
    """The native host library: it must load; one 16-frame 512x512 batch's
    host prep (BGR -> normalized RGB + reflect pad to 640x640) timed on the
    native and the numpy path; the two prepped batches within 1e-6; the f16
    session's frames from both paths within 1 count; and the host's cost
    of converting one fetched batch back to uint8 frames."""
    import numpy as np

    from rerevst_torch.data import native
    from rerevst_torch.data.transforms import model_to_bgr

    if not native.available():
        fail("native host library did not build or load")
    clip = synth_clip(BATCH, CONTENT, CONTENT, seed=4)

    def prep_ms(reps=5):
        session._prep_batch_host(clip)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = session._prep_batch_host(clip)
        return (time.perf_counter() - t0) * 1e3 / reps, out

    t_native, a = prep_ms()
    with numpy_prep():
        t_numpy, b = prep_ms()
        frames_numpy = list(session.stylize_video(
            synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0),
            batch_size=BATCH))
    frames_native = list(session.stylize_video(
        synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0), batch_size=BATCH))
    # The drain's host work on one fetched batch (16 frames of 512x512):
    # stylize_video's model_to_bgr per frame, and the native postprocess
    # that transfer uses, both from the same fp32 array.
    host = np.ascontiguousarray(a[:, 64:64 + CONTENT, 64:64 + CONTENT])
    drain = {}
    for name, post in (("model_to_bgr", model_to_bgr),
                       ("native_postprocess",
                        lambda f: native.postprocess(f, CONTENT, CONTENT, 0))):
        t0 = time.perf_counter()
        for _ in range(3):
            for i in range(BATCH):
                post(host[i:i + 1])
        drain[name] = (time.perf_counter() - t0) * 1e3 / 3
    prep_err = float(np.abs(a - b).max())
    d = max(int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())
            for x, y in zip(frames_native, frames_numpy))
    res = {"library": str(native.library_path().relative_to(HERE)),
           "prep_ms_per_batch_native": t_native,
           "prep_ms_per_batch_numpy": t_numpy, "batch": BATCH,
           "frame_hw": [CONTENT, CONTENT], "padded_hw": list(a.shape[1:3]),
           "drain_ms_per_batch_model_to_bgr": drain["model_to_bgr"],
           "drain_ms_per_batch_native_postprocess":
               drain["native_postprocess"],
           "prep_max_abs_diff": prep_err, "frames_max_counts": d,
           "host_cpus": os.cpu_count()}
    RESULTS["native_prep"] = res
    emit({"phase": "native_prep", **res})
    if prep_err > 1e-6 or d > 1:
        fail(f"native prep differs from numpy: {prep_err} (prep), {d} counts")
    return res


def check_per_sample_kernels(torch, errs):
    """The per-sample route of both wrappers (one launch per sample, each
    with its own conditioning) against their plain versions at the
    multi-style batch-16 shapes, in f16 and fp32."""
    from rerevst_torch import kernels
    from rerevst_torch.models.transformer import NormStats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    dev = torch.device("cuda")
    p = PAD_HW
    for dtype in (torch.float16, torch.float32):
        for site, c, div, variant in NORM_SITES:
            shape = (BATCH, p // div, p // div, c)
            x, st, s, m = norm_inputs(torch, shape, variant, dtype, gen)
            st = NormStats(*(v * (1 + 0.1 * torch.rand(
                BATCH, 1, 1, c, generator=gen, device=dev)) for v in st))
            if s is not None:
                s = (1 + torch.rand(BATCH, 1, 1, c, generator=gen,
                                    device=dev))
                m = torch.randn(BATCH, 1, 1, c, generator=gen, device=dev)
            leaky = variant == "leaky"
            before = kernels.norm_affine_clamp.launches
            got = kernels.norm_affine_clamp(x, st, s, m, leaky)
            torch.cuda.synchronize()
            if kernels.norm_affine_clamp.launches - before != BATCH:
                fail("per-sample norm_affine_clamp: not one launch a sample")
            want = kernels.norm_affine_clamp_plain(x, st, s, m, leaky)
            err = (got.float() - want.float()).abs().max().item()
            ok = within_tolerance(torch, got, want)
            RESULTS["checks"].append(
                {"kernel": "norm_affine_clamp", "per_sample": True,
                 "shape": shape, "dtype": str(dtype), "variant": variant,
                 "max_abs_err": err, "ok": ok})
            if not ok:
                fail(f"per-sample norm_affine_clamp {shape} {dtype} "
                     f"{variant}: max |kernel - plain| = {err}")
            errs["norm_affine_clamp"] = max(errs["norm_affine_clamp"], err)
            del x, got, want
        shape = (BATCH, p // 8, p // 8, 32)
        x, f1, f2 = filter_inputs(torch, shape, dtype, gen)
        f1 = f1 * (1 + torch.rand(BATCH, 32, 32, generator=gen, device=dev))
        f2 = f2 * (1 + torch.rand(BATCH, 32, 32, generator=gen, device=dev))
        got = kernels.dynamic_filter_pair(x, f1, f2)
        torch.cuda.synchronize()
        want = kernels.dynamic_filter_pair_plain(x, f1, f2)
        err = (got.float() - want.float()).abs().max().item()
        ok = within_tolerance(torch, got, want)
        RESULTS["checks"].append(
            {"kernel": "dynamic_filter_pair", "per_sample": True,
             "shape": shape, "dtype": str(dtype), "max_abs_err": err,
             "ok": ok})
        if not ok:
            fail(f"per-sample dynamic_filter_pair {shape} {dtype}: max "
                 f"|kernel - plain| = {err}")
        errs["dynamic_filter_pair"] = max(errs["dynamic_filter_pair"], err)
    torch.cuda.empty_cache()


def multistyle(torch, errs):
    """Multi-style interpolation on the card: two seeded styles over the
    33-frame 512x512 clip with the linear sweep at batch 16 (every batch on
    the per-sample route), in f16 and fp32, launches counted from 0; f16
    against fp32; the card's fp32 against the CPU's on a 9-frame 64x112
    clip (within 1 count); the per-sample kernels against their plain
    versions; and one decode of a 16-frame batch on the shared route (one
    blend for the batch) and on the per-sample route (a blend per frame)."""
    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.config import InferenceConfig, ModelConfig
    from rerevst_torch.eval.parity import pixel_error
    from rerevst_torch.models.transformer import (
        blend_pytrees,
        blend_pytrees_batched,
        decode_global,
    )
    from rerevst_torch.multistyle import (
        MultiStylization,
        linear_sweep_weights,
    )

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    styles = [synth_style(CONTENT, CONTENT, seed=1),
              synth_style(CONTENT, CONTENT, seed=9)]
    n_batches = -(-CLIP_FRAMES // BATCH)
    want = {"norm_affine_clamp": 11 * BATCH * n_batches,
            "dynamic_filter_pair": 3 * BATCH * n_batches,
            "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 0}
    outs, res, sessions = {}, {}, {}
    for key, dtype in (("f16", torch.float16), ("fp32", torch.float32)):
        ms = MultiStylization(ckpt, cfg=ModelConfig(dtype=dtype),
                              device="cuda")
        ms.prepare_styles(styles)
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames = list(ms.interpolate_video(clip, batch_size=BATCH))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if counts != want:
            fail(f"multistyle {key}: launches {counts}, expected {want}")
        if len(frames) != CLIP_FRAMES or np.stack(frames).std() < 1.0:
            fail(f"multistyle {key}: {len(frames)} frames or constant")
        res[key] = {"interpolate_video_wall_s": wall, "launches": counts,
                    "batches": n_batches}
        emit({"phase": "multistyle", "session": key, **res[key]})
        outs[key], sessions[key] = frames, ms
    err = pixel_error(outs["f16"], outs["fp32"])
    res["f16_vs_fp32"] = err
    emit({"phase": "multistyle", "f16_vs_fp32": err, "bar_mean_01": 1e-3})
    if not err["mean_01"] <= 1e-3:
        fail(f"multistyle f16 vs fp32 mean |delta| {err['mean_01']} > 1e-3")
    small = synth_clip(9, 64, 112, seed=2)
    small_styles = [synth_style(64, 64, seed=3), synth_style(64, 64, seed=5)]
    got = {}
    for dev in ("cuda", "cpu"):
        ms = MultiStylization(ckpt, device=dev)
        ms.prepare_styles(small_styles)
        got[dev] = list(ms.interpolate_video(small, batch_size=4))
    d = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
            for a, b in zip(got["cuda"], got["cpu"]))
    res["cuda_vs_cpu_fp32_max_counts"] = d
    emit({"phase": "multistyle", "cuda_vs_cpu_fp32": "9 frames 64x112",
          "max_counts": d})
    if d > 1:
        fail(f"multistyle: card vs CPU fp32 differ by {d} counts")
    check_per_sample_kernels(torch, errs)
    ms = sessions["f16"]
    feats = ms.encode_frames(clip[:BATCH])
    ms.prepare_global(feats)
    rows = linear_sweep_weights(BATCH, 2)
    dec = ms.params["decoder"]
    with torch.inference_mode():
        shared = (blend_pytrees(ms.styles, rows[BATCH // 2]),
                  blend_pytrees(ms.stats, rows[BATCH // 2]))
        per = (blend_pytrees_batched(ms.styles, rows),
               blend_pytrees_batched(ms.stats, rows))
        for route, (sf, st) in (("shared", shared), ("per_sample", per)):
            t = time_ms(torch, lambda: decode_global(dec, feats, sf, st,
                                                     ms.cfg),
                        iters=10, warmup=2)
            res[f"decode_{route}_ms_per_batch"] = t["ms"]
            res[f"decode_{route}_host_paced"] = t["host_paced"]
    res["decode_note"] = ("decode_global of 16 encoded 640x640 frames, f16, "
                          "CUDA events")
    emit({"phase": "multistyle", **{k: v for k, v in res.items()
                                    if k.startswith("decode")}})
    RESULTS["multistyle"] = res
    return res


def _http(url, body=None, method="POST"):
    """(status, body) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz_bytes(frames, **extra):
    import io

    import numpy as np

    bio = io.BytesIO()
    np.savez(bio, **{f"f{i:05d}": f for i, f in enumerate(frames)}, **extra)
    return bio.getvalue()


def _npz_frames(body):
    import io

    import numpy as np

    with np.load(io.BytesIO(body)) as z:
        return [z[k] for k in sorted(z.files)]


def _start_server(server):
    import threading

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    return f"http://{host}:{port}", t


def _stop_server(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(60)


def serve_phase(torch):
    """The HTTP service (``rerevst_torch.serve``) on the card, f16, with the
    bundled checkpoint, the 33-frame 512x512 clip and its style: a server on
    127.0.0.1 (port 0) with a 5 ms micro-batch window and batch_max 8; its
    warmup timed; style and Pass 1 through the service methods (the image
    endpoints need cv2); 8 concurrent /stylize calls, coalesced and within
    1 count of the session's transfer_batch; a lone call; /video over HTTP
    bit-equal to a direct stylize_video; a chunked, async clip session equal
    to /video; /styles + /interpolate equal to MultiStylization; one /video
    on a pair-lane service.  Each endpoint's kernel launches are counted
    from 0 around its own calls only (the direct comparisons do not
    count).  The cold first /stylize runs on a second service without
    warmup, before the server's warmup, in this process: the kernels are
    built and the card is in use by then, so it shows the session's
    first-call costs at new batch shapes, not the builds."""
    import io
    import threading

    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import InferenceConfig, ModelConfig
    from rerevst_torch.multistyle import MultiStylization
    from http.server import ThreadingHTTPServer

    from rerevst_torch.serve import StylizeService, make_handler, serve

    if torch.backends.cudnn.benchmark:
        fail("serve: cudnn.benchmark is on; the bit-equality checks need "
             "cuDNN's fixed algorithm choice")
    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    style = synth_style(CONTENT, CONTENT, seed=1)
    interval = 8
    sampled = [clip[i] for i in range(0, CLIP_FRAMES - 1, interval)] \
        + [clip[-1]]
    res, launches = {}, {}
    t_phase = time.perf_counter()

    def counted(endpoint, fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        launches[endpoint] = {k: launches.get(endpoint, {}).get(k, 0) + v
                              for k, v in c.items()}
        return out

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    def two_pass(svc):
        svc.set_style(style)
        for i, f in enumerate(sampled):
            svc.pass1(f, last=i == len(sampled) - 1)

    # Cold: a service without warmup, its first /stylize and a second.
    cold = StylizeService(ckpt, dtype="f16")
    two_pass(cold)
    t0 = time.perf_counter()
    cold.stylize(clip[0])
    res["cold_first_stylize_ms"] = ms_since(t0)
    t0 = time.perf_counter()
    cold.stylize(clip[0])
    res["cold_second_stylize_ms"] = ms_since(t0)
    del cold
    torch.cuda.empty_cache()

    server = serve(ckpt, port=0, host="127.0.0.1", dtype="f16",
                   batch_window_ms=5, batch_max=8)
    url, thread = _start_server(server)
    svc = server.service
    try:
        t0 = time.perf_counter()
        counted("warmup", lambda: svc.warmup((CONTENT, CONTENT)))
        res["warmup_s"] = time.perf_counter() - t0
        status, body = _http(url + "/healthz", method="GET")
        hz = json.loads(body)
        if status != 200 or hz["has_style"] or hz["has_stats"]:
            fail(f"serve: healthz after warmup {status} {hz}")
        res["healthz"] = hz
        counted("style+pass1", lambda: two_pass(svc))
        t0 = time.perf_counter()
        counted("stylize", lambda: svc.stylize(clip[0]))
        res["warm_first_stylize_ms"] = ms_since(t0)

        # 8 concurrent /stylize calls, three rounds.
        conc = clip[:8]
        per_frame, outs = [], None
        n0 = svc.batcher.n_calls
        for _ in range(3):
            got = [None] * len(conc)
            barrier = threading.Barrier(len(conc) + 1, timeout=60)

            def call(i):
                barrier.wait()
                got[i] = svc.stylize(conc[i])

            ts = [threading.Thread(target=call, args=(i,), daemon=True)
                  for i in range(len(conc))]
            for t in ts:
                t.start()

            def round_():
                barrier.wait()
                for t in ts:
                    t.join(120)

            t0 = time.perf_counter()
            counted("stylize", round_)
            per_frame.append(ms_since(t0) / len(conc))
            if any(t.is_alive() for t in ts) or any(g is None for g in got):
                fail("serve: a concurrent /stylize call did not return")
            outs = got
        calls = list(svc.batcher.calls)[n0:]
        want = svc._transfer_batch(conc)
        d = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                for a, b in zip(outs, want))
        res["concurrent"] = {
            "threads": len(conc), "rounds": 3,
            "ms_per_frame": per_frame,
            "batcher_calls": calls,
            "max_counts_vs_transfer_batch": d}
        if max(calls) <= 1:
            fail(f"serve: concurrent /stylize never coalesced: {calls}")
        if d > 1:
            fail(f"serve: micro-batched frames differ from transfer_batch "
                 f"by {d} counts")
        lone = []
        for _ in range(5):
            t0 = time.perf_counter()
            counted("stylize", lambda: svc.stylize(clip[1]))
            lone.append(ms_since(t0))
        res["batch1_ms"] = lone
        res["batch1_ms_median"] = sorted(lone)[2]

        # /video over HTTP against a direct stylize_video.
        body = _npz_bytes(clip)
        t0 = time.perf_counter()
        status, reply = counted("video", lambda: _http(
            url + f"/video?interval={interval}", body))
        res["video_http_wall_ms"] = ms_since(t0)
        if status != 200:
            fail(f"serve: /video answered {status}: {reply[:300]}")
        t0 = time.perf_counter()
        video = _npz_frames(reply)
        res["video_reply_decode_ms"] = ms_since(t0)
        # The host work the HTTP route adds: the server's compressed reply
        # (timed here alone), the request's encode and the reply's decode.
        t0 = time.perf_counter()
        np.savez_compressed(io.BytesIO(), *video)
        res["video_reply_encode_ms"] = ms_since(t0)
        direct = Stylization(ckpt, cfg=ModelConfig(dtype=torch.float16),
                             infer=InferenceConfig(
                                 sample_interval=interval,
                                 batch_size=min(CLIP_FRAMES, 8)))
        direct.prepare_style(style)
        t0 = time.perf_counter()
        want = list(direct.stylize_video(clip))
        res["video_direct_wall_ms"] = ms_since(t0)
        if len(video) != CLIP_FRAMES or any(
                not np.array_equal(a, b) for a, b in zip(video, want)):
            fail("serve: /video frames differ from direct stylize_video")
        del direct

        # Where the session calls run: on the service's device thread, or
        # on each request's own handler thread under the lock alone (PyTorch
        # keeps cuDNN's plans per thread).  One 8-frame /video, in turns.
        def caller_run(fn):
            with svc.lock:
                return fn()

        body8 = _npz_bytes(clip[:8])
        by_thread = {"caller": [], "device": []}
        for variant in ("caller", "device", "device", "caller"):
            if variant == "caller":
                svc._run = caller_run
            t0 = time.perf_counter()
            status, b = _http(url + f"/video?interval={interval}", body8)
            by_thread[variant].append(ms_since(t0))
            vars(svc).pop("_run", None)
            if status != 200:
                fail(f"serve: 8-frame /video ({variant}) answered {status}")
        res["video8_http_ms_by_thread"] = by_thread

        # The clip session: 3 chunks, async finish, two result ranges.
        t0 = time.perf_counter()

        def clip_session():
            status, b = _http(url + f"/clip/open?interval={interval}", b"")
            if status != 200:
                fail(f"serve: /clip/open answered {status}: {b[:300]}")
            token = json.loads(b)["clip"]
            for lo, hi in ((0, 11), (11, 22), (22, CLIP_FRAMES)):
                status, b = _http(url + f"/clip/{token}/frames",
                                  _npz_bytes(clip[lo:hi]))
                if status != 200:
                    fail(f"serve: /clip frames answered {status}")
            status, b = _http(url + f"/clip/{token}/finish?async=1", b"")
            if status != 202:
                fail(f"serve: async finish answered {status}: {b[:300]}")
            deadline = time.monotonic() + 300
            polls = 0
            while True:
                st = json.loads(_http(url + f"/clip/{token}/status",
                                      method="GET")[1])
                polls += 1
                if st["status"] == "done":
                    break
                if st["status"] != "running" or time.monotonic() > deadline:
                    fail(f"serve: clip session status {st}")
                time.sleep(0.01)
            frames = []
            for start, count in ((0, 17), (17, 16)):
                status, b = _http(url + f"/clip/{token}/result?start="
                                  f"{start}&count={count}", method="GET")
                if status != 200:
                    fail(f"serve: /clip result answered {status}")
                frames += _npz_frames(b)
            _http(url + f"/clip/{token}/close", b"")
            return frames, polls

        session_frames, polls = counted("clip", clip_session)
        res["clip_session_wall_ms"] = ms_since(t0)
        res["clip_session_status_polls"] = polls
        if len(session_frames) != CLIP_FRAMES or any(
                not np.array_equal(a, b)
                for a, b in zip(session_frames, video)):
            fail("serve: clip-session frames differ from /video's")
        status, metrics = _http(url + "/metrics", method="GET")
        text = metrics.decode()
        for series in ('rerevst_requests_total{endpoint="clip"}',
                       'rerevst_requests_total{endpoint="video"}',
                       "rerevst_open_clip_sessions 0",
                       "rerevst_microbatch_calls_total",
                       "rerevst_microbatch_frames_total"):
            if series not in text:
                fail(f"serve: /metrics lacks {series!r}: {text}")
        res["metrics"] = [line for line in text.splitlines()
                          if line and not line.startswith("#")]

        # Multi-style: /styles, then /interpolate on 8 frames (linear
        # sweep: a blend per frame, the per-sample route).
        styles = [style, synth_style(CONTENT, CONTENT, seed=9)]
        t0 = time.perf_counter()
        status, b = counted("styles", lambda: _http(url + "/styles",
                                                    _npz_bytes(styles)))
        res["styles_ms"] = ms_since(t0)
        if status != 200:
            fail(f"serve: /styles answered {status}: {b[:300]}")
        t0 = time.perf_counter()
        status, b = counted("interpolate", lambda: _http(
            url + "/interpolate", _npz_bytes(clip[:8])))
        res["interpolate_http_wall_ms"] = ms_since(t0)
        if status != 200:
            fail(f"serve: /interpolate answered {status}: {b[:300]}")
        ms = MultiStylization(ckpt, cfg=ModelConfig(dtype=torch.float16))
        ms.prepare_styles(styles)
        want = list(ms.interpolate_video(clip[:8]))
        got = _npz_frames(b)
        if len(got) != 8 or any(not np.array_equal(a, b)
                                for a, b in zip(got, want)):
            fail("serve: /interpolate differs from MultiStylization")
        del ms
    finally:
        _stop_server(server, thread)

    # Pair-lane: one /video on a StylizeService(pairlane=True).
    pl = StylizeService(ckpt, dtype="f16", pairlane=True)
    pl_server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pl))
    pl_server.daemon_threads = True
    pl_url, pl_thread = _start_server(pl_server)
    try:
        pl.set_style(style)
        t0 = time.perf_counter()
        status, b = counted("video_pairlane", lambda: _http(
            pl_url + f"/video?interval={interval}", _npz_bytes(clip[:8])))
        res["video_pairlane_http_wall_ms"] = ms_since(t0)
        if status != 200:
            fail(f"serve: pair-lane /video answered {status}: {b[:300]}")
        direct = Stylization(ckpt, cfg=ModelConfig(dtype=torch.float16,
                                                   pairlane=True),
                             infer=InferenceConfig(sample_interval=interval,
                                                   batch_size=8))
        direct.prepare_style(style)
        want = list(direct.stylize_video(clip[:8]))
        if any(not np.array_equal(a, b)
               for a, b in zip(_npz_frames(b), want)):
            fail("serve: pair-lane /video differs from direct stylize_video")
    finally:
        _stop_server(pl_server, pl_thread)

    # Launches: each endpoint's own, against what its calls must launch.
    n_video_batches = -(-CLIP_FRAMES // 8)
    n_stylize_calls = svc.batcher.n_calls  # warmup calls the session
    expect = {
        "warmup": (44, 12, 0),  # transfer + buckets 2, 4, 8
        "style+pass1": (0, 0, 0),
        "stylize": (11 * n_stylize_calls, 3 * n_stylize_calls, 0),
        "video": (11 * n_video_batches, 3 * n_video_batches, 0),
        "clip": (11 * n_video_batches, 3 * n_video_batches, 0),
        "styles": (0, 0, 0),
        "interpolate": (11 * 8, 3 * 8, 0),  # one launch per sample
        "video_pairlane": (11, 3, 1 + 3),   # Pass 1 conv1_2; 3 per batch
    }
    for ep, (norm, filt, pair) in expect.items():
        want = {"norm_affine_clamp": norm, "dynamic_filter_pair": filt,
                "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": pair}
        if launches[ep] != want:
            fail(f"serve: {ep} launched {launches[ep]}, expected {want}")
    total = {k: sum(c[k] for c in launches.values())
             for k in launches["video"]}
    for k in ("norm_affine_clamp", "dynamic_filter_pair",
              "conv3x3_pairlane"):
        if total[k] <= 0:
            fail(f"serve: {k} never launched on the serving path")
    res["launches_by_endpoint"] = launches
    res["launches_serve"] = total
    res["phase_s"] = time.perf_counter() - t_phase
    res["card"] = nvidia_smi()
    RESULTS["serve"] = res
    emit({"serve": res})
    return res


# ---------------------------------------------------------------------------
# Phase train: the trainer on the card
# ---------------------------------------------------------------------------

#: TrainConfig() defaults: batch 4 of 256x256 crops, fp32, flow_iter 16.
TRAIN_STEPS = 8
#: Rows of torch.profiler's own buffer handling, which long traces show
#: beside the kernels.
PROFILER_ROWS = ("Buffer Flush", "Activity Buffer Request")
#: The selected gradients held card against CPU (tests/test_grad_parity.py's).
TRAIN_GRAD_SITES = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
                    ("decoder", "filter1", "p1", "fc", "w"),
                    ("encoder", "conv4_1", "w"),
                    ("encoder_style", "conv1_1", "w")]


def train_batches(n, b, hw, seed):
    """`n` seeded batches in the loader's format: {"Content", "Style"},
    float32 NHWC, ImageNet-normalized RGB (no cv2: the synthetic clips)."""
    import numpy as np

    from rerevst_torch.data.transforms import bgr_to_model

    out = []
    for i in range(n):
        frames = synth_clip(b, hw, hw, seed=seed + i)
        styles = [synth_style(hw, hw, seed=seed + 1000 * (i + 1) + j)
                  for j in range(b)]
        out.append({"Content": np.concatenate([bgr_to_model(f)
                                               for f in frames]),
                    "Style": np.concatenate([bgr_to_model(s)
                                             for s in styles])})
    return out


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _train_step_run(torch, cfg, host_params, dev, batch, gen=None,
                    extra=None):
    """A fresh state from `host_params` on `dev`, one step: (state,
    metrics as floats)."""
    from rerevst_torch.train.state import init_train_state
    from rerevst_torch.train.step import make_train_step

    state = init_train_state(_tree_to(host_params, dev), cfg)
    c, s = (torch.from_numpy(batch[k]).to(dev) for k in ("Content", "Style"))
    state, m = make_train_step(cfg)(state, c, s, gen, extra)
    return state, {k: float(v) for k, v in m.items()}


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's (by default cuDNN may
    pick algorithms that sum a gradient in another order on each run)."""
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)


def train_card_vs_cpu(torch, host_params):
    """One state, an injected fake pair, 64x64 and flow_iter 2: the card's
    step (deterministic algorithms) against the port's CPU step.  Losses to
    1e-4 relative; the selected gradients to 1e-3 of each tensor's
    max-abs.  Beside it, the spread of two card steps under the default
    algorithms."""
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.ops.warp import flow_warp

    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False))
    batch = train_batches(1, 2, 64, seed=300)[0]
    gen = torch.Generator().manual_seed(5)
    flow = torch.randn((2, 64, 64, 2), generator=gen) * 2
    second = flow_warp(torch.from_numpy(batch["Content"]), flow, "nearest")

    def run(name):
        dev = torch.device(name)
        extra = {"Second": second.to(dev), "FakeFlow": flow.to(dev)}
        state, m = _train_step_run(torch, cfg, host_params, dev, batch,
                                   extra=extra)
        return m, {p: _leaf(state.params, p).grad.cpu()
                   for p in TRAIN_GRAD_SITES}

    def rel(a, b):
        return {".".join(p): float((a[p] - b[p]).abs().max()
                                   / b[p].abs().max()) for p in b}

    mh, gh = run("cpu")
    spread = rel(run("cuda")[1], run("cuda")[1])
    with deterministic(torch):
        mc, gc = run("cuda")
    loss_rel = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    grad_rel = rel(gc, gh)
    res = {"max_loss_rel": max(loss_rel.values()),
           "max_grad_rel_of_maxabs": max(grad_rel.values()),
           "loss_rel": loss_rel, "grad_rel": grad_rel,
           "card_repeat_default_algorithms": spread}
    emit({"phase": "train", "check": "card_vs_cpu", **res})
    if res["max_loss_rel"] > 1e-4 or res["max_grad_rel_of_maxabs"] > 1e-3:
        fail(f"train step: card vs CPU beyond 1e-4 / 1e-3: {res}")
    return res


def train_checkpoint(torch, cfg, host_params, batches):
    """Save after step k = 2, restore into a fresh state, one more step on
    both from the same inputs and the same generator seed, with
    deterministic cuDNN and PyTorch's deterministic algorithms: the params
    agree to 1e-6 relative."""
    import tempfile

    from rerevst_torch.io.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from rerevst_torch.train.state import (
        init_train_state,
        load_train_state,
        opt_state_tree,
        tree_leaves,
    )
    from rerevst_torch.train.step import make_train_step

    dev = torch.device("cuda")
    with deterministic(torch):
        step = make_train_step(cfg)
        up = [tuple(torch.from_numpy(b[k]).to(dev) for k in ("Content",
                                                            "Style"))
              for b in batches[:3]]
        a = init_train_state(_tree_to(host_params, dev), cfg)
        gen = torch.Generator(device=dev).manual_seed(41)
        for c, s in up[:2]:
            a, _ = step(a, c, s, gen)
        with tempfile.TemporaryDirectory(dir=HERE) as tmp:
            path = save_train_state(tmp, a.step, a.params, opt_state_tree(a))
            size_mb = os.path.getsize(path) / 2 ** 20
            b = init_train_state(_tree_to(host_params, dev), cfg)
            p, o = restore_train_state(path, b.params)
            load_train_state(b, p, o, a.step)
        for st in (a, b):
            st, _ = step(st, *up[2],
                         torch.Generator(device=dev).manual_seed(7))
        worst = 0.0
        for k in a.params:
            for path_, la in tree_leaves(a.params[k]):
                lb = _leaf(b.params[k], path_)
                la, lb = la.detach(), lb.detach()
                scale = float(la.abs().max().clamp_min(1e-30))
                worst = max(worst, float((la - lb).abs().max()) / scale)
    res = {"checkpoint_mb": size_mb, "resumed_step": b.step,
           "max_param_rel": worst}
    emit({"phase": "train", "check": "checkpoint", **res})
    if worst > 1e-6 or b.step != 3:
        fail(f"train checkpoint: resumed state diverged: {res}")
    return res


def train_profile(torch, cfg, state, step, batch, gen, step_ms):
    """torch.profiler over one step: the device's busy share of the wall
    clock and the relaxed inner loop's share of the device time (its
    profiler range), plus the relaxed loss alone by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from rerevst_torch.losses.relaxed import (
        INNER_LOOP_RANGE,
        relaxed_style_loss,
    )
    from rerevst_torch.models.vgg import vgg_features

    dev = torch.device("cuda")
    c, s = (torch.from_numpy(batch[k]).to(dev) for k in ("Content", "Style"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, c, s, gen)
        float(m["total"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # The inner loop's range is an annotation, not a kernel.
    bd = _device_breakdown(prof, wall_ms,
                           skip=(INNER_LOOP_RANGE,) + PROFILER_ROWS)
    inner_ms = max((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages()
                    if e.key == INNER_LOOP_RANGE), default=0) / 1e3
    # The relaxed loss alone (inner loop, ori and final forward) on the
    # same batch, by CUDA events.
    # The content batch stands in for the styled one: the loop's cost does
    # not depend on the image.
    vgg = state.params["vgg_loss"]
    with torch.no_grad():
        feats = vgg_features(vgg, c, "relu4_1")
    relaxed = time_ms(torch, lambda: relaxed_style_loss(
        vgg, s, feats, cfg.loss, cfg.model), iters=3, warmup=1)["ms"]
    res = {**{k: v for k, v in bd.items() if k != "top_kernels"},
           "top_kernels": bd["top_kernels"][:8],
           "inner_loop_device_ms": inner_ms,
           # None where the profiler saw no device time (then the events'
           # share below is the reading).
           "inner_loop_share_of_busy": (inner_ms / bd["device_busy_ms"]
                                        if bd["device_busy_ms"] else None),
           "relaxed_loss_events_ms": relaxed,
           "relaxed_loss_share_of_step": relaxed / step_ms}
    return res


def time_upsample_conv_forms(torch):
    """The decoder's res3.conv1 of a train step (fp32, [4, 64, 64, 256] ->
    128 through the nearest-2x upsample): the plain composition (upsample,
    then the 3x3 conv) against ``layers.upsample2x_conv3x3``'s
    parity-folded 2x2 conv, forward and forward + backward (CUDA events),
    and the kernels one forward launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from rerevst_torch.models.layers import conv2d, upsample2x_conv3x3
    from rerevst_torch.ops.resize import upsample_nearest_2x

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((4, 64, 64, 256), generator=gen, device=dev)
    p = {"w": torch.randn((3, 3, 256, 128), generator=gen, device=dev)
         * 0.02, "b": torch.zeros(128, device=dev)}
    x.requires_grad_(True)
    p["w"].requires_grad_(True)
    forms = {"plain": lambda: conv2d(p, upsample_nearest_2x(x), padding=1),
             "parity_folded": lambda: upsample2x_conv3x3(p, x)}
    out = {}
    for name, fwd in forms.items():
        def fwd_bwd():
            torch.autograd.grad(fwd().sum(), (x, p["w"]))

        out[name] = {"fwd_ms": time_ms(torch, fwd, iters=3, warmup=1)["ms"],
                     "fwd_bwd_ms": time_ms(torch, fwd_bwd, iters=3,
                                           warmup=1)["ms"]}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        out[name]["fwd_kernel_launches"] = sum(
            e.count for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and not e.key.startswith("aten::") and e.key not in PROFILER_ROWS)
    emit({"phase": "train", "upsample_conv_res3": out})
    return out


def train_host_params(torch):
    """The generator every train-like phase starts from, on the host: the
    bundled checkpoint through ``load_pretrained`` onto a seeded template
    (``vgg_loss`` regenerated with he_relu, seed 0), fp32."""
    from rerevst_torch.config import TrainConfig
    from rerevst_torch.io.torch_compat import load_pretrained
    from rerevst_torch.models.transformer import init_transformer_params

    cfg = TrainConfig()
    template = init_transformer_params(
        torch.Generator().manual_seed(cfg.seed), cfg.model,
        with_loss_net=True, vgg_scheme="he_relu")
    host, stage = load_pretrained(
        str(HERE / "models" / "demo_plum_4000.msgpack"), template)
    if stage != "subtree" or host["decoder"]["out"]["w"].dtype != \
            torch.float32:
        fail(f"train: load_pretrained gave stage {stage!r}")
    return host, stage


def train_phase(torch, host=None, stage="subtree"):
    """Phase train: ``TrainConfig()`` steps on the card (batch 4 of 256x256
    crops, fp32, every default loss, flow_iter 16) from the bundled
    checkpoint (``train_host_params``); the memory options; the card
    against the CPU; a checkpoint resumed; no hand-written kernel
    launched; a profile."""
    import dataclasses

    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.config import TrainConfig
    from rerevst_torch.train.state import init_train_state, tree_leaves
    from rerevst_torch.train.step import make_train_step

    dev = torch.device("cuda")
    cfg = TrainConfig()
    t_phase = t_setup = time.perf_counter()
    if host is None:
        host, stage = train_host_params(torch)
    batches = train_batches(TRAIN_STEPS, cfg.batch_size, cfg.fine_size,
                            seed=500)
    up = [tuple(torch.from_numpy(b[k]).to(dev) for k in ("Content", "Style"))
          for b in batches]
    state = init_train_state(_tree_to(host, dev), cfg)
    before = {(k,) + p: leaf.detach().clone() for k in state.params
              for p, leaf in tree_leaves(state.params[k])}
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    setup_s = time.perf_counter() - t_setup

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rows = []
    for i, (c, s) in enumerate(up):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        state, m = step(state, c, s, gen)
        e1.record()
        vals = {k: float(v) for k, v in m.items()}  # waits for the step
        row = {"step": i + 1, "ms": e0.elapsed_time(e1),
               "wall_ms": (time.perf_counter() - t0) * 1e3, **vals}
        rows.append(row)
        emit({"phase": "train", **row})
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"train step {i + 1}: non-finite metrics {vals}")
    launches = kernels.launch_counts()
    peak = {"plain": torch.cuda.max_memory_allocated()}
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    wall_ms = float(np.median([r["wall_ms"] for r in rows[1:]]))
    vgg_equal = all(torch.equal(leaf, before[("vgg_loss",) + p])
                    for p, leaf in tree_leaves(state.params["vgg_loss"]))
    moved = {k: any(not torch.equal(leaf, before[(k,) + p])
                    for p, leaf in tree_leaves(state.params[k]))
             for k in ("encoder", "encoder_style", "decoder")}
    if not vgg_equal or not all(moved.values()):
        fail(f"train: vgg_loss bit-equal {vgg_equal}, moved {moved}")
    if any(launches.values()):
        fail(f"train: hand-written kernels launched in a train step: "
             f"{launches}")
    del before
    prof = train_profile(torch, cfg, state, step, batches[0], gen, step_ms)
    emit({"phase": "train", "profile": {k: v for k, v in prof.items()
                                        if k != "top_kernels"}})
    del state
    torch.cuda.empty_cache()

    options = {}
    for name, kw in (("remat", {"remat": True}),
                     ("grad_accum_2", {"grad_accum": 2})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, m = _train_step_run(torch, dataclasses.replace(cfg, **kw), host,
                                dev, batches[0],
                                torch.Generator(device=dev).manual_seed(3))
        options[name] = {"wall_ms_first_step": (time.perf_counter() - t0)
                         * 1e3, "total": m["total"]}
        peak[name] = torch.cuda.max_memory_allocated()
        if not np.isfinite(m["total"]):
            fail(f"train {name}: non-finite loss {m}")
        del st
        torch.cuda.empty_cache()

    cpu = train_card_vs_cpu(torch, host)
    ck = train_checkpoint(torch, cfg, host, batches)
    forms = time_upsample_conv_forms(torch)
    res = {"config": {"batch": cfg.batch_size, "crop": cfg.fine_size,
                      "dtype": "float32", "flow_iter": cfg.loss.flow_iter,
                      "lr": cfg.lr, "steps": TRAIN_STEPS,
                      "pretrained_stage": stage},
           "setup_s": setup_s, "step_ms_median_2_to_8": step_ms,
           "step_wall_ms_median_2_to_8": wall_ms,
           "images_per_s": cfg.batch_size / step_ms * 1e3,
           "peak_gb": {k: v / 1e9 for k, v in peak.items()},
           "options": options, "launches": launches,
           "vgg_loss_bit_equal": vgg_equal, "moved": moved,
           "card_vs_cpu": cpu, "checkpoint": ck, "profile": prof,
           "upsample_conv_res3": forms,
           "steps": rows, "card": nvidia_smi(),
           "phase_s": time.perf_counter() - t_phase}
    RESULTS["train"] = res
    emit({"phase": "train", "summary": {
        k: res[k] for k in ("step_ms_median_2_to_8",
                            "step_wall_ms_median_2_to_8", "images_per_s",
                            "peak_gb", "launches", "setup_s", "phase_s")}})
    return res


# ---------------------------------------------------------------------------
# Phases adversarial and ablation: the PatchGAN step and the Figure-16 pairs
# ---------------------------------------------------------------------------

#: Steps of the adversarial phase (batch 4 of 256x256 crops, fp32,
#: flow_iter 16, an ndf-64 3-layer PatchGAN).
ADV_STEPS = 8
#: The selected G gradients held card against CPU in both phases.
ADV_G_SITES = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
               ("decoder", "filter1", "p1", "fc", "w"),
               ("encoder", "conv4_1", "w")]


def _fake_pair(torch, content, seed):
    """An injected fake pair: a whole-pixel flow (no nearest-warp tie at
    .5, where the card's and the CPU's last bits could pick other
    neighbours) and the content warped by it."""
    from rerevst_torch.ops.warp import flow_warp

    n, h, w, _ = content.shape
    flow = torch.randint(-3, 4, (n, h, w, 2),
                         generator=torch.Generator().manual_seed(seed)) \
        .float()
    return {"Second": flow_warp(content, flow, "nearest"), "FakeFlow": flow}


def _rel_errs(a, b):
    """max |a - b| / max |b| per key (b the CPU's)."""
    return {".".join(k): float((a[k] - b[k]).abs().max()
                               / b[k].abs().max().clamp_min(1e-30))
            for k in b}


def _adv_step_on(torch, cfg, host, d_host, batch, extra, dev):
    """One adversarial step on `dev` from fresh states: (metrics, the
    selected G gradients and every D gradient, on the host)."""
    from rerevst_torch.train.state import (
        init_d_state,
        init_train_state,
        tree_leaves,
    )
    from rerevst_torch.train.step import make_adversarial_train_step

    g = init_train_state(_tree_to(host, dev), cfg)
    d = init_d_state(_tree_to(d_host, dev))
    c, s = (torch.from_numpy(batch[k]).to(dev) for k in ("Content", "Style"))
    g, d, m = make_adversarial_train_step(cfg)(
        g, d, c, s, None, {k: v.to(dev) for k, v in extra.items()})
    grads = {("G",) + p: _leaf(g.params, p).grad.cpu() for p in ADV_G_SITES}
    grads.update({("D",) + p: leaf.grad.cpu()
                  for p, leaf in tree_leaves(d.params)})
    return {k: float(v) for k, v in m.items()}, grads


def _worst(errs, prefix=""):
    return max(v for k, v in errs.items() if k.startswith(prefix))


def _full_step_errors(torch, cfg, host, d_host, batch, extra, other):
    """The CPU's full adversarial step against `other`'s ('cuda': the card
    under deterministic algorithms; 'ulp': the CPU again with each style
    pixel moved by one ulp): the largest relative loss error and the
    largest G and D gradient errors over each tensor's max-abs."""
    import numpy as np

    mh, gh = _adv_step_on(torch, cfg, host, d_host, batch, extra,
                          torch.device("cpu"))
    if other == "cuda":
        with deterministic(torch):
            mo, go = _adv_step_on(torch, cfg, host, d_host, batch, extra,
                                  torch.device("cuda"))
    else:
        st = batch["Style"]
        sign = np.random.default_rng(3).choice([-1.0, 1.0], st.shape)
        moved = {**batch, "Style": np.nextafter(
            st, st + sign.astype(np.float32)).astype(np.float32)}
        mo, go = _adv_step_on(torch, cfg, host, d_host, moved, extra,
                              torch.device("cpu"))
    rel = _rel_errs(go, gh)
    return {"max_loss_rel": max(abs(mo[k] - mh[k]) / max(abs(mh[k]), 1e-12)
                                for k in mh),
            "max_g_grad_rel_of_maxabs": _worst(rel, "G."),
            "max_d_grad_rel_of_maxabs": _worst(rel, "D.")}


#: The relative size of the rounding noise of ``conv_noise``: about what
#: an fp32 sum of a few hundred products moves when its order changes
#: (sqrt(K) ulps of 2^-24 for K near 256), the card's convs against the
#: CPU's.
CONV_NOISE = 2.0 ** -20


@contextlib.contextmanager
def conv_noise(torch, seed):
    """Every fp32 conv output of the models (``layers.conv2d`` wherever it
    is imported) multiplied by 1 +- CONV_NOISE, the sign drawn per element
    from `seed`: the CPU's stand-in for the card's other summation
    orders, to measure how far a result moves under them."""
    from rerevst_torch.models import discriminator, layers, transformer, vgg

    real = layers.conv2d
    gen = torch.Generator().manual_seed(seed)

    def noisy(p, x, stride=1, padding=0):
        y = real(p, x, stride, padding)
        if y.dtype != torch.float32:
            return y
        sign = torch.randint(0, 2, y.shape, generator=gen, device="cpu")
        return y * (1 + CONV_NOISE * (2 * sign - 1).to(y))

    mods = (layers, vgg, transformer, discriminator)
    for m in mods:
        m.conv2d = noisy
    try:
        yield
    finally:
        for m in mods:
            m.conv2d = real


#: Draws of ``conv_noise`` whose largest effect sets the allowance.
NOISE_SEEDS = (0, 1, 2, 3)


def _noise_spread(torch, run, errs):
    """The largest error, key by key, of ``errs(run())`` ({group: {key:
    error}}) over the draws of ``conv_noise`` (NOISE_SEEDS): how far the
    CPU's own result moves under rounding-level noise."""
    spread = {}
    for seed in NOISE_SEEDS:
        with conv_noise(torch, seed):
            for group, e in errs(run()).items():
                into = spread.setdefault(group, {})
                for k, v in e.items():
                    into[k] = max(into.get(k, 0.0), v)
    return spread


#: The allowance never exceeds this (relative, or of the max-abs).
ALLOWANCE_CAP = 5e-2


def _allowed(card, noisy, base):
    """Keys whose card error exceeds max(base, min(2 x the CPU's own
    spread under ``conv_noise``, ALLOWANCE_CAP)): {key: [card error,
    spread]}."""
    return {k: [v, noisy[k]] for k, v in card.items()
            if v > max(base, min(2 * noisy[k], ALLOWANCE_CAP))}


def _rel_errs_floored(a, b, floor=1e-5):
    """max |a - b| over max |b| per key, the max-abs floored at `floor`
    times the largest max-abs of the key's group (its first element: D,
    G, cot): a gradient that is exactly zero in exact arithmetic (wgangp's
    output bias) is rounding noise, not a scale."""
    group = {}
    for k, t in b.items():
        group[k[0]] = max(group.get(k[0], 0.0), float(t.abs().max()))
    return {".".join(k): float((a[k] - b[k]).abs().max())
            / max(float(b[k].abs().max()), floor * group[k[0]], 1e-30)
            for k in b}


def _adv_parts(torch, cfg, host, d_host, batch, extra, dev, ref=None):
    """The adversarial step's parts on `dev`: ``compute_losses``, D's step
    (``discriminator_step``), G's GAN term (``gan_cotangent``) and G's
    backward to the selected sites.  Without `ref` each part takes the
    previous part's output; with `ref` (the CPU's parts) each part takes
    the CPU's input instead: the styled batch, the updated D, the
    cotangent.  Returns the losses, the tensors to compare (D's
    gradients, the cotangent, G's gradients) and the inputs of the next
    parts."""
    from rerevst_torch.train.state import (
        init_d_state,
        init_train_state,
        tree_leaves,
    )
    from rerevst_torch.train.step import (
        compute_losses,
        discriminator_step,
        gan_cotangent,
    )

    mode, weight = cfg.loss.gan_mode, cfg.loss.gan_weight
    c, s = (torch.from_numpy(batch[k]).to(dev) for k in ("Content", "Style"))
    g = init_train_state(_tree_to(host, dev), cfg)
    total, (m, aux) = compute_losses(
        g.params, c, s, None, cfg, {k: v.to(dev) for k, v in extra.items()})
    styled = aux["styled"] if ref is None else ref["styled"].to(dev)
    d = init_d_state(_tree_to(d_host, dev))
    loss_d = discriminator_step(d, styled.detach(), s, mode)
    d_new = d.params if ref is None else _tree_to(ref["d_new"], dev)
    g_gan, cot = gan_cotangent(d_new, styled, mode)
    cot_in = cot if ref is None else ref["cot"].to(dev)
    g_grads = torch.autograd.grad(
        [total, aux["styled"]], [_leaf(g.params, p) for p in ADV_G_SITES],
        grad_outputs=[torch.ones_like(total), cot_in * weight])
    tensors = {("D",) + p: leaf.grad.cpu() for p, leaf in tree_leaves(d.params)}
    tensors[("cot",)] = cot.detach().cpu()
    tensors.update({("G",) + p: t.cpu() for p, t in zip(ADV_G_SITES,
                                                        g_grads)})
    return {"losses": {**{k: float(v.detach()) for k, v in m.items()},
                       "loss_d": float(loss_d.detach()),
                       "loss_G_GAN": float(g_gan.detach())},
            "tensors": tensors, "styled": styled.detach().cpu(),
            "d_new": _tree_to(d.params, torch.device("cpu")),
            "cot": cot.detach().cpu()}


def adversarial_parts_card_vs_cpu(torch, cfg, host, d_host, batch, extra):
    """The step's parts on the card (deterministic algorithms) against the
    CPU, each fed the CPU's inputs, with bars that allow for the step's
    conditioning: each loss within max(1e-4, 2 e) relative and each tensor
    within max(1e-3, 2 e) of its max-abs (floored, ``_rel_errs_floored``),
    where e is the largest change of the CPU's own result over the draws
    of ``conv_noise``; the allowance 2 e is capped at ALLOWANCE_CAP.
    Where the parts are well-conditioned, e is far below the base
    bars."""
    cpu = torch.device("cpu")
    ref = _adv_parts(torch, cfg, host, d_host, batch, extra, cpu)

    def loss_errs(run):
        return {k: abs(run["losses"][k] - v) / max(abs(v), 1e-12)
                for k, v in ref["losses"].items()}

    def errs(run):
        return {"loss": loss_errs(run),
                "tensor": _rel_errs_floored(run["tensors"], ref["tensors"])}

    spread = _noise_spread(torch, lambda: _adv_parts(
        torch, cfg, host, d_host, batch, extra, cpu, ref), errs)
    noise_l, noise_t = spread["loss"], spread["tensor"]
    with deterministic(torch):
        card = _adv_parts(torch, cfg, host, d_host, batch, extra,
                          torch.device("cuda"), ref)
    card_l = loss_errs(card)
    card_t = _rel_errs_floored(card["tensors"], ref["tensors"])
    return {"max_loss_rel": max(card_l.values()),
            "max_tensor_rel_of_maxabs": max(card_t.values()),
            "worst_tensor": max(card_t, key=card_t.get),
            "noise_max_loss_rel": max(noise_l.values()),
            "noise_max_tensor_rel_of_maxabs": max(noise_t.values()),
            "tensors_over_1e-3": {k: [v, noise_t[k]]
                                  for k, v in card_t.items() if v > 1e-3},
            "over_bar": {**_allowed(card_l, noise_l, 1e-4),
                         **_allowed(card_t, noise_t, 1e-3)},
            "loss_d": card["losses"]["loss_d"],
            "loss_G_GAN": card["losses"]["loss_G_GAN"]}


def adversarial_card_vs_cpu(torch, host, d_host):
    """Each gan_mode at 64x64, flow_iter 2, an injected fake pair, the
    phase's PatchGAN, on phase train's check batch (seed 300): the step's
    parts on the card against the CPU, each part fed the same inputs
    (``adversarial_parts_card_vs_cpu``): losses to 1e-4 relative, D's
    gradients, G's GAN cotangent and the selected G gradients to 1e-3 of
    each tensor's max-abs, or to twice the largest change of the CPU's own
    result over the draws of ``conv_noise`` where that is larger.

    Why the allowance: at this size some results are ill-conditioned.
    D's gradients pass through batch norms over 2 x 16 x 16 values behind
    leaky ReLUs, so a pre-activation at the rounding floor that changes
    side moves a gradient by percents of its max-abs (bn1's bias), and a
    ReLU kink ahead of the filter predictor moves its and the content
    encoder's gradients by about 1e-3 of their max-abs.  Recorded beside
    the check, not held to
    it: the same parts and the whole step on a second batch (seed 710),
    and the CPU's own change there when each style pixel moves by one
    ulp."""
    from rerevst_torch.config import LossConfig, TrainConfig

    def case(seed, flow_seed):
        batch = train_batches(1, 2, 64, seed=seed)[0]
        return batch, _fake_pair(torch, torch.from_numpy(batch["Content"]),
                                 flow_seed)

    batch, extra = case(300, 5)
    out = {}
    for mode in ("lsgan", "vanilla", "wgangp"):
        cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False,
                                          adversarial_loss=True,
                                          gan_mode=mode))
        out[mode] = adversarial_parts_card_vs_cpu(torch, cfg, host, d_host,
                                                  batch, extra)
        if out[mode]["over_bar"]:
            fail(f"adversarial {mode}: card vs CPU beyond the bars: "
                 f"{out[mode]}")
    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False,
                                      adversarial_loss=True))
    batch, extra = case(710, 11)
    out["recorded_seed_710_lsgan"] = {
        "parts": adversarial_parts_card_vs_cpu(torch, cfg, host, d_host,
                                               batch, extra),
        **{f"whole_step_{other}": _full_step_errors(
            torch, cfg, host, d_host, batch, extra, other)
           for other in ("cuda", "ulp")}}
    emit({"phase": "adversarial", "check": "card_vs_cpu", **out})
    return out


def adversarial_resume(torch, host, d_host):
    """Two adversarial steps at 64x64 (flow_iter 2, injected pairs) under
    deterministic algorithms, with G's ``ckpt-step*`` and D's
    ``netD-step*.msgpack`` saved after the first and restored into fresh
    states: the resumed D after the second step is bit-equal to the
    uninterrupted one; G's params agree to 1e-6 relative (its backward
    gathers through the warp with atomics)."""
    import tempfile

    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.io.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from rerevst_torch.train.loop import _restore_d_state, _save_d_state
    from rerevst_torch.train.state import (
        init_d_state,
        init_train_state,
        load_train_state,
        opt_state_tree,
        tree_leaves,
    )
    from rerevst_torch.train.step import make_adversarial_train_step

    dev = torch.device("cuda")
    cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False,
                                      adversarial_loss=True))
    batches = train_batches(2, 2, 64, seed=720)
    up = [(torch.from_numpy(b["Content"]).to(dev),
           torch.from_numpy(b["Style"]).to(dev),
           {k: v.to(dev) for k, v in _fake_pair(
               torch, torch.from_numpy(b["Content"]), 20 + i).items()})
          for i, b in enumerate(batches)]
    step = make_adversarial_train_step(cfg)
    with deterministic(torch):
        g = init_train_state(_tree_to(host, dev), cfg)
        d = init_d_state(_tree_to(d_host, dev))
        g, d, _ = step(g, d, *up[0][:2], None, up[0][2])
        with tempfile.TemporaryDirectory(dir=HERE) as tmp:
            save_train_state(tmp, g.step, g.params, opt_state_tree(g))
            d_path = _save_d_state(tmp, d)
            d_mb = os.path.getsize(d_path) / 2 ** 20
            g2 = init_train_state(_tree_to(host, dev), cfg)
            p, o = restore_train_state(
                os.path.join(tmp, f"ckpt-step{g.step:08d}.msgpack"),
                g2.params)
            load_train_state(g2, p, o, g.step)
            d2 = init_d_state(_tree_to(d_host, dev))
            if not _restore_d_state(tmp, d2):
                fail("adversarial: no netD-step file to restore")
        for gs, ds in ((g, d), (g2, d2)):
            step(gs, ds, *up[1][:2], None, up[1][2])
    d_equal = all(torch.equal(a, b) for (_, a), (_, b) in
                  zip(tree_leaves(d.params), tree_leaves(d2.params)))
    g_rel = 0.0
    for k in g.params:
        for path, la in tree_leaves(g.params[k]):
            lb = _leaf(g2.params[k], path)
            scale = float(la.detach().abs().max().clamp_min(1e-30))
            g_rel = max(g_rel, float((la - lb).detach().abs().max()) / scale)
    res = {"netD_msgpack_mb": d_mb, "resumed_d_step": d2.step,
           "d_params_bit_equal": d_equal, "g_max_param_rel": g_rel}
    emit({"phase": "adversarial", "check": "resume", **res})
    if not d_equal or d2.step != 2 or g_rel > 1e-6:
        fail(f"adversarial: the resumed step diverged: {res}")
    return res


def adversarial_phase(torch, host):
    """Phase adversarial: ``TrainConfig(loss=LossConfig(adversarial_loss=
    True))`` steps on the card (batch 4 of 256x256 crops, fp32, flow_iter
    16) from the bundled generator and a seeded PatchGAN (ndf 64, 3
    layers, 'normal'): the median step, images/s, peak memory and D's
    share of a profiled step (its profiler range); every metric finite; no
    hand-written kernel launched; the card against the CPU in each
    gan_mode; G's and D's checkpoints resumed."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rerevst_torch import kernels
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.models.discriminator import init_discriminator_params
    from rerevst_torch.train.state import init_d_state, init_train_state
    from rerevst_torch.train.step import D_RANGE, make_adversarial_train_step

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = TrainConfig(loss=LossConfig(adversarial_loss=True))
    d_host = init_discriminator_params(
        torch.Generator().manual_seed(cfg.seed + 99), ndf=64, n_layers=3,
        scheme="normal")
    batches = train_batches(ADV_STEPS, cfg.batch_size, cfg.fine_size,
                            seed=700)
    up = [tuple(torch.from_numpy(b[k]).to(dev) for k in ("Content", "Style"))
          for b in batches]
    g = init_train_state(_tree_to(host, dev), cfg)
    d = init_d_state(_tree_to(d_host, dev))
    step = make_adversarial_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rows = []
    for i, (c, s) in enumerate(up):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g, d, m = step(g, d, c, s, gen)
        e1.record()
        vals = {k: float(v) for k, v in m.items()}
        rows.append({"step": i + 1, "ms": e0.elapsed_time(e1), **vals})
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"adversarial step {i + 1}: non-finite metrics {vals}")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"adversarial: hand-written kernels launched: {launches}")
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))

    # D's share: its profiler range's device time over the step's.
    c, s = up[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g, d, m = step(g, d, c, s, gen)
        float(m["total"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    bd = _device_breakdown(prof, wall_ms, skip=(D_RANGE,) + PROFILER_ROWS)
    d_ms = max((getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0))
                for e in prof.key_averages() if e.key == D_RANGE),
               default=0) / 1e3
    del g, d
    torch.cuda.empty_cache()

    cpu = adversarial_card_vs_cpu(torch, host, d_host)
    resume = adversarial_resume(torch, host, d_host)
    res = {"config": {"batch": cfg.batch_size, "crop": cfg.fine_size,
                      "dtype": "float32", "flow_iter": cfg.loss.flow_iter,
                      "gan_mode": cfg.loss.gan_mode, "ndf": 64,
                      "d_init": "normal", "steps": ADV_STEPS},
           "step_ms_median_2_to_8": step_ms,
           "images_per_s": cfg.batch_size / step_ms * 1e3,
           "peak_gb": peak / 1e9,
           "d_range_device_ms": d_ms,
           "d_share_of_busy": (d_ms / bd["device_busy_ms"]
                               if bd["device_busy_ms"] else None),
           "profiled_step": {k: v for k, v in bd.items()
                             if k != "top_kernels"},
           "first": {k: rows[0][k] for k in ("loss_d", "loss_G_GAN")},
           "last": {k: rows[-1][k] for k in ("loss_d", "loss_G_GAN")},
           "launches": launches, "card_vs_cpu": cpu, "resume": resume,
           "steps": rows, "card": nvidia_smi(),
           "phase_s": time.perf_counter() - t_phase}
    RESULTS["adversarial"] = res
    emit({"phase": "adversarial", "summary": {
        k: res[k] for k in ("step_ms_median_2_to_8", "images_per_s",
                            "peak_gb", "d_range_device_ms",
                            "d_share_of_busy", "first", "last", "launches",
                            "phase_s")}})
    return res


def ablation_batch(torch, frames, seed, which):
    """A synthetic Figure-16 batch in the loaders' format, made on the
    host from `frames` (``{"Content", "Style"}``, as ``train_batches``
    gives them): a smooth whole-pixel flow (a global shift plus a slow
    swirl), the next frame warped by it plus noise, and occlusion masks
    of random discs (3-D, as the loaders give them)."""
    import numpy as np

    from rerevst_torch.ops.warp import flow_warp

    rng = np.random.default_rng(seed)
    content, style = frames["Content"], frames["Style"]
    n, hw = content.shape[:2]
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    flow = np.empty((n, hw, hw, 2), np.float32)
    mask = np.ones((n, hw, hw), np.float32)
    for i in range(n):
        sx, sy = rng.integers(-6, 7, 2)
        a = rng.uniform(2, 5)
        flow[i, ..., 0] = np.round(sx + a * np.sin(yy / hw * 2 * np.pi))
        flow[i, ..., 1] = np.round(sy + a * np.cos(xx / hw * 2 * np.pi))
        for _ in range(6):
            cy, cx, r = rng.uniform(0, hw, 2).tolist() + [rng.uniform(4, 20)]
            mask[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 0.0
    nxt = flow_warp(torch.from_numpy(content), torch.from_numpy(flow),
                    "nearest").numpy()
    nxt = nxt + rng.standard_normal(nxt.shape).astype(np.float32) * 0.02
    flow_key, mask_key = (("BackwardFlow", "BackwardMask") if which == "mpi"
                          else ("ForwardFlow", "ForwardMask"))
    return {"Content": content, "Style": style, "NextContent": nxt,
            flow_key: flow, mask_key: mask}


def _ablation_step_on(torch, cfg, host, batch, dev, gen=None):
    """One train step on an ablation batch on `dev` from a fresh state:
    (metrics, the selected gradients, the step's ms by CUDA events or None
    on the CPU)."""
    from rerevst_torch.train.state import init_train_state
    from rerevst_torch.train.step import make_train_step

    state = init_train_state(_tree_to(host, dev), cfg)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    extra = {k: v for k, v in t.items() if k not in ("Content", "Style")}
    step = make_train_step(cfg)
    if dev.type == "cpu":
        state, m = step(state, t["Content"], t["Style"], gen, extra)
        ms = None
    else:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, t["Content"], t["Style"], gen, extra)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
    grads = {p: _leaf(state.params, p).grad.cpu() for p in ADV_G_SITES}
    return {k: float(v) for k, v in m.items()}, grads, ms


def ablation_phase(torch, host):
    """Phase ablation: a ``use_mpi`` and a ``use_video`` train step at 4 x
    256x256 (fp32, flow_iter 16; each run twice from the same state, the
    second timed warm) on synthetic pairs made on the host
    (the card's machine has no cv2 and no Sintel); each ablation at 64x64
    (flow_iter 2) on the card against the CPU, losses to 1e-4 relative
    and the selected gradients to 1e-3 of their max-abs, or to twice the
    largest change of the CPU's own result over the draws of
    ``conv_noise`` where that is larger (a ReLU kink at the rounding
    floor moves the filter predictor's and the content encoder's
    gradients by about 1e-3 of their max-abs), held on phase train's check
    batch (seed 300) and recorded on a second one (seed 810); one U-Net
    forward at 256x256 (num_downs 8, ngf 64, seeded weights) on the card
    against the CPU.  No hand-written kernel launches."""
    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.config import LossConfig, TrainConfig
    from rerevst_torch.models.unet import init_unet_params, unet

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    kernels.reset_launches()
    res = {"steps": {}, "card_vs_cpu": {}}
    for which in ("mpi", "video"):
        cfg = TrainConfig(use_mpi=which == "mpi", use_video=which == "video")
        batch = ablation_batch(torch, train_batches(
            1, cfg.batch_size, cfg.fine_size, seed=800)[0], 800, which)
        # Two steps from the same state; the second's time is the warm one.
        runs = [_ablation_step_on(torch, cfg, host, batch, dev,
                                  torch.Generator(device=dev).manual_seed(1))
                for _ in range(2)]
        m, ms = runs[1][0], runs[1][2]
        if not all(np.isfinite(v) for v in m.values()) or \
                m["temporal_gt"] <= 0:
            fail(f"ablation {which}: metrics {m}")
        res["steps"][which] = {"ms": ms, "first_ms": runs[0][2],
                               "images_per_s": cfg.batch_size / ms * 1e3,
                               **m}
        emit({"phase": "ablation", "step": which, **res["steps"][which]})

        cfg = TrainConfig(loss=LossConfig(flow_iter=2, data_sigma=False))
        for seed, held in ((300, True), (810, False)):
            small = ablation_batch(
                torch, train_batches(1, 2, 64, seed=seed)[0], seed, which)
            cpu = torch.device("cpu")
            mh, gh, _ = _ablation_step_on(torch, cfg, host, small, cpu)
            with deterministic(torch):
                mc, gc, _ = _ablation_step_on(torch, cfg, host, small, dev)

            def loss_errs(m):
                return {k: abs(m[k] - v) / max(abs(v), 1e-12)
                        for k, v in mh.items()}

            card_l, card_g = loss_errs(mc), _rel_errs(gc, gh)
            r = {"max_loss_rel": max(card_l.values()),
                 "max_grad_rel_of_maxabs": max(card_g.values()),
                 "grad_rel": card_g}
            if not held:
                res["card_vs_cpu"][f"{which}_recorded_seed_{seed}"] = r
                continue

            def errs(run):
                m, g, _ = run
                return {"loss": loss_errs(m), "grad": _rel_errs(g, gh)}

            spread = _noise_spread(torch, lambda: _ablation_step_on(
                torch, cfg, host, small, cpu), errs)
            noise_l, noise_g = spread["loss"], spread["grad"]
            r["noise_grad_rel"] = noise_g
            r["over_bar"] = {**_allowed(card_l, noise_l, 1e-4),
                             **_allowed(card_g, noise_g, 1e-3)}
            res["card_vs_cpu"][which] = r
            if r["over_bar"]:
                fail(f"ablation {which}: card vs CPU beyond the bars: {r}")

    # The seeded normal(0, 0.02) init: its tanh output stays below 0.1,
    # far from saturation (weights x2 already saturate 97% of it).
    params = init_unet_params(torch.Generator().manual_seed(5), ngf=64,
                              num_downs=8)
    x = torch.randn((1, 256, 256, 3),
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = unet(params, x, num_downs=8)
        on_card = _tree_to(params, dev)
        xc = x.to(dev)
        got = unet(on_card, xc, num_downs=8).cpu()
        t = time_ms(torch, lambda: unet(on_card, xc, num_downs=8), iters=5,
                    warmup=1)
    unet_err = float((got - want).abs().max() / want.abs().max())
    res["unet"] = {"shape": list(got.shape), "max_rel_of_maxabs": unet_err,
                   "ms": t["ms"], "out_absmax": float(want.abs().max())}
    if tuple(got.shape) != (1, 256, 256, 3) or not unet_err <= 1e-4:
        fail(f"ablation: unet card vs CPU {res['unet']}")
    res["launches"] = kernels.launch_counts()
    if any(res["launches"].values()):
        fail(f"ablation: hand-written kernels launched: {res['launches']}")
    res["card"] = nvidia_smi()
    res["phase_s"] = time.perf_counter() - t_phase
    RESULTS["ablation"] = res
    emit({"phase": "ablation", "summary": res})
    return res


def fetch_overlap(torch, session, clip):
    """One stylize_video with timing events: after each chunk's launch (on
    the compute stream) and after each fetch's copy (on the session's copy
    stream).  For each chunk k-1 whose fetch follows chunk k's launch, the
    milliseconds from the end of k-1's copy to the end of chunk k's work: a
    positive value means the copy did not wait for chunk k's kernels."""
    stylize, fetch = session._stylize, session._fetch
    done, copied = [], []

    def _stylize(x):
        out = stylize(x)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        done.append(ev)
        return out

    def _fetch(out, *ready):
        host = fetch(out, *ready)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(session._streams["fetch"])
        copied.append(ev)
        return host

    session._stylize, session._fetch = _stylize, _fetch
    try:
        for _ in session.stylize_video(clip, batch_size=BATCH):
            pass
        torch.cuda.synchronize()
    finally:
        del session._stylize, session._fetch
    return [copied[k].elapsed_time(done[k + 1])
            for k in range(len(done) - 1)]


def pipeline(torch, session):
    """Pass 2 of the warm f16 stylize_video on the 33-frame clip: the wall
    time of three unprofiled runs, the device's busy time against the wall
    clock under torch.profiler (the idle share), and whether each fetch's
    copy ended before the next chunk's kernels did."""
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in session.stylize_video(clip, batch_size=BATCH):
            pass
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    tr = trace_stylize_video(torch, session)
    lead = fetch_overlap(torch, session, clip)
    res = {"warm_wall_ms": walls, "warm_wall_ms_median": sorted(walls)[1],
           "profiled_wall_ms": tr["wall_ms_profiled"],
           "device_busy_ms": tr["device_busy_ms"],
           "device_idle_share": tr["device_idle_share"],
           "copy_k_minus_1_ends_before_chunk_k_ms": lead}
    RESULTS["pipeline"] = res
    emit({"phase": "pipeline", "session": "f16", **res})
    return res


def time_vgg_convs(torch):
    """rr_conv3x3 at the VGG shapes of VGG_CONVS, f16, beside its plain
    version and one F.conv2d call: conv1_1 (C = 3: the narrow kernel),
    conv2_1 (C = 64: the streamed kernel in two channel tiles) and the C >=
    128 shapes (the wide kernel); then IGEMM_C32 (the cp.async + mma.sync
    implicit GEMM).  Each is checked against its plain version first."""
    import torch.nn.functional as F

    from rerevst_torch import kernels
    from rerevst_torch.kernels.conv3x3 import design

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    for site, shape, o in VGG_CONVS + [IGEMM_C32]:
        x, w, b = conv_inputs(torch, shape, o, torch.float16, gen)
        got = kernels.conv3x3_implicit_gemm(x, w, b)
        want = kernels.conv3x3_implicit_gemm_plain(x, w, b)
        if not conv_within_tolerance(torch, got, want, x, w, b):
            fail(f"conv3x3_implicit_gemm {shape}->{o}: disagrees with plain")
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        xl = x.permute(0, 3, 1, 2)
        k = time_ms(torch, lambda: kernels.conv3x3_implicit_gemm(x, w, b),
                    iters=10, warmup=2)
        pl = time_ms(torch,
                     lambda: kernels.conv3x3_implicit_gemm_plain(x, w, b),
                     iters=3, warmup=1)
        lib = time_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1),
                      iters=10, warmup=2)
        bound, by, t_bytes, t_ops = conv_bound(x, w, o)
        row = {"kernel": "conv3x3_implicit_gemm", "site": site,
               "design": design(shape[-1], x.dtype),
               "shape": shape, "O": o, "dtype": "float16",
               "max_abs_err": err, "ms": k["ms"], "plain_ms": pl["ms"],
               "library_ms": lib["ms"], "bound_ms": bound, "bound_by": by,
               "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
               "of_bound": bound / k["ms"],
               "tflops": 2 * x.numel() * 9 * o / k["ms"] / 1e9,
               "host_paced": k["host_paced"] or lib["host_paced"]}
        rows.append(row)
        RESULTS["times"].append(row)
        emit({"phase": "time", **row})
        del x, w, b, wl, xl
        torch.cuda.empty_cache()
    return rows


def kernel_resources(build) -> dict:
    """Registers, spills and ptxas's notes (a serialized wgmma shows here)
    of each instance of the streamed C = 64, the wide and the narrow conv
    kernels and of the filter pair kernel.  A spill fails the phase: the
    designs count on keeping their fragments and accumulators in registers;
    so does a note that the wide kernel's wgmmas are serialized."""
    import re

    dts = {"f": "fp32", "6__half": "f16", "13__nv_bfloat16": "bf16"}
    out = {}
    for name, info in build.ptxas_report("conv3x3.cu").items():
        m = re.search(r"conv3x3_(stream|wide)_kernelI(6__half|13__nv_bfloat16)"
                      r"Li(\d+)E", name)
        if m:
            out[f"conv3x3_{m.group(1)}_kernel<{dts[m.group(2)]}, "
                f"N={m.group(3)}>"] = info
        m = re.search(r"conv3x3_narrow_kernelI(6__half|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", name)
        if m:
            out[f"conv3x3_narrow_kernel<{dts[m.group(1)]}, C={m.group(2)}, "
                f"N={m.group(3)}>"] = info
    n_conv = len(out)
    n_wide = sum(k.startswith("conv3x3_wide") for k in out)
    if n_wide != 12:
        fail(f"ptxas reported {n_wide} wide conv kernels, not 12")
    n_narrow = sum(k.startswith("conv3x3_narrow") for k in out)
    if n_narrow != 28:
        fail(f"ptxas reported {n_narrow} narrow conv kernels, not 28")
    serialized = [k for k, v in out.items() if k.startswith("conv3x3_wide")
                  and any("wgmma" in n and "serializ" in n
                          for n in v["notes"])]
    if serialized:
        fail(f"ptxas serialized the wgmmas of {serialized}: {out}")
    for name, info in build.ptxas_report("filter_chain.cu").items():
        m = re.search(r"filter_pair_kernelI(f|6__half|13__nv_bfloat16)E", name)
        if m:
            out[f"filter_pair_kernel<{dts[m.group(1)]}>"] = info
    if not n_conv:
        fail("ptxas reported no streamed conv kernel")
    if len(out) - n_conv != 3:
        fail(f"ptxas reported {len(out) - n_conv} filter pair kernels, not 3")
    spilled = [k for k, v in out.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)]
    if spilled:
        fail(f"ptxas: registers spilled in {spilled}: {out}")
    return out


def main() -> int:
    t_main = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "the card", file=sys.stderr)
        return 2
    if not (HERE / "rerevst_torch" / "__init__.py").is_file():
        print("chip_smoke: rerevst_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import rerevst_torch

    if Path(rerevst_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: imported a rerevst_torch from elsewhere",
              file=sys.stderr)
        return 2
    from rerevst_torch.kernels import _build

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    RESULTS["device"] = {"name": name, "capability": cap, "nvidia_smi": smi}
    emit({"phase": "device", "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    # 2. build, and what ptxas says of the streamed conv and filter kernels
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(HERE))})
    RESULTS["ptxas"] = kernel_resources(_build)
    emit({"phase": "ptxas", "kernels": RESULTS["ptxas"]})

    # 3. kernels vs plain on the card
    errs, n_checks = check_kernels(torch)
    emit({"phase": "check", "checks": n_checks, "max_abs_err": errs})

    # 4. end to end
    sessions, counts_by = run_e2e(torch)
    check_against_cpu(torch)
    check_pth(torch)
    temporal(torch, sessions)
    igemm_counts = drive_implicit_gemm(torch)
    long = long_clip(torch)
    native_prep(torch, sessions["f16"])
    ms = multistyle(torch, errs)
    served = serve_phase(torch)
    host, stage = train_host_params(torch)
    trained = train_phase(torch, host, stage)
    adv = adversarial_phase(torch, host)
    abl = ablation_phase(torch, host)
    del host

    # 5. times
    tot, filter_bound_by = time_kernels(torch)
    conv_tot = time_convs(torch)
    vgg_rows = time_vgg_convs(torch)
    pipeline(torch, sessions["f16"])
    for key, sess in (("pass2", "f16"), ("pass2_pairlane", "f16_pairlane"),
                      ("pass2_per_frame", "pf_f16")):
        p2 = time_pass2(torch, sessions[sess])
        p2["card"] = smi
        RESULTS[key] = p2
        emit({"phase": "time", "session": sess, **p2})
    for key, trace, sess in (("trace", trace_stylize_video, "f16"),
                             ("trace_pass2", trace_pass2, "f16"),
                             ("trace_pass2_pairlane", trace_pass2,
                              "f16_pairlane"),
                             ("trace_pass2_per_frame", trace_pass2,
                              "pf_f16")):
        tr = trace(torch, sessions[sess])
        tr["card"] = smi
        RESULTS[key] = tr
        emit({"phase": key, "session": sess,
              **{k: v for k, v in tr.items() if k != "top_kernels"}})

    # 6. summary lines.  Times are per Pass-2 batch (summed over the
    # kernel's sites), or per pair of conv benchmark calls for the
    # implicit-GEMM conv; launches are counted over one run of each path.
    meta = {
        "norm_affine_clamp": ("rerevst_torch/csrc/norm_affine.cu",
                              "rerevst_tpu/kernels/norm_affine.py:41", "bytes",
                              "stylize_video f16", counts_by["f16"]),
        "dynamic_filter_pair": ("rerevst_torch/csrc/filter_chain.cu",
                                "rerevst_tpu/kernels/filter_chain.py:55",
                                filter_bound_by, "stylize_video f16",
                                counts_by["f16"]),
        "conv3x3_implicit_gemm": (
            "rerevst_torch/csrc/conv3x3.cu",
            "rerevst_tpu/kernels/conv3x3.py:81",
            conv_tot["conv3x3_implicit_gemm"]["bound_by"],
            "standalone at scripts/bench_conv3x3.py's shapes (no model path)",
            igemm_counts),
        "conv3x3_pairlane": ("rerevst_torch/csrc/conv3x3.cu",
                             "rerevst_tpu/kernels/conv3x3.py:210",
                             conv_tot["conv3x3_pairlane"]["bound_by"],
                             "stylize_video f16 pairlane",
                             counts_by["f16_pairlane"]),
    }
    times = {k: (v[0], v[1], v[2], None) for k, v in tot.items()}
    times.update({k: (v["ms"], v["plain_ms"], v["bound_ms"], v["library_ms"])
                  for k, v in conv_tot.items()})
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": times[k][2],
         "bound_by": by, "library_ms": times[k][3], "path": path,
         "launches_per_frame_path": counts_by[
             "pf_f16_pairlane" if k == "conv3x3_pairlane" else "pf_f16"][k],
         "launches_long_clip": long["f16"]["launches"][k],
         "launches_long_clip_pass1": long["f16"]["launches_pass1"][k],
         "launches_multistyle": ms["f16"]["launches"][k],
         "launches_serve": served["launches_serve"][k],
         "launches_train": trained["launches"][k],
         "launches_adversarial": adv["launches"][k],
         "launches_ablation": abl["launches"][k]}
        for k, (src, rep, by, path, counts) in meta.items()]}
    for entry in line["kernels"]:
        if entry["name"] == "conv3x3_implicit_gemm":
            entry["launches_by_design"] = \
                RESULTS["implicit_gemm_launches_by_design"]
            # Each 16-bit design at its VGG (or IGEMM_C32) sites.
            entry["designs"] = {}
            for r in vgg_rows:
                entry["designs"].setdefault(r["design"], []).append(
                    {k: r[k] for k in ("site", "shape", "O", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "max_abs_err")})
    RESULTS["kernels"] = line["kernels"]
    RESULTS["seconds"] = time.perf_counter() - t_main
    _save()
    emit({"phase": "done", "seconds": RESULTS["seconds"]})
    emit(line)
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
