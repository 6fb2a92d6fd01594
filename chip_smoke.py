#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rerevst_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device  — the card's name, compute capability (must be 9.0) and power limit;
2. build   — compiles ``rerevst_torch/csrc/*.cu`` for sm_90a (first use);
3. check   — each kernel against its plain PyTorch version on the card, at the
             main path's shapes (batch 16, 512x512 content padded to 640x640)
             plus ragged ones, in f16, bf16 and fp32;
4. e2e     — ``Stylization.stylize_video`` on a seeded 33-frame 512x512 clip
             with the bundled checkpoint, in f16 and in fp32: shapes, launch
             counts per Pass-2 batch, f16-vs-fp32 pixel error, and a small
             clip held against the port's plain CPU path;
5. times   — each kernel and its plain version at every main-path site
             (device time from CUDA events, and the host's own cost per
             call), the bound, Pass-2 frames/s, and torch.profiler traces
             of one f16 stylize_video (device busy vs wall clock) and of
             Pass 2 alone (where a batch's device time goes);
6. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last
   line ``{"ok": true, "device": {...}}``.

Tolerances: a kernel agrees with its plain version to 1e-5 of the output's
scale in fp32, and within one ulp of the storage dtype in f16/bf16 (both
compute in fp32 and round once).  End to end, f16 stays within 1e-3 mean
|delta| per pixel ([0,1] scale) of fp32, the repository's precision bar,
and the card's fp32 frames stay within 1 count of the CPU path's.

Needs one CUDA card and the repository beside this file; imports nothing
of JAX.  Detailed results go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
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
    for shape in [(BATCH, p // 8, p // 8, 32), (3, 7, 11, 32)]:
        for dtype in dtypes:
            x, f1, f2 = filter_inputs(torch, shape, dtype, gen)
            got = kernels.dynamic_filter_pair(x, f1, f2)
            torch.cuda.synchronize()
            want = kernels.dynamic_filter_pair_plain(x, f1, f2)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            ok = within_tolerance(torch, got, want)
            RESULTS["checks"].append(
                {"kernel": "dynamic_filter_pair", "shape": shape,
                 "dtype": str(dtype), "max_abs_err": err, "scale": scale,
                 "ok": ok})
            if not ok:
                fail(f"dynamic_filter_pair {shape} {dtype}: max |kernel - "
                     f"plain| = {err} at scale {scale}")
            errs["dynamic_filter_pair"] = max(errs["dynamic_filter_pair"], err)
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
    t_bytes = (2 * x.numel() * 2 + 2 * 32 * 32 * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = rows * 2 * (2 * 32 * 32) / FP32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = {"kernel": "dynamic_filter_pair", "site": "filter1..3 (each)",
           "shape": shape, "dtype": "float16",
           "launches_per_batch": FILTER_SITES, "ms": k["ms"],
           "plain_ms": pl["ms"], "bound_ms": bound, "bound_by": bound_by,
           "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
           "host_ms": k["host_ms"], "plain_host_ms": pl["host_ms"],
           "host_paced": k["host_paced"] or pl["host_paced"]}
    RESULTS["times"].append(row)
    emit({"phase": "time", **row})
    tot["dynamic_filter_pair"] = [FILTER_SITES * v
                                  for v in (k["ms"], pl["ms"], bound)]
    return tot, bound_by


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


def pixel_error(a, b) -> dict:
    """Per-pixel uint8 error of two rendered clips ([0,1] units = counts/255),
    as rerevst_tpu's eval/parity.py reports it."""
    import numpy as np

    d = np.concatenate([np.abs(x.astype(np.int16) - y.astype(np.int16)).ravel()
                        for x, y in zip(a, b)])
    return {"mean_01": float(d.mean() / 255.0), "max_counts": int(d.max()),
            "frac_gt1": float((d > 1).mean())}


def run_e2e(torch):
    import numpy as np

    from rerevst_torch import kernels
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)
    style = synth_style(CONTENT, CONTENT, seed=1)
    n_batches = -(-CLIP_FRAMES // BATCH)
    outs, sessions, main_counts = {}, {}, None
    for dtype in (torch.float16, torch.float32):
        t0 = time.perf_counter()
        s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype), device="cuda")
        s.prepare_style(style)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames = list(s.stylize_video(clip, batch_size=BATCH))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {"norm_affine_clamp": 11 * n_batches,
                "dynamic_filter_pair": 3 * n_batches}
        if counts != want:
            fail(f"{dtype}: kernel launches {counts}, expected {want} "
                 f"({n_batches} Pass-2 batches)")
        if len(frames) != CLIP_FRAMES:
            fail(f"{dtype}: {len(frames)} frames out of {CLIP_FRAMES}")
        for f in frames:
            if f.shape != (CONTENT, CONTENT, 3) or f.dtype != np.uint8:
                fail(f"{dtype}: frame {f.shape} {f.dtype}")
        if np.stack(frames).std() < 1.0:
            fail(f"{dtype}: constant output")
        if dtype == torch.float16:
            main_counts = counts
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # The same clip again: the first call above includes cuDNN's
        # algorithm choice and CUDA module loading.
        t0 = time.perf_counter()
        for _ in s.stylize_video(clip, batch_size=BATCH):
            pass
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        emit({"phase": "e2e", "dtype": str(dtype), "frames": len(frames),
              "launches": counts, "pass2_batches": n_batches,
              "setup_s": t_setup, "stylize_video_wall_s": wall,
              "stylize_video_fps_wall": CLIP_FRAMES / wall,
              "warm_wall_s": warm, "warm_fps_wall": CLIP_FRAMES / warm,
              "peak_mem_gb": peak_gb, "pass1_mode": s.pass1_mode})
        outs[dtype], sessions[dtype] = frames, s
    err = pixel_error(outs[torch.float16], outs[torch.float32])
    emit({"phase": "e2e", "f16_vs_fp32": err, "bar_mean_01": 1e-3})
    RESULTS["f16_vs_fp32"] = err
    if not err["mean_01"] <= 1e-3:
        fail(f"f16 vs fp32 mean |delta| {err['mean_01']} > 1e-3")
    return sessions, main_counts, err


def check_against_cpu(torch):
    """The card's fp32 path (kernels + cuDNN) against the port's plain CPU
    path on a small clip: uint8 within 1 count."""
    import numpy as np

    from rerevst_torch.api import Stylization

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = synth_clip(9, 64, 112, seed=2)
    style = synth_style(64, 64, seed=3)
    outs = []
    for dev in ("cuda", "cpu"):
        s = Stylization(ckpt, device=dev)
        s.prepare_style(style)
        outs.append(list(s.stylize_video(clip, batch_size=4)))
    d = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
            for a, b in zip(*outs))
    emit({"phase": "e2e", "cuda_fp32_vs_cpu_fp32_max_counts": d})
    if d > 1:
        fail(f"card vs CPU path differ by {d} counts")


def time_pass2(torch, session):
    """Device time of one Pass-2 batch (16 padded 640x640 frames, f16):
    encode + decode_global, CUDA events around the stylize call."""
    clip = synth_clip(BATCH, CONTENT, CONTENT, seed=4)
    x = session._upload(session._prep_batch_host(clip))
    t = time_ms(torch, lambda: session._stylize(x), iters=10, warmup=2)
    return {"pass2_batch_ms": t["ms"], "pass2_fps_device": BATCH / t["ms"] * 1e3,
            "host_enqueue_ms": t["host_ms"], "host_paced": t["host_paced"],
            "batch": BATCH, "padded_hw": list(x.shape[1:3]),
            "dtype": "float16", "host_prep_note": "excluded"}


def _category(name: str) -> str:
    low = name.lower()
    if "norm_affine_kernel" in low or "filter_pair_kernel" in low:
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


def _device_breakdown(prof, wall_ms: float, per: int = 1) -> dict:
    """Device busy time by kernel category (divided by `per`) against the
    host wall clock, and the top kernels by device time."""
    by_cat, kernels_ms = {}, []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us <= 0 or e.key.startswith("aten::"):
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


def main() -> int:
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

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(HERE))})

    # 3. kernels vs plain on the card
    errs, n_checks = check_kernels(torch)
    emit({"phase": "check", "checks": n_checks, "max_abs_err": errs})

    # 4. end to end
    sessions, main_counts, err = run_e2e(torch)
    check_against_cpu(torch)

    # 5. times
    tot, filter_bound_by = time_kernels(torch)
    p2 = time_pass2(torch, sessions[torch.float16])
    p2["card"] = smi
    RESULTS["pass2"] = p2
    emit({"phase": "time", **p2})
    for key, trace in (("trace", trace_stylize_video),
                       ("trace_pass2", trace_pass2)):
        tr = trace(torch, sessions[torch.float16])
        tr["card"] = smi
        RESULTS[key] = tr
        emit({"phase": key, **{k: v for k, v in tr.items()
                               if k != "top_kernels"}})

    # 6. summary lines
    meta = {
        "norm_affine_clamp": ("rerevst_torch/csrc/norm_affine.cu",
                              "rerevst_tpu/kernels/norm_affine.py:41", "bytes"),
        "dynamic_filter_pair": ("rerevst_torch/csrc/filter_chain.cu",
                                "rerevst_tpu/kernels/filter_chain.py:55",
                                filter_bound_by),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_counts[k], "max_abs_err": errs[k],
         "ms": tot[k][0], "plain_ms": tot[k][1], "bound_ms": tot[k][2],
         "bound_by": by, "library_ms": None}
        for k, (src, rep, by) in meta.items()]}
    RESULTS["kernels"] = line["kernels"]
    _save()
    emit(line)
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
