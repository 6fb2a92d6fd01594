#!/usr/bin/env python3
"""Device time of ``conv3x3_implicit_gemm`` at the VGG shapes of one
16-frame batch of 640^2, for the ``rerevst_torch`` package under a given
root — one side of an A/B of two trees' conv kernels in one call.

    python3 scripts/conv_ab.py --root ROOT [--label NAME]
                               [--wgrad | --steps | --tf32x1 | --tf32x3]

ROOT holds the ``rerevst_torch`` to measure (this repository, or an unpacked
``git archive`` of another commit); its kernels build from its own sources.
The f16 shapes are the JAX conv benchmark's [16,640,640,64] -> 64 and -> 3
(the streamed kernel), ``chip_smoke.py``'s VGG_CONVS (conv1_1
[16,640,640,3]->64, the narrow kernel; conv2_1 [16,320,320,64]->128, the
streamed kernel; conv2_2 [16,320,320,128]->128, conv3_1
[16,160,160,128]->256, conv3_2 [16,160,160,256]->256 and conv4_1
[16,80,80,256]->512, the wide kernel) and its SLICED_CONVS ([16,320,320,32]
-> 64 and the filter blocks' `up` [16,80,80,32] -> 512, the sliced kernel;
their `down` [16,80,80,512] -> 32), then the grid of C % 64 = 0 with O <=
64 that decides between the sliced and the wide designs (C = 128, 256, 512
at the relu2_1, relu3_1 and relu4_1 scales 320^2, 160^2, 80^2, x O = 3,
16, 32, 64), and rows 3j and 3k, fp32 [16,640,640,64] -> 64 at three and
one TF32 pass (the fp32 rows also report the mean signed error, sum (y -
y_ref) sign(y_ref) over sum |y_ref|).  Inputs are seeded
randoms made on the card; each call is checked once against ``F.conv2d``
in fp32 with TF32 off (max |diff| reported), then timed with CUDA events
over 20 calls (5 in fp32) queued behind a sleep kernel, after 3 warm-up
calls.  Prints one JSON line with the card's name and power limit and the
design each call took (where the tree's wrapper names it).  Run the two
trees in turns (A, B, B, A) in one call: the card and its host differ from
call to call.

With ``--steps``, ``TrainConfig()`` train steps instead, at precision
'highest', 'high' and 'default' in turns (seeded random parameters and
images made on the card, one warm-up step each, then the median of 3 with
CUDA events, and the peak memory of those steps): the step times of two
trees, A/B in one call.  ``chip_smoke.py``'s phase train times the steps
of the tree it runs in only, after checks of each precision's step
against 'highest' that take minutes; this mode times the steps alone, so
that two trees take turns on one card.

With ``--wgrad``, ``conv3x3_wgrad`` instead (a tree that has it): one
``TrainConfig()`` step at precision 'high' on the card (seeded random
parameters and images) gives the (B, H, W, C, O) it launches the kernel at
and how often (``wgrad_shapes``); each shape is checked once against the
tree's plain version, its mean signed error against float64 read at
three and one pass, and it is timed at both (20 calls after 3 warm-ups);
the line adds the sums over one step's launches.

With ``--tf32x1``, the one-pass conv (``passes=1``, the 'default'
precision) instead, at every (B, H, W, C, O) the tree launches it at in
one fp32 'default' Pass-2 batch (``models/demo_plum_4000.msgpack``, 16
seeded random frames of 512^2 padded to 640^2, a seeded random style) and
in one 'default' ``TrainConfig()`` step (its forward convs and their input
gradients; seeded random parameters and images), as a dispatch mode
records the op's calls (so a tree without launch counts by shape works
too): each shape's launches in a batch and in a step, the design it takes
(where the tree's ``design`` names it), its max |diff| from the plain
version, its mean signed error against a float64 conv of up to two
frames, its ms (20 calls after 3 warm-ups), the bound (one TF32 pass at
495 TFLOP/s or the bytes at 3.35 TB/s, the larger) and one ``F.conv2d``
with cuDNN's TF32 on; and the sums over a batch's and a step's launches.
Where the tree splits K over blocks (``kernels.conv3x3.plan_for``), each
row also gives the plan's splits and, where it splits, the same plan's ms
with one split (``forced_splits(1)``).

With ``--tf32x3``, the same at three passes (the split-TF32 kernel, the
'high' precision): every shape of one fp32 'high' Pass-2 batch and one
'high' train step, beside one ``F.conv2d`` with cuDNN's TF32 off, the
bound three TF32 passes at 495 TFLOP/s or the bytes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

F16, F32 = "float16", "float32"
SHAPES = [("bench 64->64", (16, 640, 640, 64), 64, F16),
          ("bench 64->3", (16, 640, 640, 64), 3, F16),
          ("conv1_1", (16, 640, 640, 3), 64, F16),
          ("conv2_1", (16, 320, 320, 64), 128, F16),
          ("conv2_2", (16, 320, 320, 128), 128, F16),
          ("conv3_1", (16, 160, 160, 128), 256, F16),
          ("conv3_2", (16, 160, 160, 256), 256, F16),
          ("conv4_1", (16, 80, 80, 256), 512, F16),
          ("sliced C = 32", (16, 320, 320, 32), 64, F16),
          ("filter up", (16, 80, 80, 32), 512, F16),
          ("filter down", (16, 80, 80, 512), 32, F16)] \
    + [(f"C = {c} -> {o}", (16, hw, hw, c), o, F16)
       for c, hw in ((128, 320), (256, 160), (512, 80))
       for o in (3, 16, 32, 64) if (c, o) != (512, 32)] \
    + [("fp32 C = 64", (16, 640, 640, 64), 64, F32),
       ("fp32 C = 64, one pass", (16, 640, 640, 64), 64, F32, 1)]


def device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Milliseconds per call on the card: the calls queue behind a sleep
    kernel longer than their enqueue, so the events read device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 2)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def train_setup(torch, precision: str):
    """``TrainConfig()`` at ``precision`` and its train state on the card,
    from the config's seed (he_relu VGG weights)."""
    import dataclasses

    from rerevst_torch.config import TrainConfig
    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_torch.train.state import init_train_state

    base = TrainConfig()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, precision=precision))

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.detach().to("cuda", copy=True)

    params = to_card(init_transformer_params(
        torch.Generator().manual_seed(cfg.seed), cfg.model,
        with_loss_net=True, vgg_scheme="he_relu"))
    return cfg, init_train_state(params, cfg)


def wgrad_shapes(torch) -> dict:
    """{(B, H, W, C, O): launches} of ``conv3x3_wgrad`` over one
    ``TrainConfig()`` step at precision 'high' on the card, from seeded
    random parameters and images (the shapes follow from the config
    alone)."""
    from rerevst_torch import kernels
    from rerevst_torch.kernels import conv3x3_wgrad
    from rerevst_torch.train.step import make_train_step

    cfg, state = train_setup(torch, "high")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    shape = (cfg.batch_size, cfg.fine_size, cfg.fine_size, 3)
    content, style = (torch.randn(shape, generator=gen, device="cuda")
                      for _ in range(2))
    kernels.reset_launches()
    make_train_step(cfg)(state, content, style, gen)
    torch.cuda.synchronize()
    return dict(conv3x3_wgrad.launches_by_shape)


def time_steps(torch) -> dict:
    """Median ms and peak GB of ``TrainConfig()`` steps at each precision
    (see the module's doc)."""
    from rerevst_torch.train.step import make_train_step

    out = {}
    for prec in ("highest", "high", "default"):
        cfg, state = train_setup(torch, prec)
        step = make_train_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        shape = (cfg.batch_size, cfg.fine_size, cfg.fine_size, 3)
        state, _ = step(state, torch.randn(shape, generator=gen,
                                           device="cuda"),
                        torch.randn(shape, generator=gen, device="cuda"),
                        gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            c, s = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, _ = step(state, c, s, gen)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        out[prec] = {"step_ms_median": sorted(ms)[1], "step_ms": ms,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, step
        torch.cuda.empty_cache()
    return {"steps": out}


def time_wgrad(torch) -> dict:
    """``conv3x3_wgrad`` at every shape of ``wgrad_shapes``, at three and
    one pass: its max |diff| from the plain version and its ms, and the
    sums over one step's launches."""
    from rerevst_torch.kernels import conv3x3_wgrad, conv3x3_wgrad_plain

    shapes = wgrad_shapes(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rows, step = [], {3: 0.0, 1: 0.0}
    for (b, h, w, c, o), n in sorted(shapes.items()):
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        g = torch.randn((b, h, w, o), generator=gen, device="cuda")
        want = conv3x3_wgrad_plain(x, g)
        row = {"shape": [b, h, w, c], "O": o, "launches": n,
               "max_abs_diff_vs_plain": float(
                   (conv3x3_wgrad(x, g, 3) - want).abs().max())}
        # The mean signed error against float64 (per tap one float64
        # GEMM of the zero-padded x's window by g): sum (dw - ref)
        # sign(ref) over sum |ref|.
        xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1))
        gm = g.double().reshape(-1, o)
        ref = torch.stack([torch.stack([
            xp[:, ky:ky + h, kx:kx + w].reshape(-1, c).T @ gm
            for kx in range(3)]) for ky in range(3)])
        del xp, gm
        for passes in (3, 1):
            dw = conv3x3_wgrad(x, g, passes).double()
            row[f"mean_signed_err_vs_f64_{passes}"] = float(
                ((dw - ref) * ref.sign()).sum() / ref.abs().sum())
        del ref, dw
        for passes in (3, 1):
            row[f"ms_{passes}"] = device_ms(
                torch, lambda: conv3x3_wgrad(x, g, passes), iters=20)
            step[passes] += n * row[f"ms_{passes}"]
        rows.append(row)
        del x, g, want
        torch.cuda.empty_cache()
    return {"wgrad": rows, "ms_per_step_3": step[3],
            "ms_per_step_1": step[1]}


def record_shapes(torch, fn, passes: int) -> dict:
    """{(B, H, W, C, O): calls} of ``rerevst::conv3x3_implicit_gemm`` at
    `passes` while ``fn()`` runs, read by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func._schema.name == "rerevst::conv3x3_implicit_gemm":
                got = args[3] if len(args) > 3 else kwargs.get("passes", 3)
                if got == passes:
                    key = tuple(args[0].shape) + (args[1].shape[-1],)
                    seen[key] = seen.get(key, 0) + 1
            return func(*args, **kwargs)

    with Record():
        fn()
    torch.cuda.synchronize()
    return seen


def fp32_shapes(torch, passes: int) -> tuple:
    """The fp32 conv's shapes and launches at `passes` in one fp32 Pass-2
    batch and in one train step at the precision of that pass count ('high'
    at three, 'default' at one; see the module's doc)."""
    import numpy as np

    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.train.step import make_train_step

    precision = "high" if passes == 3 else "default"
    ckpt = Path(__file__).resolve().parent.parent / "models" \
        / "demo_plum_4000.msgpack"
    rng = np.random.default_rng(19)
    s = Stylization(str(ckpt), cfg=ModelConfig(precision=precision),
                    device="cuda")
    s.prepare_style(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
    frames = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
              for _ in range(16)]
    for f in frames[:2]:  # Pass 1: the statistics Pass 2 runs under
        s.add(f)
    s.compute()
    x = s._upload(s._prep_batch_host(frames))
    batch = record_shapes(torch, lambda: s._stylize(x), passes)
    del s, x
    cfg, state = train_setup(torch, precision)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    shape = (cfg.batch_size, cfg.fine_size, cfg.fine_size, 3)
    content, style = (torch.randn(shape, generator=gen, device="cuda")
                      for _ in range(2))
    step = make_train_step(cfg)
    steps = record_shapes(torch, lambda: step(state, content, style, gen),
                          passes)
    del state, step
    torch.cuda.empty_cache()
    return batch, steps


def time_fp32(torch, passes: int) -> dict:
    """The fp32 conv at `passes` at every shape of ``fp32_shapes`` (see
    the module's doc)."""
    import torch.nn.functional as F

    from rerevst_torch.kernels import (
        conv3x3_implicit_gemm,
        conv3x3_implicit_gemm_plain,
    )
    from rerevst_torch.kernels.conv3x3 import design
    try:  # a tree that splits K over blocks
        from rerevst_torch.kernels.conv3x3 import forced_splits, plan_for
    except ImportError:
        forced_splits = plan_for = None

    batch, steps = fp32_shapes(torch, passes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    rows, sums = [], {"batch": 0.0, "step": 0.0, "batch_cudnn": 0.0,
                      "step_cudnn": 0.0}
    for key in sorted(set(batch) | set(steps)):
        *shape, o = key
        x = torch.randn(shape, generator=gen, device="cuda")
        w = (torch.randn((3, 3, shape[-1], o), generator=gen, device="cuda")
             / (3 * shape[-1] ** 0.5))
        b = torch.randn(o, generator=gen, device="cuda")
        got = conv3x3_implicit_gemm(x, w, b, passes)
        diff = (got - conv3x3_implicit_gemm_plain(x, w, b)).abs().max()
        x2 = x[:2].double().permute(0, 3, 1, 2)
        ref = F.conv2d(x2, w.double().permute(3, 2, 0, 1), b.double(),
                       padding=1).permute(0, 2, 3, 1)
        signed = float(((got[:2].double() - ref) * ref.sign()).sum()
                       / ref.abs().sum())
        del got, x2, ref
        m = x.numel() // shape[-1]
        bound = max(passes * 2 * m * 9 * shape[-1] * o / 495e12,
                    (x.numel() + w.numel() + o + m * o) * 4 / 3.35e12) * 1e3
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = passes == 1
        try:
            lib_ms = device_ms(torch, lambda: F.conv2d(xl, wl, b, padding=1))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        row = {"shape": list(shape), "O": o,
               "launches_batch": batch.get(key, 0),
               "launches_step": steps.get(key, 0),
               "max_abs_diff_vs_plain": float(diff),
               "mean_signed_err_vs_f64": signed,
               "ms": device_ms(torch, lambda: conv3x3_implicit_gemm(
                   x, w, b, passes)),
               "bound_ms": bound, "cudnn_ms": lib_ms}
        try:
            row["design"] = design(shape[-1], torch.float32, o, passes)
        except TypeError:  # a tree whose design() takes no passes
            row["design"] = None
        if plan_for is not None:
            row["splits"] = plan_for(x, o, passes).splits
            if row["splits"] > 1:
                with forced_splits(1):
                    row["ms_one_split"] = device_ms(
                        torch, lambda: conv3x3_implicit_gemm(x, w, b,
                                                             passes))
        for where in ("batch", "step"):
            sums[where] += row[f"launches_{where}"] * row["ms"]
            sums[f"{where}_cudnn"] += row[f"launches_{where}"] * lib_ms
        rows.append(row)
        del x, w, b, xl, wl
        torch.cuda.empty_cache()
    return {f"tf32x{passes}": rows, "ms_per_batch": sums["batch"],
            "ms_per_step": sums["step"],
            "cudnn_ms_per_batch": sums["batch_cudnn"],
            "cudnn_ms_per_step": sums["step_cudnn"],
            "cudnn_tf32": passes == 1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--wgrad", action="store_true",
                    help="time conv3x3_wgrad at a 'high' step's shapes")
    ap.add_argument("--steps", action="store_true",
                    help="time TrainConfig() steps at each precision")
    ap.add_argument("--tf32x1", action="store_true",
                    help="time the one-pass conv at a 'default' batch's "
                         "and step's shapes")
    ap.add_argument("--tf32x3", action="store_true",
                    help="time the three-pass conv at a 'high' batch's "
                         "and step's shapes")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("conv_ab: CUDA is not available", file=sys.stderr)
        return 2
    import rerevst_torch
    from rerevst_torch.kernels import conv3x3_implicit_gemm
    from rerevst_torch.kernels.conv3x3 import design

    if Path(rerevst_torch.__file__).resolve().parent.parent != root:
        print(f"conv_ab: imported rerevst_torch from "
              f"{rerevst_torch.__file__}, not {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.wgrad or args.steps or args.tf32x1 or args.tf32x3:
        mode = time_wgrad if args.wgrad else time_steps if args.steps \
            else (lambda t: time_fp32(t, 1 if args.tf32x1 else 3))
        print(json.dumps({"label": args.label or str(root),
                          **mode(torch), "card": smi}), flush=True)
        return 0
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = {}
    for site, shape, o, dt, *passes in SHAPES:
        passes = passes[0] if passes else 3
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (torch.randn((3, 3, shape[-1], o), generator=gen, device="cuda")
             / (3 * shape[-1] ** 0.5)).to(dtype)
        b = torch.randn(o, generator=gen, device="cuda").to(dtype)
        got = conv3x3_implicit_gemm(x, w, b, passes).float()
        want = F.conv2d(x.float().permute(0, 3, 1, 2),
                        w.float().permute(3, 2, 0, 1), b.float(),
                        padding=1).permute(0, 2, 3, 1)
        err = (got - want).abs().max().item()
        signed = float(((got - want) * want.sign()).sum()
                       / want.abs().sum())
        del got, want
        iters = 5 if dt == F32 else 20
        rows[site] = {"ms": device_ms(
            torch, lambda: conv3x3_implicit_gemm(x, w, b, passes),
            iters=iters), "max_abs_diff_vs_fp32": err, "dtype": dt}
        if dt == F32:
            rows[site]["mean_signed_err_vs_fp32"] = signed
        try:
            rows[site]["design"] = design(shape[-1], dtype, o)
        except TypeError:  # a tree whose design() takes no O
            rows[site]["design"] = design(shape[-1], dtype)
        del x, w, b
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "convs": rows,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
