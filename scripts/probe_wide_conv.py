#!/usr/bin/env python3
"""What bounds the port's wide conv kernel (16-bit, C % 64 = 0, C >= 128)
on an NVIDIA H100.

    python3 scripts/probe_wide_conv.py

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  At
the VGG shapes of one 16-frame batch of 640^2 that the wide kernel takes
(conv2_2, conv3_1, conv3_2, conv4_1; f16) it times, with CUDA events over
back-to-back calls queued behind a sleep kernel:

1. the kernel as the wrapper plans it (``kernels/conv3x3.py: wide_plan``);
2. the same launch in two variants of ``csrc/conv3x3.cu``, built from the
   committed source with one edit each into ``rerevst_torch/_build/probe/``:
   ``loads_only`` (a stage's wgmmas removed: the producer's TMA loads, the
   barriers and the epilogue remain, so its time is that of the feed from
   L2 into shared memory and the stores) and ``no_store`` (the epilogue
   skipped behind a condition that never holds: the loads and the products
   remain);
3. every tile width the plan can pick (16, 32, 64, 128 columns) at every
   width N the kernel has for that O (128; 256 where O >= 256), through
   ``rr_conv3x3`` directly.

Beside each it prints the op bound (2 M 9C O over 989 TFLOP/s) and the
bytes staged into shared memory per call (A boxes and weight slices, each
K step of each tile) over the kernel's time: the rate at which L2 fed the
SMs.  Prints the card's name and power limit, then one JSON line; the same
lands in ``chiprun_out/probe_wide_conv.json``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [("conv2_2", (16, 320, 320, 128), 128),
          ("conv3_1", (16, 160, 160, 128), 256),
          ("conv3_2", (16, 160, 160, 256), 256),
          ("conv4_1", (16, 80, 80, 256), 512)]
F16_FLOP_PER_S = 989e12

_WGMMA = "      wide_stage<T, BN>(acc, da, db, k == 0);\n"
_STORE = "      wide_store<T, BN>(acc[m], "
VARIANTS = {"loads_only": (_WGMMA, ""),
            "no_store": (_STORE, "      if (O < 0) wide_store<T, BN>(acc[m], ")}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def build_variant(build, name: str, old: str, new: str) -> ctypes.CDLL:
    """The kernel library with one edit of conv3x3.cu."""
    d = build.BUILD_DIR / "probe" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (build.SRC_DIR / "conv3x3.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the edit does not match conv3x3.cu")
    (d / "conv3x3.cu").write_text(src.replace(old, new))
    for header in build.SRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    so = d / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(d / "conv3x3.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rr_conv3x3.argtypes = build.SIGNATURES["rr_conv3x3"]
    lib.rr_conv3x3.restype = ctypes.c_int
    return lib


def device_ms(torch, fn, iters=10, warmup=2) -> float:
    """Milliseconds per call on the card: the calls queue behind a sleep
    kernel longer than their enqueue, so the events read device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * 20))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def staged_bytes(plan, c: int) -> int:
    """Bytes TMA writes into shared memory in one call: each tile's 9 C / 64
    K steps stage one box of the tile's pixels x 64 channels and N / 64 (at
    least one) weight boxes of 64 x 64."""
    per_step = plan.m * 64 * 2 + max(1, plan.n // 64) * 64 * 64 * 2
    return plan.n_tiles * plan.strips * plan.bands * plan.batch \
        * 9 * (c // 64) * per_step


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_wide_conv: CUDA is not available", file=sys.stderr)
        return 2
    from rerevst_torch.kernels import _build
    from rerevst_torch.kernels import conv3x3 as K

    lib = _build.library()
    libs = {name: build_variant(_build, name, *edit)
            for name, edit in VARIANTS.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for site, shape, o in SHAPES:
        bsz, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").half()
        wt = (torch.randn((3, 3, c, o), generator=gen, device="cuda")
              / (3 * c ** 0.5)).half()
        b = torch.randn(o, generator=gen, device="cuda").half()
        y = torch.empty((bsz, h, w, o), dtype=x.dtype, device="cuda")
        plan = K.wide_plan(bsz, h, w, o, sms)

        def call(lib_, cols, n):
            grid = min(sms, K.WidePlan(bsz, h, w, o, cols, n, 1).tiles)
            err = lib_.rr_conv3x3(2, x.data_ptr(), wt.data_ptr(),
                                  b.data_ptr(), y.data_ptr(), None, bsz, h,
                                  w, c, o, 0, cols, n, 0, grid, 1, 0, stream)
            if err:
                raise RuntimeError(f"rr_conv3x3 failed with {err}")

        bound = 2 * bsz * h * w * 9 * c * o / F16_FLOP_PER_S * 1e3
        row = {"site": site, "shape": list(shape), "O": o,
               "plan": {"cols": plan.cols, "n": plan.n, "grid": plan.grid},
               "bound_ms": bound,
               "ms": device_ms(torch, lambda: K.conv3x3_implicit_gemm(
                   x, wt, b))}
        for name, lib_ in libs.items():
            row[f"{name}_ms"] = device_ms(
                torch, lambda: call(lib_, plan.cols, plan.n))
        row["of_bound"] = bound / row["ms"]
        row["staged_bytes"] = staged_bytes(plan, c)
        row["staged_tb_per_s"] = row["staged_bytes"] / row["ms"] / 1e9
        row["loads_only_tb_per_s"] = \
            row["staged_bytes"] / row["loads_only_ms"] / 1e9
        for n in (128, 256) if o >= 256 else (128,):
            for cols in K.WIDE_COLS:
                row[f"n{n}_cols{cols}_ms"] = device_ms(
                    torch, lambda: call(lib, cols, n))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, wt, b, y
        torch.cuda.empty_cache()
    card = smi()
    out = {"card": card, "rows": rows}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_wide_conv.json").write_text(
        json.dumps(out, indent=1))
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
