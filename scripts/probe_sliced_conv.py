#!/usr/bin/env python3
"""What the sliced conv kernel (16-bit, C >= 8 that is neither 64 nor a
multiple of 64 >= 128) costs on an NVIDIA H100, against the design it was
chosen over.

    python3 scripts/probe_sliced_conv.py

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  f16,
device time from CUDA events over back-to-back calls queued behind a sleep
kernel (``chip_smoke.time_ms``).  At the two shapes the design was built
for, [16,320,320,32] -> 64 (C = 32 at conv2_x scale) and the decoder's
filter `up` conv [16,80,80,32] -> 512:

1. the kernel as the wrapper plans it (``kernels/conv3x3.py:
   sliced_plan``), checked once against its plain version, beside one
   ``F.conv2d`` with bias (channels_last) and the bound (bytes over 3.35
   TB/s or flops over 989 TFLOP/s, the larger);
2. every tile width (16, 32, 64, 128 columns) and K slice (16, 32) the
   kernel takes, through ``rr_conv3x3`` directly;
3. the output stream alone (``y.zero_()`` on the output's bytes), and the
   same launch in three variants of ``csrc/conv3x3.cu``, built from the
   committed source with one edit each into ``rerevst_torch/_build/probe/``:
   ``no_store`` (the epilogue skipped behind a condition that never holds:
   loads and products remain), ``no_tma_store`` (the output boxes staged
   but never stored) and ``loads_only`` (a stage's wgmmas removed: the
   producer's loads, the barriers and the epilogue remain);
4. the rejected design's family: the streamed kernel (one TMA halo row at a
   time into registers, resident weight taps, O tiled by 64 over the grid)
   at the nearest shapes it takes, C = 64 with the same B, H, W and O, and
   its bound there.

Then the sliced kernel at other widths it takes (C = 8, 16, 24, 96, 100,
160, 200 at [16,160,160,C] -> 64).  Prints the card's name and power limit
and one JSON line; the same lands in ``chiprun_out/probe_sliced_conv.json``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TARGETS = [("row 3g, C = 32", (16, 320, 320, 32), 64),
           ("filter up", (16, 80, 80, 32), 512)]
OTHER_C = [8, 16, 24, 96, 100, 160, 200]

VARIANTS = {
    "no_store": ("    constexpr int NB = BN / CW;  // boxes an m64 block\n",
                 "    constexpr int NB = BN / CW;  // boxes an m64 block\n"
                 "    if (O >= 0) continue;\n"),
    "no_tma_store": ("          if (wtid == 0)\n"
                     "            tma_store_4d(&ymap, smem_addr(box), nc,",
                     "          if (O < 0)\n"
                     "            tma_store_4d(&ymap, smem_addr(box), nc,"),
    "loads_only": ("      sliced_stage<T, BN, KS>(acc, da, db, drow);\n", ""),
}


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


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_sliced_conv: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rerevst_torch.kernels import (
        _build,
        conv3x3_implicit_gemm,
        conv3x3_implicit_gemm_plain,
        conv3x3_pairlane,
    )
    from rerevst_torch.kernels.conv3x3 import conv_plan, sliced_plan

    lib = _build.library()
    variants = {name: build_variant(_build, name, *edit)
                for name, edit in VARIANTS.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = {"card": cs.nvidia_smi(), "targets": [], "other_c": []}

    def direct(x, w, b, y, cols, n, ks, grid, lib=lib):
        bb, h, wd, c = x.shape
        err = lib.rr_conv3x3(2, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), None, bb, h, wd, c, w.shape[-1], 0,
                             cols, n, ks, grid, 1, 0,
                             torch.cuda.current_stream().cuda_stream)
        _build.check(err, "rr_conv3x3")

    for site, shape, o in TARGETS:
        x, w, b = cs.conv_inputs(torch, shape, o, torch.float16, gen)
        got = conv3x3_implicit_gemm(x, w, b)
        want = conv3x3_implicit_gemm_plain(x, w, b)
        ok = cs.conv_within_tolerance(torch, got, want, x, w, b)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        plan = sliced_plan(*shape, o, sms)
        bound, by, t_bytes, t_ops = cs.conv_bound(x, w, o)
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        row = {"site": site, "shape": shape, "O": o, "ok": ok,
               "max_abs_err": err,
               "plan": {"cols": plan.cols, "rows": plan.rows, "n": plan.n,
                        "ks": plan.ks, "grid": plan.grid},
               "ms": cs.time_ms(torch, lambda: conv3x3_implicit_gemm(x, w, b),
                                iters=20)["ms"],
               "library_ms": cs.time_ms(
                   torch, lambda: F.conv2d(xl, wl, b, padding=1),
                   iters=20)["ms"],
               "bound_ms": bound, "bound_by": by, "bound_bytes_ms": t_bytes,
               "bound_ops_ms": t_ops}
        y = torch.empty(shape[:3] + (o,), dtype=x.dtype, device=x.device)
        row["y_zero_ms"] = cs.time_ms(torch, y.zero_, iters=20)["ms"]
        for name, vlib in variants.items():
            row[f"{name}_ms"] = cs.time_ms(
                torch, lambda: direct(x, w, b, y, plan.cols, plan.n, plan.ks,
                                      plan.grid, vlib), iters=20)["ms"]
        sweep = {}
        for cols in (16, 32, 64, 128):
            for ks in (16, 32):
                p = sliced_plan(*shape, o, sms)
                ms = cs.time_ms(torch, lambda: direct(x, w, b, y, cols, p.n,
                                                      ks, sms), iters=10)
                sweep[f"cols={cols},ks={ks}"] = ms["ms"]
        row["sweep_ms"] = sweep
        # The rejected design's family at its nearest shape: C = 64.
        x64, w64, b64 = cs.conv_inputs(torch, shape[:3] + (64,), o,
                                       torch.float16, gen)
        fn = (conv3x3_pairlane if o <= 64 else conv3x3_implicit_gemm)
        sp = conv_plan(*shape[:3], o, sms)
        sb, sby, _, _ = cs.conv_bound(x64, w64, o)
        row["streamed_c64"] = {
            "shape": shape[:3] + (64,), "rows": sp.rows, "grid": sp.grid,
            "n_tiles": sp.n_tiles,
            "ms": cs.time_ms(torch, lambda: fn(x64, w64, b64), iters=10)["ms"],
            "bound_ms": sb, "bound_by": sby}
        del x64, w64, b64, x, w, b, y, xl, wl
        torch.cuda.empty_cache()
        out["targets"].append(row)
        print(json.dumps({"probe": "target", **row}), flush=True)
    for c in OTHER_C:
        shape, o = (16, 160, 160, c), 64
        x, w, b = cs.conv_inputs(torch, shape, o, torch.float16, gen)
        got = conv3x3_implicit_gemm(x, w, b)
        ok = cs.conv_within_tolerance(
            torch, got, conv3x3_implicit_gemm_plain(x, w, b), x, w, b)
        bound, by, _, _ = cs.conv_bound(x, w, o)
        row = {"shape": shape, "O": o, "ok": ok,
               "ks": sliced_plan(*shape, o, sms).ks,
               "ms": cs.time_ms(torch, lambda: conv3x3_implicit_gemm(x, w, b),
                                iters=10)["ms"],
               "bound_ms": bound, "bound_by": by}
        out["other_c"].append(row)
        print(json.dumps({"probe": "other_c", **row}), flush=True)
        del x, w, b, got
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_sliced_conv.json").write_text(json.dumps(out, indent=1))
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0 if all(r["ok"] for r in out["targets"] + out["other_c"]) else 1


if __name__ == "__main__":
    sys.exit(main())
