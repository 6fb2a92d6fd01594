#!/usr/bin/env python3
"""What bounds ``conv3x3_wgrad`` (``rerevst_torch/csrc/conv3x3_wgrad.cu``)
on the card: edited builds of the kernel side by side, each built from a
copy of the source with the edits in VARIANTS (all nvcc runs in parallel),
reported by ptxas (registers, spills) and timed at the shapes a
``TrainConfig()`` step at ``precision='high'`` launches it
(``scripts/conv_ab.py``'s ``wgrad_shapes``), at three and one pass.

    python3 scripts/probe_wgrad.py

Each build is called through its own C entry (``rr_conv3x3_wgrad``) with
the wrapper's plan (``kernels.conv3x3.wgrad_plan``), checked once against
the repository's kernel (max |diff|: the edits keep the arithmetic, so 0
where they only move registers or stages), then timed with CUDA events over
5 calls behind a sleep kernel.  Prints one JSON line per variant and writes
``chiprun_out/probe_wgrad.json``; the card's name and power limit beside
them.  Variants:

* ``as_is``: the source unchanged (16 x 64 tiles in 4 warps, three
  blocks an SM, the k8 steps rolled);
* ``kk_unrolled``: the K tile's four k8 steps unrolled (more fragments
  loaded ahead, more registers);
* ``wide_tile_one_block``, ``wide_tile_two_blocks``: the O > 8 tile of 32
  x 64 channels in 8 warps (each one m16 block x two n8 blocks), the k8
  steps unrolled, at one block an SM (as ptxas likes it) or two (at most
  128 registers: it spills);
* ``no_min_blocks``: ``__launch_bounds__`` without the three blocks;
* ``four_tiles``: one more K tile of shared memory (three in flight at
  three passes, four at one).
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "conv3x3_wgrad.cu"

ROLLED = "#pragma unroll 1\n  for (int kk = 0; kk < kTW; kk += 8) {"
UNROLLED = "#pragma unroll\n  for (int kk = 0; kk < kTW; kk += 8) {"
BOUNDS = "__global__ void __launch_bounds__(Wgrad<MB, NB, WN>::kThreads, 3)"
TILE = "  return launch<1, 8, 2, P>("
VARIANTS = {
    "as_is": [],
    "kk_unrolled": [(ROLLED, UNROLLED)],
    "wide_tile_one_block": [
        (TILE, "  return launch<2, 8, 2, P>("),
        (BOUNDS, BOUNDS.replace(", 3)", ")")), (ROLLED, UNROLLED)],
    "wide_tile_two_blocks": [
        (TILE, "  return launch<2, 8, 2, P>("),
        (BOUNDS, BOUNDS.replace(", 3)", ", 2)")), (ROLLED, UNROLLED)],
    "no_min_blocks": [(BOUNDS, BOUNDS.replace(", 3)", ")"))],
    "four_tiles": [("constexpr int kTiles = 3;", "constexpr int kTiles = 4;")],
}


def build_variant(build, name: str, edits):
    """(library, ptxas report) of the kernel with `edits` of its source."""
    d = build.BUILD_DIR / "probe_wgrad" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (build.SRC_DIR / SOURCE).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: an edit does not match {SOURCE}")
        src = src.replace(old, new)
    (d / SOURCE).write_text(src)
    shutil.copy(build.SRC_DIR / "common.cuh", d)
    so = d / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(d / SOURCE), "-o", str(so)], check=True)
    report = {}
    for entry, info in build.ptxas_report(SOURCE, d).items():
        m = re.search(r"conv3x3_wgrad_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      entry)
        if m:
            report["MB={}, NB={}, WN={}, P={}".format(*m.groups())] = {
                k: info.get(k) for k in ("registers", "spill_stores",
                                         "spill_loads")}
    lib = ctypes.CDLL(str(so))
    lib.rr_conv3x3_wgrad.argtypes = build.SIGNATURES["rr_conv3x3_wgrad"]
    lib.rr_conv3x3_wgrad.restype = ctypes.c_int
    return lib, report


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("probe_wgrad: CUDA is not available", file=sys.stderr)
        return 2
    from conv_ab import device_ms, wgrad_shapes

    from rerevst_torch.kernels import _build, conv3x3_wgrad
    from rerevst_torch.kernels.conv3x3 import wgrad_plan

    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # nvcc runs in parallel
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build_variant(_build, *kv), VARIANTS.items())))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = wgrad_shapes(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    inputs = {k: (torch.randn(k[:4], generator=gen, device="cuda"),
                  torch.randn(k[:3] + (k[4],), generator=gen, device="cuda"))
              for k in shapes}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "variants": {}}
    for name, (lib, report) in built.items():
        rows, step = [], {3: 0.0, 1: 0.0}
        for (b, h, w, c, o), n in sorted(shapes.items()):
            x, g = inputs[(b, h, w, c, o)]
            plan = wgrad_plan(b, h, w, c, o, sms)
            dw = torch.empty((3, 3, c, o), device="cuda")
            ws = torch.empty(plan.splits * 9 * c * o, device="cuda")
            row = {"shape": [b, h, w, c], "O": o, "splits": plan.splits}
            for passes in (3, 1):
                def run():
                    err = lib.rr_conv3x3_wgrad(
                        x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                        ws.data_ptr(), b, h, w, c, o, plan.splits, passes,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                run()
                row[f"max_abs_diff_{passes}"] = float(
                    (dw - conv3x3_wgrad(x, g, passes)).abs().max())
                row[f"ms_{passes}"] = device_ms(torch, run, iters=5,
                                                warmup=1)
                step[passes] += n * row[f"ms_{passes}"]
            rows.append(row)
        res = {"ptxas": report, "ms_per_step_3": step[3],
               "ms_per_step_1": step[1], "rows": rows, "card": smi}
        out["variants"][name] = res
        print(json.dumps({"variant": name, **{k: v for k, v in res.items()
                                              if k != "rows"}}), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_wgrad.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
