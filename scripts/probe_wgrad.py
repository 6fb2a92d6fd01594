#!/usr/bin/env python3
"""What bounds ``conv3x3_wgrad`` (``rerevst_torch/csrc/conv3x3_wgrad.cu``)
on the card: edited builds of the kernel side by side, each built from a
copy of the source with the edits in VARIANTS (all nvcc runs in parallel),
reported by ptxas (registers, spills, wgmma serialization) and timed at
the shapes a ``TrainConfig()`` step at ``precision='high'`` launches it
(``scripts/conv_ab.py``'s ``wgrad_shapes``), at three and one pass.

    python3 scripts/probe_wgrad.py

Each build is called through its own C entry (``rr_conv3x3_wgrad``) with
the wrapper's plan (``kernels.conv3x3.wgrad_plan``), checked once against
the repository's kernel (max |diff|: 0 where an edit keeps the
arithmetic; the variants that drop work give garbage and are timings
only), then timed with CUDA events over 5 calls behind a sleep kernel.
Prints one JSON line per variant and writes
``chiprun_out/probe_wgrad.json``; the card's name and power limit beside
them.  The variants edit the wgmma route (the step's shapes but the two
RGB layers, which take the mma.sync route and time the same in every
variant):

* ``as_is``: the source unchanged;
* ``no_products``: the consumers load and split A but issue no wgmma;
* ``no_b_copies``: the splitter warps write no B copies (flags only);
* ``loads_only``: neither: the TMA ring, the barriers and the A loads;
* ``no_setmaxnreg``: every thread keeps the launch's 128 registers (the
  three-pass consumers spill);
* ``wait_each_step``: each k8 step's group waited for before the next
  step's A is loaded (no second register set);
* ``no_promotion``: at one pass no tile's sums are added into the register
  sum (the one-pass results are garbage: a timing of what the adds cost).
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

PRODUCTS = "  tc_step<P, {s}, KX0, KX1>(acc, cor, ah[{i}], al[{i}], bd);\n"
SINK = ("  asm volatile(\"\" :: \"r\"(ah[{i}][0]), \"r\"(al[{i}][0]), "
        "\"r\"(ah[{i}][3]), \"r\"(al[{i}][3]));\n")
NO_PRODUCTS = [(PRODUCTS.format(s=s, i=s % 2), SINK.format(i=s % 2))
               for s in range(4)]
NO_B_COPIES = [("for (int i = sid; i < 4 * kTcN; i += 32 * kTcSplitters) {",
                "for (int i = sid; i < 0; i += 32 * kTcSplitters) {")]
NO_SETMAXNREG = [("    regs_release();\n", ""), ("  regs_claim();\n", "")]
WAIT_EACH = [("  wgmma_wait<1>();  // step 0's group: set 0 is free",
              "  wgmma_wait<0>();  // step 0's group: set 0 is free"),
             ("  tc_step<P, 0, KX0, KX1>(acc, cor, ah[0], al[0], bd);\n",
              "  tc_step<P, 0, KX0, KX1>(acc, cor, ah[0], al[0], bd);\n"
              "  wgmma_wait<0>();\n"),
             ("  wgmma_wait<1>();  // step 1's group: set 1 is free",
              "  wgmma_wait<0>();  // step 1's group: set 1 is free")]
PROMOTION = "      if constexpr ({}) {{\n        // One pass: the tile's"
NO_PROMOTION = [(PROMOTION.format("P == 1"), PROMOTION.format("false"))]
VARIANTS = {
    "as_is": [],
    "no_products": NO_PRODUCTS,
    "no_b_copies": NO_B_COPIES,
    "loads_only": NO_PRODUCTS + NO_B_COPIES,
    "no_setmaxnreg": NO_SETMAXNREG,
    "wait_each_step": WAIT_EACH,
    "no_promotion": NO_PROMOTION,
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
    for header in build.SRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    so = d / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(d / SOURCE), "-o", str(so)], check=True)
    report = {}
    for entry, info in build.ptxas_report(SOURCE, d).items():
        m = re.search(r"conv3x3_wgrad_tc_kernelILi(\d+)E", entry)
        if m:
            report[f"wgmma route, P={m.group(1)}"] = {
                "serialized": any("serializ" in n for n in info["notes"]),
                **{k: info.get(k) for k in ("registers", "spill_stores",
                                            "spill_loads")}}
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
    from rerevst_torch.kernels.conv3x3 import wgrad_plan_for

    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # nvcc runs in parallel
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build_variant(_build, *kv), VARIANTS.items())))
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
            plan = wgrad_plan_for(x, g)
            dw = torch.empty((3, 3, c, o), device="cuda")
            ws = torch.empty(plan.splits * 9 * c * o, device="cuda")
            wsp = ws.data_ptr() if plan.workspace_bytes else None
            row = {"shape": [b, h, w, c], "O": o, "route": plan.route,
                   "splits": plan.splits}
            for passes in (3, 1):
                def run():
                    err = lib.rr_conv3x3_wgrad(
                        x.data_ptr(), g.data_ptr(), dw.data_ptr(), wsp, b,
                        h, w, c, o, plan.splits, passes,
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
