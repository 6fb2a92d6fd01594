#!/usr/bin/env python3
"""What the rows conv kernel (fp32, O <= 32; ``csrc/conv3x3_rows.cu``,
design "tf32_rows") costs on an NVIDIA H100, piece by piece.

    python3 scripts/probe_rows_conv.py [--variants a,b,...]

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  fp32,
device time from CUDA events over back-to-back calls queued behind a sleep
kernel (``chip_smoke.time_ms``), at the Pass-2 batch's two O <= 32 shapes,
the filter blocks' `down` [16,80,80,512] -> 32 and the decoder's `out`
[16,640,640,64] -> 3, at one and three passes:

1. the kernel as the wrapper plans it (``tf32_rows_plan``), through
   ``rr_conv3x3_rows``, beside one ``F.conv2d`` with cuDNN's TF32 on (one
   pass) or off (three) and, with ``--parent DIR`` (the root of an
   unpacked ``git archive`` of a commit before the rows design), the
   split-TF32 kernel's instance that tree launched at these shapes, built
   from its ``conv3x3.cu`` (``rr_conv3x3`` with ``R`` = 0, planned as
   ``scripts/probe_tf32_conv.py`` parent_plan does);
2. variants of ``csrc/conv3x3_rows.cu``, each built from the committed
   source with its edits into ``rerevst_torch/_build/probe_rows/``:
   ``no_wgmma`` (no product: the loads, the rounding's inputs, the waits,
   the stores remain), ``no_round`` (x enters the products unrounded and
   unsplit), ``one_dx`` and ``three_dx`` (a group of wgmmas a fragment,
   or the three dx of a phase, at every N and pass count), ``no_store`` (the epilogue skipped), ``one_group`` (each
   stage issues its first group only: the stages' own cost, TMA and
   barriers), ``no_lds`` (A from values made in registers: no
   shared-memory load), ``regs_40`` (the producer warpgroup keeps 40
   registers, the consumers take 232, as in the other conv kernels),
   ``no_group_fence`` (the accumulators not pinned before each group) and
   ``no_split_sum`` (split units store nothing: no partials, no sum; its
   results are wrong where K is split);
3. the SASS of each variant's kernels (``cuobjdump -sass``): instructions,
   HGMMAs, branches and warpgroup waits (``WARPGROUP.DEPBAR``) per
   instance.

``--variants a,b,...`` builds and times only those variants (default:
every one); ``--compile-only`` prints, for each, the instances ptxas
spills in and those whose wgmmas each wait for the last (serialized),
without timing.

Prints the card's name and power limit and one JSON line; the same lands in
``chiprun_out/probe_rows_conv.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((16, 80, 80, 512, 32), (16, 640, 640, 64, 3))

#: A group's products, one group of wgmmas.
STEPS = '''  rows_step<N, KS, P, G, 0>(acc, cor, ah, al, db, frags);
  if constexpr (KS == 16) rows_step<N, KS, P, G, 1>(acc, cor, ah, al, db, frags);
'''

#: A group's rounding (one pass) and split (three passes) in registers.
ROUND = '''        if constexpr (P == 1) {
          ah[i][k][e] = rows_round_x(v[e]);
        } else {
          ah[i][k][e] = v[e] & 0xffffe000u;
          al[i][k][e] = rows_lo(v[e]);
        }
'''

#: A fragment's two shared-memory loads.
LOADS = '''  if constexpr (KS == 16) {
    lds128(u[0], box + rows_offset<KS>(q, ln.t));
    lds128(u[1], box + rows_offset<KS>(q + 8, ln.t));
  } else {
    lds64(u[0], box + rows_offset<KS>(q, ln.t));
    lds64(u[1], box + rows_offset<KS>(q + 8, ln.t));
  }
'''

#: The fragments a group of wgmmas.
GROUPING = '''  static constexpr int kDx = P == 1 || N == 32 ? 3 : 1;
'''

#: name -> [(old, new), ...]: edits of csrc/conv3x3_rows.cu ("as_is":
#: none, the committed source built the probe's way).
VARIANTS = {
    "as_is": [],
    "no_wgmma": [(STEPS, "")],
    "no_round": [(ROUND, '''        ah[i][k][e] = v[e];
        if constexpr (P == 3) al[i][k][e] = v[e];
''')],
    "one_dx": [(GROUPING, "  static constexpr int kDx = 1;\n")],
    "three_dx": [(GROUPING, "  static constexpr int kDx = 3;\n")],
    "no_store": [("    // The epilogue: block j's rows rho, rho + 8 are tile row hr wg + j +\n",
                  "    if (O >= 0) continue;\n"
                  "    // The epilogue: block j's rows rho, rho + 8 are tile row hr wg + j +\n")],
    "one_group": [(STEPS, "  if constexpr (G == 0) {\n" + STEPS + "  }\n")],
    "regs_40": [("  asm volatile(\"setmaxnreg.dec.sync.aligned.u32 56;\\n\" ::: \"memory\");\n",
                 "  asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\\n\" ::: \"memory\");\n"),
                ("  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 224;\\n\" ::: \"memory\");\n",
                 "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\\n\" ::: \"memory\");\n")],
    "no_split_sum": [("      if (!split_sum(out, part, cnt, q.t, wg, q.sp, splits, tid & 127))\n",
                      "      if (q.sp != 0)\n")],
    "no_group_fence": [('''  fence_regs(acc);
  if constexpr (P == 3) fence_regs(cor);
  wgmma_fence();''', "  wgmma_fence();")],
    "no_lds": [(LOADS, '''  for (int i = 0; i < 4; ++i) {
    u[0][i] = 0x3f800000u + q + i;
    u[1][i] = u[0][i] + 8u;
  }
''')],
}


def build_variant(build, name: str, edits) -> ctypes.CDLL:
    """The rows kernel's library with `edits` of conv3x3_rows.cu."""
    d = build.BUILD_DIR / "probe_rows" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (build.SRC_DIR / "conv3x3_rows.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: an edit does not match "
                               f"conv3x3_rows.cu")
        src = src.replace(old, new)
    (d / "conv3x3_rows.cu").write_text(src)
    for header in build.SRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    so = d / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(d / "conv3x3_rows.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rr_conv3x3_rows.argtypes = build.SIGNATURES["rr_conv3x3_rows"]
    lib.rr_conv3x3_rows.restype = ctypes.c_int
    return lib


def sass_stats(so: Path) -> dict:
    """Per instance of conv3x3_rows_kernel in `so`: SASS instructions,
    HGMMAs and WARPGROUP.DEPBAR waits by their bound (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True)
    out, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "conv3x3_rows_kernel" in m.group(1) else None
            if name:
                out[name] = {"instructions": 0, "hgmma": 0, "branches": 0,
                             "depbar": {}}
            continue
        if name is None or not re.search(r"/\*[0-9a-f]{4,}\*/", line):
            continue
        row = out[name]
        row["instructions"] += 1
        if "HGMMA" in line:
            row["hgmma"] += 1
        if re.search(r"\bBRA\b", line):
            row["branches"] += 1
        m = re.search(r"WARPGROUP\.DEPBAR\.LE\s+gsb0,\s*(0x[0-9a-f]+)", line)
        if m:
            key = str(int(m.group(1), 16))
            row["depbar"][key] = row["depbar"].get(key, 0) + 1
    # Short names: the template arguments <N, KS, P, split>.
    short = {}
    for k, v in out.items():
        m = re.search(r"conv3x3_rows_kernel(ILi\d+ELi\d+ELi\d+ELb\d)", k)
        short[m.group(1) if m else k] = v
    return short


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", default=None,
                    help="root of a tree before the rows design, whose "
                         "split-TF32 instance part 1 times beside")
    ap.add_argument("--compile-only", action="store_true",
                    help="each variant's ptxas spills and SASS waits, no "
                         "timing")
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"probe_rows_conv: unknown variants {sorted(unknown)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_rows_conv: CUDA is not available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from rerevst_torch.kernels import _build, conv3x3_implicit_gemm_plain
    from rerevst_torch.kernels.conv3x3 import tf32_rows_plan

    if args.compile_only:
        def report(name):
            src = _build.BUILD_DIR / "probe_rows" / name
            build_variant(_build, name, VARIANTS[name])
            spills = {k[k.index("kernelI") + 6:k.index("EEEv")]:
                      (v.get("spill_stores"), v.get("spill_loads"))
                      for k, v in _build.ptxas_report("conv3x3_rows.cu",
                                                      src).items()
                      if "rows_kernel" in k}
            return {"spills": {k: v for k, v in spills.items() if any(v)},
                    "serialized": [k for k, v in sass_stats(
                        src / "lib.so").items()
                        if v["depbar"].get("0", 0) == v["hgmma"]]}
        with ThreadPoolExecutor(max(1, len(names))) as pool:
            done = {n: pool.submit(report, n) for n in names}
            for n, f in done.items():
                print(json.dumps({"variant": n, **f.result()}), flush=True)
        return 0
    lib = _build.library()
    sys.path.insert(0, str(ROOT / "scripts"))
    import probe_tf32_conv

    with ThreadPoolExecutor(max(1, len(names) + 1)) as pool:  # nvcc at once
        built = {name: pool.submit(build_variant, _build, name,
                                   VARIANTS[name]) for name in names}
        if args.parent is not None:
            old_lib = pool.submit(
                probe_tf32_conv.build_variant, _build, "parent_as_is", [],
                Path(args.parent).resolve() / "rerevst_torch" / "csrc")
        variants = {name: f.result() for name, f in built.items()}
        old_lib = old_lib.result() if args.parent is not None else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": cs.nvidia_smi(), "rows": [], "sass": {
        name: sass_stats(_build.BUILD_DIR / "probe_rows" / name / "lib.so")
        for name in names}}
    out["sass"]["main"] = sass_stats(_build.library_path())
    out["ptxas"] = {k: v for k, v in
                    _build.ptxas_report("conv3x3_rows.cu").items()
                    if "rows" in k}
    ok = True
    for shp in SHAPES:
        x, w, b = cs.conv_inputs(torch, shp[:4], shp[4], torch.float32, gen)
        y = torch.empty(shp[:3] + (shp[4],), device="cuda")
        for passes in (1, 3):
            plan = tf32_rows_plan(*shp, sms, passes)
            ws = torch.empty(plan.weight_floats + plan.workspace_bytes // 4,
                             device="cuda")
            old = probe_tf32_conv.parent_plan(shp, sms)
            old_ws = torch.empty(18 * shp[4] * shp[3], device="cuda")

            def rows(vlib, plan=plan, passes=passes, x=x, w=w, b=b, y=y,
                     ws=ws):
                err = vlib.rr_conv3x3_rows(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    ws.data_ptr(), *x.shape, w.shape[-1], plan.cols, plan.n,
                    plan.ks, plan.grid, plan.splits, passes, stream)
                if err:
                    raise RuntimeError(f"rr_conv3x3_rows: error {err}")

            def split_tf32(old=old, passes=passes, x=x, w=w, b=b, y=y,
                           ws=old_ws):
                err = old_lib.rr_conv3x3(
                    1, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    y.data_ptr(), ws.data_ptr(), *x.shape, w.shape[-1], 0,
                    old.cols, old.n, old.ks, old.grid, old.splits, passes,
                    stream)
                if err:
                    raise RuntimeError(f"rr_conv3x3: error {err}")

            rows(lib)
            torch.cuda.synchronize()
            row_ok = cs.conv_within_tolerance(
                torch, y, conv3x3_implicit_gemm_plain(x, w, b), x, w, b,
                passes=passes)
            ok = ok and row_ok
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = passes == 1
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            cudnn_ms = cs.time_ms(torch, lambda: F.conv2d(xl, wl, b,
                                                          padding=1),
                                  iters=10)["ms"]
            torch.backends.cudnn.allow_tf32 = tf32
            row = {"shape": list(shp), "passes": passes, "ok": row_ok,
                   "plan": {"cols": plan.cols, "rows": plan.rows,
                            "n": plan.n, "ks": plan.ks, "grid": plan.grid,
                            "splits": plan.splits, "smem": plan.smem()},
                   "ms": cs.time_ms(torch, lambda: rows(lib),
                                    iters=20)["ms"],
                   "cudnn_ms": cudnn_ms}
            if old_lib is not None:
                row["split_tf32_ms"] = cs.time_ms(torch, split_tf32,
                                                  iters=20)["ms"]
            for name, vlib in variants.items():
                row[name + "_ms"] = cs.time_ms(
                    torch, lambda: rows(vlib), iters=20)["ms"]
            out["rows"].append(row)
            print(json.dumps({"probe": "rows", **row}), flush=True)
            del ws, old_ws
        del x, w, b, y
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_rows_conv.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"sass": out["sass"]["main"],
                      "ptxas": out["ptxas"]}), flush=True)
    print(out["card"], flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "sass"}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
