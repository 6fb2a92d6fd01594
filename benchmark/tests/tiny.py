"""Helpers of the benchmark's CPU tests: a copy of the benchmark with its
traffic shrunk to a size the CPU runs in seconds, and a run of one cell in
a fresh process from that copy."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

#: What the tests shrink: clips of 9 frames of 64 x 96, batch 4; train
#: crops of 64 x 64 from a pool of 5 batches.
TINY = {"clips": dict(frames=9, height=64, width=96, batch=4, clips=2,
                      style_size=64, warmup_clips=1),
        "train": dict(size=64, pool=5)}


def tiny_tree(dst: Path) -> Path:
    """`dst` holding the benchmark (traffic shrunk), ``BENCHMARK.json`` and
    links to the program and its weights."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name in ("rerevst_torch", "models"):
        os.symlink(ROOT / name, dst / name)
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(TINY[t["kind"]])
        if "check" in t:
            t["check"].update(iterations=6, frames_per_iteration=3)
        p.write_text(json.dumps(t))
    return dst


#: Runs one cell on the CPU from a tree, with an optional fault planted by
#: `PATCH` (Python source run after the imports), and prints the result.
_RUNNER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark import run
bench = json.load(open(sys.argv[1] + "/BENCHMARK.json"))
cell = {w["name"]: w for w in bench["workloads"]}[sys.argv[2]]
exec(sys.argv[4])
res = run.run_cell(bench, cell, 2**31 + 11, float(sys.argv[5]),
                   bool(int(sys.argv[3])),
                   device="cpu", root=__import__("pathlib").Path(sys.argv[1]))
res["forbidden"] = run.forbidden_modules()
print(json.dumps(res))
"""


def run_cell(tree: Path, cell: str, trace: int = 0, patch: str = "",
             seconds: float = 0.5, timeout: int = 600) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(tree), cell, str(trace), patch,
         str(seconds)],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(tree))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
