#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison: the program as its
configuration states on many seeds, and the control (the configuration's
``control``: the program's own path one precision below) on a few, in one
process.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        [--control-seeds 7,8,9] [--faults]

Each seed's inputs go through the cell's own entry at its own sizes, and
the reference judges them as a run's check does; no window is timed.  One
JSON line per reading (``{"side": "program"|"control"|<fault>, "seed",
...numbers}``), then a summary line with the largest program reading and the
smallest control reading of each number.  The benchmark's runs never call
this; its numbers set the limits in the configuration files (PERF.md says
which readings set which limit).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true",
                    help="also read the faults the cell's driver can plant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    run.cache_env()
    import importlib

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    ctx = SimpleNamespace(root=ROOT, bench=bench, cell=cell, config=config,
                          traffic=traffic, device=args.device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    runner = driver.Cell(ctx)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    runner.load(seeds[0])
    runner.release()
    rows = []
    sides = [("program", s, config["model"]) for s in seeds]
    sides += [("control", s, dict(config["model"], **config["control"]))
              for s in controls]
    if args.faults:
        sides += [(f, s, config["model"]) for f in runner.FAULTS
                  for s in controls or seeds[:3]]
    for side, seed, spec in sides:
        t0 = time.perf_counter()
        got = (runner.calibrate(seed, spec) if side in ("program", "control")
               else runner.calibrate(seed, spec, fault=side))
        row = {"side": side, "seed": seed, **got,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in config["limits"]:
        prog = [r[key] for r in rows if r["side"] == "program"]
        summary[key] = {"program_max": max(prog) if prog else None}
        for side in {r["side"] for r in rows} - {"program"}:
            vals = [r[key] for r in rows if r["side"] == side]
            summary[key][f"{side}_min"] = min(vals)
    if args.device == "cuda":
        summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
