#!/usr/bin/env python3
"""Run one cell of the benchmark of ``rerevst_torch`` on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); the mix's ``kind`` names the general
driver that reads it (``benchmark/drivers/<kind>.py``).  Set-up loads the
program, makes the inputs from the seed and warms up every shape the cell
uses; the window then runs for ``--seconds``.  With ``--trace 0`` the last
line of standard output carries the cell's end-to-end metrics.  With
``--trace 1`` a first window runs under ``torch.profiler`` (``--seconds``,
or the mix's ``trace_seconds`` where that is shorter: reading a trace
takes longer than making it), then the window as a ``--trace 0`` run has
it, and the line carries the per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from the trace, the untraced window's
counters or both, and a ``breakdown``.  After
the last window the program's state is freed and the plain reference under
``benchmark/reference/`` judges what that window produced.

Set-up's clock starts with the process and includes the kernel library's
build on a checkout's first run; the build's own seconds go to standard
error as ``build_s``.

Exits 2 without a result when no card (or too few) is visible, and 3 when a
JAX module is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "rerevst_tpu")


def cache_env(bench_dir: Path = BENCH) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = bench_dir / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_program(device: str) -> None:
    """Load (on a checkout's first run, build) the program's kernel and
    host libraries, and print how long that took as ``build_s``."""
    t0 = time.perf_counter()
    built = False
    if device != "cpu":
        from rerevst_torch.kernels import _build

        built = not _build.library_path().exists()
        _build.library()
    from rerevst_torch.data import native

    built = built or not native.library_path().exists()
    native.available()
    print(f"build_s {time.perf_counter() - t0!r} (built: {built})",
          file=sys.stderr, flush=True)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START) -> dict:
    """Set up, measure and judge one cell; the result's dict."""
    import torch

    bdir = root / "benchmark"
    config = json.loads((bdir / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = json.loads((bdir / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    ctx = SimpleNamespace(root=root, bench=bench, cell=cell, config=config,
                          traffic=traffic, device=device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    load_program(device)
    runner = driver.Cell(ctx)
    runner.setup(seed)
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s!r}", file=sys.stderr, flush=True)

    from benchmark.lib.trace import WINDOW_RANGE, Trace

    tr = traced = None
    if trace:
        # The profiler slows the host's pace: its window gives the device's
        # view, and the untraced window after it the pace (PERF.md s. 3).
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=True)
        prof.start()
        with torch.profiler.record_function(WINDOW_RANGE):
            traced = dict(runner.window(
                min(seconds, traffic.get("trace_seconds", seconds))))
        prof.stop()
        tr = Trace(prof.events(), traced["window_s"])
        del prof
        # Millions of events stay for the readers: keep the collector's
        # passes off them, or they slow the untraced window's host.
        gc.collect()
        gc.freeze()
    with torch.profiler.record_function(WINDOW_RANGE):
        counters = runner.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device) if device != "cpu"
            else 0)

    e2e = dict(runner.end_to_end(), setup_s=setup_s)
    name = cell["name"]
    reported = {m["name"] for m in bench["end_to_end"]
                if applies(m, name, set(e2e))}
    runner.release()
    ok, attempted, failed, compared = runner.check()
    metrics = {}
    if trace:
        reader_ctx = SimpleNamespace(trace=tr, counters=counters,
                                     traced_counters=traced,
                                     runner=runner, config=config,
                                     traffic=traffic, cell=cell)
        for m in bench["per_layer"]:
            if not applies(m, name, reported):
                continue
            reader = load_file(bdir / "metrics" / f"{m['name']}.py")
            value = reader.read(reader_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; have {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    from benchmark.lib.check import report

    report(result["compared"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
