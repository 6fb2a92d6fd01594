#!/usr/bin/env python3
"""Device milliseconds per Pass-2 batch of the global f16, pair-lane f16 and
per-frame f16 routes, and the first Pass-2 call of a fresh process, for the
``rerevst_torch`` package under a given root — one side of an A/B of two
trees in one call.

    python3 scripts/pass2_ab.py --root ROOT [--label NAME]

ROOT holds the ``rerevst_torch`` to measure (this repository, or an
unpacked ``git archive`` of another commit).  The sessions are
``chip_smoke.py``'s: the bundled checkpoint, f16, a seeded 512x512 style;
Pass 1 on two seeded 512x512 frames; Pass 2 on one seeded batch of 16
frames padded to 640x640, timed with ``chip_smoke.time_ms`` (CUDA events
behind a sleep kernel, 10 calls after 2).  The first call is the global
session's first ``_stylize`` in this process (host clock, synchronized):
what a fresh server pays once, kernel library loaded.  Prints one JSON line
with the card's name and power limit.  Run the two trees in turns (A, B,
B, A) in one call: the card and its host differ from call to call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("pass2_ab: CUDA is not available", file=sys.stderr)
        return 2
    import rerevst_torch

    if Path(rerevst_torch.__file__).resolve().parent.parent != root:
        print(f"pass2_ab: imported rerevst_torch from "
              f"{rerevst_torch.__file__}, not {root}", file=sys.stderr)
        return 2
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.kernels import _build

    cs = _chip_smoke()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ckpt = str(root / "models" / "demo_plum_4000.msgpack")
    style = cs.synth_style(512, 512, seed=1)
    sampled = cs.synth_clip(2, 512, 512, seed=0)
    batch = cs.synth_clip(16, 512, 512, seed=4)
    out = {"label": args.label or str(root), "build_s": build_s}
    for route, pl, use_global in (("global", False, True),
                                  ("pairlane", True, True),
                                  ("per_frame", False, False)):
        s = Stylization(ckpt, cfg=ModelConfig(dtype=torch.float16,
                                              pairlane=pl),
                        use_global=use_global, device="cuda")
        s.prepare_style(style)
        if use_global:
            s.prepare_global(sampled)
        x = s._upload(s._prep_batch_host(batch))
        if route == "global":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s._stylize(x)
            torch.cuda.synchronize()
            out["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        t = cs.time_ms(torch, lambda: s._stylize(x), iters=10, warmup=2)
        out[route] = {"pass2_batch_ms": t["ms"], "host_ms": t["host_ms"],
                      "host_paced": t["host_paced"]}
        del s, x
        torch.cuda.empty_cache()
    out["card"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
