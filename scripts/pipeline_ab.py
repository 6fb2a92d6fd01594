#!/usr/bin/env python3
"""Wall time and device idle share of a warm f16 ``stylize_video`` on the
card, for the ``rerevst_torch`` package under a given root — one side of an
A/B of two trees in one call.

    python3 scripts/pipeline_ab.py --root ROOT [--label NAME]

ROOT holds the ``rerevst_torch`` to measure (this repository, or an
unpacked ``git archive`` of another commit).  The session is
``chip_smoke.py``'s global f16 default: the bundled checkpoint, a seeded
33-frame 512x512 clip (``chip_smoke.synth_clip``'s pattern), batch 16.
After two warm-up calls it times three unprofiled calls (host clock around
a synchronized run, every frame consumed), then one call under
``torch.profiler`` (device busy time by kernel against the wall clock).
Prints one JSON line with the card's name and power limit.  Run the two
trees in turns (A, B, B, A) in one call: the card and its host differ from
call to call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CLIP_FRAMES, CONTENT, BATCH = 33, 512, 16


def synth_clip(n, h, w, seed):
    """``chip_smoke.synth_clip``: a smooth seeded pattern that moves a few
    pixels per frame (BGR u8)."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.01, 0.05, (3, 2))
    ph = rng.uniform(0, 6.3, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(n):
        img = np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                           + (yy + 2 * i) * f[c, 1] + ph[c])
                        * np.cos(yy * f[c, 0] * 0.7 - i * 0.05)
                        for c in range(3)], -1)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def synth_style(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / (9 + 4 * c) + c)
                    * np.cos(yy / (13 - 3 * c) - c) for c in range(3)], -1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("pipeline_ab: CUDA is not available", file=sys.stderr)
        return 2
    import rerevst_torch
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig

    if Path(rerevst_torch.__file__).resolve().parent.parent != root:
        print(f"pipeline_ab: imported rerevst_torch from "
              f"{rerevst_torch.__file__}, not {root}", file=sys.stderr)
        return 2
    s = Stylization(str(root / "models" / "demo_plum_4000.msgpack"),
                    cfg=ModelConfig(dtype=torch.float16), device="cuda")
    s.prepare_style(synth_style(CONTENT, CONTENT, seed=1))
    clip = synth_clip(CLIP_FRAMES, CONTENT, CONTENT, seed=0)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in s.stylize_video(clip, batch_size=BATCH))
        torch.cuda.synchronize()
        assert n == CLIP_FRAMES
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        run()
    walls = [run() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith("aten::")) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label or str(root),
                      "warm_wall_ms": walls,
                      "warm_wall_ms_median": sorted(walls)[1],
                      "profiled_wall_ms": wall_prof,
                      "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / wall_prof,
                      "pass1_mode": s.pass1_mode, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
