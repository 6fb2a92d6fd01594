#!/usr/bin/env python3
"""E_warp of the two inference modes on synthetic exact pans: which pan lets
``chip_smoke.py``'s temporal phase read the difference between the modes.

    python3 scripts/probe_pan_ewarp.py [--device cuda] [--size 512]

For each texture (``chip_smoke.blob_texture``, broad colour blobs under
finer detail, and a stationary sum of sinusoids) and each pan (3x2, 8x4 and
8x8 px per frame), it stylizes 17 frames with the bundled checkpoint in
global and in per-frame mode (f16 on the card, fp32 on the CPU) and prints
one JSON line with both E_warp values under the exact flow; the last line
names the device (with its power limit on the card).  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def sinusoid_texture(h, w, seed):
    """A seeded texture whose statistics are the same everywhere."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.02, 0.09, (3, 4))
    tex = np.stack([128 + 60 * np.sin(xx * f[c, 0] + yy * f[c, 1] + c)
                    + 40 * np.cos(xx * f[c, 2] - yy * f[c, 3])
                    for c in range(3)], -1)
    return np.clip(tex + rng.normal(0, 6, tex.shape), 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.eval.ewarp import ewarp

    ap = argparse.ArgumentParser("probe_pan_ewarp")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    dev, size, n = torch.device(args.device), args.size, 17
    dtype = torch.float16 if dev.type == "cuda" else torch.float32
    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    style = cs.synth_style(size, size, seed=1)
    sessions = {}
    for use_global in (True, False):
        s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype),
                        use_global=use_global, device=dev)
        s.prepare_style(style)
        sessions[use_global] = s
    for texture in ("blobs", "sinusoid"):
        for dx, dy in ((3, 2), (8, 4), (8, 8)):
            h, w = size + (n - 1) * dy, size + (n - 1) * dx
            tex = (cs.blob_texture(h, w, size, seed=6) if texture == "blobs"
                   else sinusoid_texture(h, w, seed=6))
            clip = cs.pan_windows(tex, n, size, dx, dy)
            flow = np.zeros((size, size, 2), np.float32)
            flow[..., 0], flow[..., 1] = dx, dy
            ew = {}
            for use_global, s in sessions.items():
                out = list(s.stylize_video(clip, batch_size=16))
                ew[use_global] = ewarp(out, clip, flows=[flow] * (n - 1),
                                       device=dev)["ewarp"]
            print(json.dumps({
                "texture": texture, "pan_px": [dx, dy], "frames": n,
                "size": size, "dtype": str(dtype),
                "ewarp_global": ew[True], "ewarp_per_frame": ew[False],
                "improvement_pct": 100 * (1 - ew[True] / ew[False])}),
                flush=True)
    print(cs.nvidia_smi() if dev.type == "cuda" else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
