"""Multi-style interpolation CLI — ``rerevst_tpu/interpolate.py`` for the port.

    python -m rerevst_torch.interpolate --styles A.jpg B.jpg \\
        --frames 'clip/*.png' --checkpoint model.pth -o out/ [--device cpu]

Encodes every frame once, freezes per-style sequence statistics (interval 16
sampling), then decodes every frame with the blend weights sweeping linearly
from the last style to the first (or under ``--weights``), and prints one
JSON report line.  The same flags and report as ``rerevst_tpu.interpolate``,
plus ``--device`` (the card by default).  Frame files and videos are read
and written with OpenCV.  ``--devices N`` shards each style's Pass 1 and
the decodes over a mesh of N devices (``parallel/mesh.py``): N visible
cards, or N logical shards of the CPU with ``--device cpu`` (over cards the
shards enqueue under one GIL, PERF.md section 5).  ``--mix`` runs a
region of a 16-bit session with fp32 storage (``ModelConfig.fp32_mix``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from rerevst_torch.config import InferenceConfig, ModelConfig, dtype_from_name
from rerevst_torch.data import video as vio
from rerevst_torch.data.source import PathsSource, as_source
from rerevst_torch.multistyle import MultiStylization
from rerevst_torch.parallel.mesh import device_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rerevst_torch.interpolate")
    p.add_argument("--styles", nargs="+", required=True,
                   help="2+ style image paths")
    p.add_argument("--frames", required=True,
                   help="glob of content frames or a video file")
    p.add_argument("--checkpoint", required=True,
                   help=".pth (reference) or .msgpack (native) weights")
    p.add_argument("-o", "--out", default="./result_interp")
    p.add_argument("--interval", type=int, default=16)
    p.add_argument("--weights", default=None,
                   help="per-frame weight schedule: inline JSON or a path to "
                        "a JSON file holding an [n_frames][n_styles] array.  "
                        "Default: linear sweep through all styles.")
    p.add_argument("--style-size", type=int, default=384,
                   help="styles resized to this square (reference: 384)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "f16"])
    p.add_argument("--mix", default="none",
                   choices=["none", "out", "res2", "dec", "enc", "full",
                            "body"],
                   help="fp32-storage region of a bf16/f16 session "
                        "(ModelConfig.fp32_mix)")
    p.add_argument("--pairlane", action="store_true",
                   help="run the full-resolution 64-channel convs through "
                        "the conv3x3_pairlane kernel (bf16/f16 only)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard per-style Pass 1 and the decodes over this "
                        "many devices (0 = single; with --device cpu, "
                        "logical shards of the CPU)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cv2 = vio.require_cv2()
    cfg = ModelConfig(dtype=dtype_from_name(args.dtype), fp32_mix=args.mix,
                      pairlane=args.pairlane)
    infer = InferenceConfig(sample_interval=args.interval)
    mesh = device_mesh(args.devices, args.device) if args.devices else None
    ms = MultiStylization(checkpoint=args.checkpoint, cfg=cfg, infer=infer,
                          mesh=mesh, device=args.device)
    ms.prepare_styles([cv2.resize(vio.read_frame(s),
                                  (args.style_size, args.style_size))
                       for s in args.styles])

    # Lazy frame source: one frame at a time, and long clips spill their
    # feature cache to a temp memmap.
    source = as_source(args.frames)
    if isinstance(source, PathsSource):
        out_names = [os.path.basename(p) for p in source.paths]
    else:
        out_names = [f"frame_{i + 1:04d}.png" for i in range(len(source))]

    weights = None
    if args.weights is not None:
        raw = args.weights
        if not raw.lstrip().startswith("["):
            with open(raw) as f:
                raw = f.read()
        weights = json.loads(raw)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    n = 0
    for i, styled in enumerate(ms.interpolate_video(source, weights=weights)):
        vio.write_frame(os.path.join(args.out, out_names[i]), styled)
        n += 1
    dt = time.time() - t0
    print(json.dumps({"frames": n, "seconds": round(dt, 2),
                      "out": args.out}))


if __name__ == "__main__":
    main()
