"""Cross-precision pixel parity on real frames — ``rerevst_tpu/eval/parity.py``.

How far a fast configuration's output is from the fp32 configuration's on
the same checkpoint: the whole two-pass ``Stylization`` pipeline runs once
per configuration on the ``ambush_4`` fixture (MPI Sintel, the reference's
smoke clip) with the ``plum_flower`` style, and ``pixel_error`` reports the
per-pixel uint8 error.  The repository's bar is 1e-3 mean |delta| per pixel
on the [0,1] scale.

CLI: ``python -m rerevst_torch.eval.parity [--checkpoint ...] [--frames N]
[--device cuda]``, with ``rerevst_tpu``'s options for the fast
configuration (``--fast_dtype``, ``--fast_precision``, ``--fast_tail``,
``--fast_packed``, ``--pairlane``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

#: The reference repository's test inputs, checked out as ``~/reference``
#: (the JAX package's parity fixture).
FIXTURE_INPUTS = os.path.join(os.path.expanduser("~"), "reference", "test",
                              "inputs")
FIXTURE_FRAMES = os.path.join(FIXTURE_INPUTS, "ambush_4")
FIXTURE_STYLE = os.path.join(FIXTURE_INPUTS, "plum_flower.jpg")
BUNDLED_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "models", "demo_plum_4000.msgpack")


def load_fixture(n_frames: Optional[int] = None,
                 crop: Optional[Tuple[int, int]] = None
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(ambush_4 frames BGR, plum_flower style BGR)."""
    from rerevst_torch.data.video import read_frame

    paths = sorted(glob.glob(os.path.join(FIXTURE_FRAMES, "frame_*.png")))
    if n_frames is not None:
        paths = paths[:n_frames]
    frames = [read_frame(p) for p in paths]
    if crop is not None:
        frames = [f[:crop[0], :crop[1]] for f in frames]
    return frames, read_frame(FIXTURE_STYLE)


def _load_params(checkpoint: str) -> Dict:
    if checkpoint.endswith(".pth"):
        from rerevst_torch.io.torch_compat import load_reference_checkpoint

        return load_reference_checkpoint(checkpoint, dtype=None)
    from rerevst_torch.io.checkpoint import read_msgpack

    return read_msgpack(checkpoint)


def run_pipeline(params: Dict, cfg, frames_bgr, style_bgr,
                 interval: int = 8, batch_size: int = 8,
                 device="cuda") -> List[np.ndarray]:
    """Full two-pass stylization of a clip under one configuration."""
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import InferenceConfig

    s = Stylization(params=params, cfg=cfg, use_global=True,
                    infer=InferenceConfig(sample_interval=interval),
                    device=device)
    s.prepare_style(style_bgr)
    return list(s.stylize_video(frames_bgr, batch_size=batch_size))


def pixel_error(a: List[np.ndarray], b: List[np.ndarray]) -> Dict:
    """Per-pixel uint8 error stats between two rendered clips.

    ``mean_01`` / ``max_01`` are in [0,1]-image units (counts / 255), the
    scale of the 1e-3 per-pixel parity bar."""
    diffs = [np.abs(x.astype(np.int16) - y.astype(np.int16))
             for x, y in zip(a, b)]
    flat = np.concatenate([d.ravel() for d in diffs])
    return {
        "mean_counts": float(flat.mean()),
        "max_counts": int(flat.max()),
        "p99_counts": float(np.percentile(flat, 99)),
        "frac_gt1": float((flat > 1).mean()),
        "frac_gt2": float((flat > 2).mean()),
        "mean_01": float(flat.mean() / 255.0),
        "max_01": float(flat.max() / 255.0),
        "n_frames": len(diffs),
    }


def compare_configs(checkpoint: str, cfg_fast, cfg_ref, n_frames=None,
                    crop=None, interval: int = 8, batch_size: int = 8,
                    device="cuda") -> Dict:
    frames, style = load_fixture(n_frames, crop)
    params = _load_params(checkpoint)
    fast = run_pipeline(params, cfg_fast, frames, style, interval,
                        batch_size, device)
    ref = run_pipeline(params, cfg_ref, frames, style, interval, batch_size,
                       device)
    return pixel_error(fast, ref)


def main(argv=None):
    import argparse
    import json

    import torch

    from rerevst_torch.config import ModelConfig, dtype_from_name

    ap = argparse.ArgumentParser("rerevst_torch.eval.parity")
    ap.add_argument("--checkpoint", default=BUNDLED_CHECKPOINT)
    ap.add_argument("--frames", type=int, default=None,
                    help="limit fixture frames (default: all 33)")
    ap.add_argument("--crop", type=int, nargs=2, default=None,
                    metavar=("H", "W"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fast_dtype", default="f16",
                    choices=["bf16", "f16", "f32"])
    ap.add_argument("--fast_precision", default="auto",
                    choices=["auto", "default", "high", "highest"])
    ap.add_argument("--pairlane", action="store_true",
                    help="the fast config with the conv3x3_pairlane kernel "
                         "(ModelConfig.pairlane)")
    ap.add_argument("--fast_packed", action="store_true",
                    help="the parity-packed route in the fast config "
                         "(ModelConfig.parity_packed: the same functions, "
                         "without the TPU's packed layout)")
    ap.add_argument("--fast_tail", default="none",
                    choices=["none", "out", "res2", "dec", "enc", "full",
                             "body"],
                    help="fp32 storage region in the fast config "
                         "(ModelConfig.fp32_mix)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    args = ap.parse_args(argv)

    fast = ModelConfig(
        dtype=dtype_from_name(args.fast_dtype),
        precision=args.fast_precision, fp32_mix=args.fast_tail,
        parity_packed=args.fast_packed, pairlane=args.pairlane)
    ref = ModelConfig(dtype=torch.float32)
    stats = compare_configs(args.checkpoint, fast, ref,
                            n_frames=args.frames,
                            crop=tuple(args.crop) if args.crop else None,
                            batch_size=args.batch, device=args.device)
    dev = torch.device(args.device)
    print(json.dumps({
        "metric": "pixel_err_fast_vs_f32",
        "value": stats["mean_01"],
        "unit": "mean |Δ| per pixel, [0,1] scale",
        "vs_baseline": stats["mean_01"] / 1e-3,
        "fast_config": (f"{args.fast_dtype}/{args.fast_precision}"
                        f"/tail={args.fast_tail}"
                        + ("/packed" if args.fast_packed else "")),
        **stats,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))


if __name__ == "__main__":
    main()
