"""Video stylization CLI — ``rerevst_tpu/stylize.py`` for the port.

    python -m rerevst_torch.stylize --style S.jpg --frames 'clip/*.png' \\
        --checkpoint model.pth -o out/ [--no-global] [--ewarp] [--device cpu]

The reference's video script as a command: two-pass global feature sharing (or
per-frame mode with ``--no-global``), every-8th-frame sampling, PNG frames
under ``<out>/ReReVST-<style>-<clip>[-no-global]/`` and an MJPG ``.avi`` at
24 fps, then one JSON report line.  The same flags and report as
``rerevst_tpu.stylize``, plus ``--device`` (the card by default).  Frame
files and videos are read and written with OpenCV.  ``--devices N`` shards
both passes over a mesh of N devices (``parallel/mesh.py``): N visible
cards, or N logical shards of the CPU with ``--device cpu`` (over cards the
shards enqueue under one GIL: f16 on four cards runs slower than on one,
PERF.md section 5).  ``--tiles``
runs the full-resolution regions over H-slabs (``ops/tiling.py``), and
``--mix`` runs a region of a 16-bit session with fp32 storage
(``ModelConfig.fp32_mix``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig, ModelConfig, dtype_from_name
from rerevst_torch.data import video as vio
from rerevst_torch.data.source import PathsSource, as_source
from rerevst_torch.parallel.mesh import device_mesh
from rerevst_torch.profiling import PhaseTimer, trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rerevst_torch.stylize")
    p.add_argument("--style", required=True, help="style image path")
    p.add_argument("--frames", required=True,
                   help="glob of content frames (e.g. 'clip/*.png') or a "
                        "video file (.avi/.mp4/.mov/...)")
    p.add_argument("--checkpoint", required=True,
                   help=".pth (reference) or .msgpack (native) weights")
    p.add_argument("-o", "--out", default="./result_frames")
    p.add_argument("--video-out", default="./result_videos")
    p.add_argument("--no-global", action="store_true",
                   help="per-frame mode (no sequence-level feature sharing)")
    p.add_argument("--no-video", action="store_true")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--interval", type=int, default=8,
                   help="global-pass sampling interval")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--pad", type=int, default=64,
                   help="reflect-pad margin (reference ReshapeTool: 64); "
                        "the network needs only x8 geometry, so e.g. --pad "
                        "32 --granularity 8 pads fewer pixels per frame")
    p.add_argument("--granularity", type=int, default=64,
                   help="padded-size multiple (reference: 64; a positive "
                        "multiple of 8)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "f16"])
    p.add_argument("--mix", default="none",
                   choices=["none", "out", "res2", "dec", "enc", "full",
                            "body"],
                   help="fp32-storage region of a bf16/f16 session "
                        "(ModelConfig.fp32_mix)")
    p.add_argument("--tiles", type=int, default=1,
                   help="spatial H-tiles for the full-resolution regions "
                        "(ModelConfig.spatial_tiles): bounds their memory "
                        "at large geometries; the same frames")
    p.add_argument("--pairlane", action="store_true",
                   help="run the full-resolution 64-channel convs through "
                        "the conv3x3_pairlane kernel (bf16/f16 only)")
    p.add_argument("--ewarp", action="store_true",
                   help="also report the temporal-consistency metrics of "
                        "the styled output: E_warp (L1) and temporal SSIM "
                        "(Farneback flow + occlusion masking)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard Pass 1/2 over this many devices (0 = single; "
                        "with --device cpu, logical shards of the CPU); "
                        "f16 over 4 cards is slower than 1 (PERF.md)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the run into "
                        "DIR/trace.json")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.pad < 0 or args.granularity < 8 or args.granularity % 8:
        parser.error("--pad must be >= 0 and --granularity a positive "
                     "multiple of 8")
    use_global = not args.no_global

    cfg = ModelConfig(dtype=dtype_from_name(args.dtype), fp32_mix=args.mix,
                      pairlane=args.pairlane, spatial_tiles=args.tiles)
    infer = InferenceConfig(sample_interval=args.interval,
                            use_global=use_global, batch_size=args.batch,
                            fps=args.fps, pad=args.pad,
                            granularity=args.granularity)
    mesh = device_mesh(args.devices, args.device) if args.devices else None
    framework = Stylization(args.checkpoint, cfg=cfg, use_global=use_global,
                            infer=infer, mesh=mesh, device=args.device)
    framework.prepare_style(vio.read_frame(args.style))

    # The pipeline pulls frames from the source lazily, never the whole clip.
    source = as_source(args.frames)
    if isinstance(source, PathsSource):
        out_names = [os.path.basename(p) for p in source.paths]
        clip_name = os.path.basename(os.path.dirname(source.paths[0]))
    else:
        out_names = [f"frame_{i + 1:04d}.png" for i in range(len(source))]
        clip_name = os.path.splitext(os.path.basename(args.frames))[0]

    style_name = os.path.splitext(os.path.basename(args.style))[0]
    name = f"ReReVST-{style_name}-{clip_name}" + (
        "" if use_global else "-no-global")
    out_dir = os.path.join(args.out, name)
    os.makedirs(out_dir, exist_ok=True)

    ewarp_acc = tssim_acc = originals = None
    if args.ewarp:
        from rerevst_torch.eval.ewarp import EwarpAccumulator
        from rerevst_torch.eval.ssim import TemporalSSIMAccumulator

        ewarp_acc = EwarpAccumulator(args.device)
        tssim_acc = TemporalSSIMAccumulator(args.device)
        originals = iter(source)  # a second lazy pass, a frame at a time

    video_writer = (None if args.no_video else vio.VideoWriter(
        os.path.join(args.video_out, f"{name}.avi"), fps=args.fps))
    timer = PhaseTimer()
    t0 = time.time()
    n_out = 0
    try:
        with (trace(args.trace) if args.trace else contextlib.nullcontext()):
            with timer.phase("stylize+write"):
                for i, styled in enumerate(
                        framework.stylize_video(source, args.batch)):
                    vio.write_frame(os.path.join(out_dir, out_names[i]),
                                    styled)
                    if video_writer is not None:
                        video_writer.write(styled)
                    if ewarp_acc is not None:
                        orig = next(originals)
                        ewarp_acc.push(orig, styled)
                        tssim_acc.push(orig, styled)
                    n_out += 1
    finally:
        if video_writer is not None:
            video_writer.close()
    dt = time.time() - t0
    report = {"frames": n_out, "seconds": round(dt, 2),
              "fps": round(n_out / dt, 2), "out": out_dir,
              "pass1": framework.pass1_mode}
    if ewarp_acc is not None and ewarp_acc.pairs >= 1:
        report.update({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in ewarp_acc.result().items()})
        report.update({k: round(v, 4)
                       for k, v in tssim_acc.result().items()})
    print(json.dumps(report))


if __name__ == "__main__":
    main()
