"""Checkpoint conversion CLI: reference PyTorch .pth <-> native msgpack —
``rerevst_tpu/convert.py`` for the port.

    python -m rerevst_torch.convert style_net-TIP-final.pth model.msgpack
    python -m rerevst_torch.convert model.msgpack reference.pth

The released-checkpoint schema (``test/framework.py:74-78`` of the
reference) in both directions, with the same arguments and report line as
``rerevst_tpu.convert``.  A ``.pth`` is read with
``io.torch_compat.load_reference_checkpoint`` (weights in fp32, extra keys
ignored); a ``.msgpack`` is read and written by the port's own flax-msgpack
codec (``io/checkpoint.py``), byte for byte what the JAX package writes.
Conversion is file I/O on the host: no tensor reaches a device.

A bf16 ``.msgpack`` (the bundled checkpoints) converts to a ``.pth`` of bf16
tensors; the JAX CLI cannot (``torch.from_numpy`` takes no bf16 array).

The train state, as ``rerevst_tpu.convert`` moves it:

    # ckpt-stepN.msgpack (+ netD-stepN.msgpack) -> style_net-epoch-N.pth
    # + optimizer-epoch-N.pth (+ netD-epoch-N.pth)
    python -m rerevst_torch.convert --train-export \
        out/ckpt-step00000042.msgpack torch_out/
    # the reference's files -> ckpt-stepN.msgpack (+ netD-stepN.msgpack)
    python -m rerevst_torch.convert --train-import style_net-epoch-1.pth \
        native_out/ --optimizer optimizer-epoch-1.pth --netd netD-epoch-1.pth

An export takes D from ``--netd``, else from the ``netD-step*.msgpack``
beside the generator's checkpoint at its step, else the newest one (with a
warning: the G and D steps then differ).  An import writes D with a fresh
Adam state: the reference never saves D's optimizer.

An AOT Pass-2 bundle (``io/aot.py``), as ``rerevst_tpu.convert`` exports
one:

    python -m rerevst_torch.convert model.msgpack pass2.rvaot --export-aot \
        --hw 640x640 --batches 1,16 --dtype f16 --platforms cuda

``--platforms`` defaults to ``cpu,cuda``.  Exporting for ``cuda`` traces on
the card, so it needs one; without a card the command refuses ``cuda`` and
writes nothing (``--platforms cpu`` exports the CPU graph alone).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("rerevst_torch.convert")
    ap.add_argument("src", help=".pth or .msgpack checkpoint")
    ap.add_argument("dst", help="output path (.msgpack or .pth), or a "
                               "directory for --train-export/--train-import")
    ap.add_argument("--no-loss-net", action="store_true",
                    help="drop the frozen Vgg19 loss net (inference-only)")
    ap.add_argument("--train-export", action="store_true",
                    help="src = native ckpt-stepN.msgpack: write the "
                         "reference training trio (style_net/optimizer/netD "
                         "-epoch-N.pth) into dst/")
    ap.add_argument("--train-import", action="store_true",
                    help="src = reference style_net-epoch-N.pth: write a "
                         "native train-state checkpoint into dst/")
    ap.add_argument("--optimizer", default=None,
                    help="with --train-import: optimizer-epoch-N.pth")
    ap.add_argument("--netd", default=None,
                    help="discriminator checkpoint (either direction)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="with --train-export: epoch tag for the filenames "
                         "(default: the native checkpoint's step)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--export-aot", action="store_true",
                    help="src = checkpoint, dst = bundle: export the "
                         "global-mode Pass-2 graph (torch.export, the "
                         "kernels as rerevst:: ops) as a deployment "
                         "artifact")
    ap.add_argument("--hw", default="640x640",
                    help="with --export-aot: PADDED frame geometry HxW")
    ap.add_argument("--batches", default="1",
                    help="with --export-aot: comma-separated batch sizes")
    ap.add_argument("--dtype", default="f16",
                    choices=["bf16", "f16", "f32"],
                    help="with --export-aot: model storage dtype")
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="with --export-aot: the devices to export a graph "
                         "for (cuda needs a card)")
    return ap


def _netd_beside(src: str, m) -> Optional[str]:
    """The ``netD-step*.msgpack`` to pair with the generator checkpoint
    `src`: the one at its step, else the newest (with a warning)."""
    src_dir = os.path.dirname(src) or "."
    if m is not None:
        exact = os.path.join(src_dir,
                             f"netD-step{int(m.group(1)):08d}.msgpack")
        if os.path.exists(exact):
            return exact
    cands = sorted(glob.glob(os.path.join(src_dir, "netD-step*.msgpack")))
    if not cands:
        return None
    if m is not None:
        print(f"warning: no netD checkpoint at step {int(m.group(1))}; "
              f"exporting newest ({cands[-1]}) — G/D steps will not match",
              flush=True)
    return cands[-1]


def _train_export(args) -> None:
    from rerevst_torch.io.checkpoint import read_msgpack, restore_train_state
    from rerevst_torch.io.torch_compat import export_train_checkpoint

    m = re.search(r"step(\d+)", os.path.basename(args.src))
    netd = args.netd if args.netd is not None else _netd_beside(args.src, m)
    d_params = None
    if netd is not None:
        d_blob = read_msgpack(netd)
        d_params = d_blob.get("params", d_blob)
    params, opt_state = restore_train_state(args.src)
    epoch = args.epoch if args.epoch is not None else (
        int(m.group(1)) if m else 0)
    out = export_train_checkpoint(args.dst, epoch, params,
                                  opt_state=opt_state, d_params=d_params,
                                  lr=args.lr)
    print(f"exported train state -> {sorted(out.values())}")


def _train_import(args) -> None:
    import torch

    from rerevst_torch.config import TrainConfig
    from rerevst_torch.io.checkpoint import save_params, save_train_state
    from rerevst_torch.io.torch_compat import import_train_checkpoint
    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_torch.train.state import (
        d_opt_state_tree,
        init_d_state,
        init_train_state,
        opt_state_tree,
    )

    # The paper recipe's (default) architecture, as the reference files it
    # reads; subtrees the files lack keep this seeded init.
    cfg = TrainConfig(lr=args.lr)
    template = init_transformer_params(
        torch.Generator().manual_seed(cfg.seed), cfg.model,
        with_loss_net=True)
    params, opt_state, step, d_params = import_train_checkpoint(
        args.src, template, opt_state_tree(init_train_state(template, cfg)),
        optimizer_pth=args.optimizer, netd_pth=args.netd)
    wrote = [save_train_state(args.dst, step, params, opt_state)]
    if d_params is not None:
        # A fresh Adam state: the reference never saves D's optimizer.
        dpath = os.path.join(args.dst, f"netD-step{step:08d}.msgpack")
        save_params(dpath, {"params": d_params,
                            "opt_state": d_opt_state_tree(
                                init_d_state(d_params)),
                            "step": step})
        wrote.append(dpath)
    print(f"imported train state @ step {step} -> {wrote}")


def _export_aot(args) -> None:
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig, dtype_from_name
    from rerevst_torch.io.aot import check_platforms, save_bundle

    h, w = (int(v) for v in args.hw.lower().split("x"))
    batches = [int(b) for b in args.batches.split(",")]
    platforms = args.platforms.split(",")
    check_platforms(platforms)  # before the model loads
    cfg = ModelConfig(dtype=dtype_from_name(args.dtype))
    session = Stylization(checkpoint=args.src, cfg=cfg, use_global=True,
                          device="cuda" if "cuda" in platforms else "cpu")
    meta = save_bundle(args.dst, session, (h, w), batches=batches,
                       platforms=platforms)
    size_mb = os.path.getsize(args.dst) / (1 << 20)
    print(f"AOT bundle {args.dst}: {meta['hw'][0]}x{meta['hw'][1]} batches "
          f"{meta['batches']} platforms {meta['platforms']} "
          f"({size_mb:.1f} MB)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.export_aot:
        return _export_aot(args)
    if args.train_export:
        return _train_export(args)
    if args.train_import:
        return _train_import(args)

    from rerevst_torch.io.checkpoint import read_msgpack, save_params
    from rerevst_torch.io.torch_compat import (
        load_reference_checkpoint,
        to_reference_state_dict,
    )

    if args.src.endswith(".pth"):
        params = load_reference_checkpoint(args.src)
    else:
        params = read_msgpack(args.src)
    if args.no_loss_net:
        params = {k: v for k, v in params.items() if k != "vgg_loss"}

    if args.dst.endswith(".pth"):
        import torch

        torch.save(to_reference_state_dict(params), args.dst)
    else:
        save_params(args.dst, params)
    print(f"converted {args.src} -> {args.dst} "
          f"({', '.join(sorted(params))})")


if __name__ == "__main__":
    main()
