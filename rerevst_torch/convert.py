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
Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``--train-export`` and ``--train-import`` (training-state interop,
Queue 1 item 6) and ``--export-aot`` (Queue 1 item 7).
"""

from __future__ import annotations

import argparse


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
                         "-epoch-N.pth) into dst/ (not ported: raises)")
    ap.add_argument("--train-import", action="store_true",
                    help="src = reference style_net-epoch-N.pth: write a "
                         "native train-state checkpoint into dst/ (not "
                         "ported: raises)")
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
                         "compiled Pass-2 hot path (not ported: raises)")
    ap.add_argument("--hw", default="640x640",
                    help="with --export-aot: PADDED frame geometry HxW")
    ap.add_argument("--batches", default="1",
                    help="with --export-aot: comma-separated batch sizes")
    ap.add_argument("--dtype", default="f16",
                    choices=["bf16", "f16", "f32"],
                    help="with --export-aot: model storage dtype")
    ap.add_argument("--platforms", default="cpu,tpu",
                    help="with --export-aot: lowering platforms")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, what, item in (
            (args.train_export, "--train-export (training-state export)",
             "Queue 1 item 6"),
            (args.train_import, "--train-import (training-state import)",
             "Queue 1 item 6"),
            (args.export_aot, "--export-aot (AOT bundles)",
             "Queue 1 item 7")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md {item}")

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
