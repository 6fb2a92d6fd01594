"""Training CLI: ``python -m rerevst_torch.train --style_content_loss ...`` —
``rerevst_tpu/train/__main__.py`` for the port.

The same flags as the JAX CLI (the reference's, ``train/train.py:24-90``),
plus ``--device`` (the card by default; ``--device cpu`` runs the plain
PyTorch path).  The proposed model is ``--dynamic_filter --both_sty_con
--style_content_loss --recon_loss --tv_loss --temporal_loss --relax_style
--data_sigma --data_w``; ``--adaversarial_loss`` (the reference's
spelling) adds the PatchGAN term (``--gan_mode``, ``--ganWeight``,
``--init_type``), and ``--use_mpi``/``--use_video`` train the Figure-16
ablations on real pairs.  ``--data_parallel N`` shards each batch over N
devices (N visible cards, or N logical shards of the CPU with ``--device
cpu``) in this process; ``--num_processes N --coordinator HOST:PORT
--process_id I``, run once per process, joins N processes through
``torch.distributed`` (NCCL on the cards, gloo on the CPU), one card per
process, ``--batchSize`` per process.  On several cards run one process
per card: the in-process shards enqueue under one GIL and a step over
them is slower than on one card (PERF.md section 5).
"""

import argparse

import torch.distributed as dist

from rerevst_torch.config import (
    LossConfig,
    ModelConfig,
    TrainConfig,
    dtype_from_name,
)
from rerevst_torch.parallel.mesh import distributed_init
from rerevst_torch.train.loop import train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rerevst_torch.train")
    p.add_argument("--manualSeed", type=int, default=0)
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--epoches", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log", type=int, default=1000)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--load_step", type=int, default=None,
                   help="with --continue_training: resume from this exact "
                        "step's checkpoint (the reference's --load_epoch, "
                        "train/train.py:148-153)")
    p.add_argument("--pretrained", default=None,
                   help="initialize params from a checkpoint (.pth via the "
                        "3-stage LoadPretrained graft, train/train.py:124-"
                        "146, or native .msgpack)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=None)

    p.add_argument("--content_data", default="./data/content/")
    p.add_argument("--style_data", default="./data/style/")
    p.add_argument("--outf", default="result")
    p.add_argument("--valf", default="val")
    p.add_argument("--log_dir", default="log")

    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--fineSize", type=int, default=256)
    p.add_argument("--flip", type=int, default=1)

    p.add_argument("--dynamic_filter", action="store_true")
    p.add_argument("--both_sty_con", action="store_true")
    p.add_argument("--train_only_decoder", action="store_true")
    p.add_argument("--use_mpi", action="store_true")
    p.add_argument("--use_video", action="store_true")

    p.add_argument("--temporal_loss", action="store_true")
    p.add_argument("--style_content_loss", action="store_true")
    p.add_argument("--recon_loss", action="store_true")
    p.add_argument("--tv_loss", action="store_true")
    p.add_argument("--relax_style", action="store_true")
    p.add_argument("--old_style_loss", action="store_true")
    p.add_argument("--adaversarial_loss", action="store_true",
                   help="the PatchGAN adversarial term (the reference's "
                        "spelling)")

    p.add_argument("--contentWeight", type=float, default=1.0)
    p.add_argument("--styleWeight", type=float, default=20.0)
    p.add_argument("--reconWeight", type=float, default=20.0)
    p.add_argument("--tvWeight", type=float, default=10.0)
    p.add_argument("--temporalWeight", type=float, default=60.0)
    p.add_argument("--ganWeight", type=float, default=1.0)
    p.add_argument("--init_type", default="normal",
                   choices=["normal", "xavier", "kaiming", "orthogonal"],
                   help="discriminator weight init scheme "
                        "(train/other_networks.py:28-49 init_weights)")
    p.add_argument("--gan_mode", default="lsgan",
                   choices=["lsgan", "vanilla", "wgangp"],
                   help="GAN objective with --adaversarial_loss "
                        "(train/other_networks.py:81-101; the reference's "
                        "train script hardcodes lsgan)")
    p.add_argument("--oldWeight", type=float, default=10.0)
    p.add_argument("--relaxed_blur_scale", type=int, default=1,
                   help="smooth the relaxed flow at 1/N resolution "
                        "(LossConfig.relaxed_blur_scale; 1 = the reference "
                        "recipe's full-res 101-tap blur).  ~N^3 less blur "
                        "work, approximate target selection")
    p.add_argument("--relaxed_inner_dtype", default="same",
                   choices=["same", "bf16"],
                   help="compute dtype for the relaxed loss's 16-iteration "
                        "inner flow optimization; 'bf16' runs the inner VGG "
                        "fwd+bwd in bfloat16 (flow/loss bookkeeping stays "
                        "fp32) — the inner loop only selects the warped "
                        "style target")

    p.add_argument("--data_sigma", action="store_true")
    p.add_argument("--data_w", action="store_true")
    p.add_argument("--data_noise_level", type=float, default=0.001)
    p.add_argument("--data_motion_level", type=float, default=8.0)
    p.add_argument("--data_shift_level", type=int, default=10)

    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard the batch over this many devices (0 = one "
                        "device; with --device cpu, logical shards of the "
                        "CPU); with multi-process flags the mesh spans the "
                        "processes and batchSize is PER PROCESS; on several "
                        "cards one process per card is faster (PERF.md)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into this many micro-batches "
                        "inside one step, averaging their gradients — less "
                        "activation memory at the same effective batch")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the rendezvous host:port "
                        "(torch.distributed, the same on every process)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="multi-process: total process count")
    p.add_argument("--process_id", type=int, default=0,
                   help="multi-host: this process's id in [0, "
                        "num_processes)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "'cpu' runs the plain PyTorch path)")
    p.add_argument("--vgg_init", default="torch",
                   choices=["torch", "he_relu"],
                   help="VGG init for fresh backbones: 'he_relu' keeps deep "
                        "features O(1) when no pretrained VGG exists "
                        "(the bundled demo model's recipe)")
    return p


def config_from_args(a) -> TrainConfig:
    model = ModelConfig(
        dynamic_filter=a.dynamic_filter,
        both_sty_con=a.both_sty_con,
        dtype=dtype_from_name(a.dtype),
    )
    loss = LossConfig(
        style_content_loss=a.style_content_loss,
        recon_loss=a.recon_loss,
        tv_loss=a.tv_loss,
        temporal_loss=a.temporal_loss,
        relax_style=a.relax_style,
        old_style_loss=a.old_style_loss,
        adversarial_loss=a.adaversarial_loss,
        content_weight=a.contentWeight,
        style_weight=a.styleWeight,
        recon_weight=a.reconWeight,
        tv_weight=a.tvWeight,
        temporal_weight=a.temporalWeight,
        gan_weight=a.ganWeight,
        gan_mode=a.gan_mode,
        old_weight=a.oldWeight,
        relaxed_inner_dtype=a.relaxed_inner_dtype,
        relaxed_blur_scale=a.relaxed_blur_scale,
        data_sigma=a.data_sigma,
        data_w=a.data_w,
        noise_level=a.data_noise_level,
        motion_level=a.data_motion_level,
        shift_level=a.data_shift_level,
    )
    return TrainConfig(
        batch_size=a.batchSize, epochs=a.epoches, lr=a.lr,
        log_every=a.log, num_workers=a.num_workers,
        load_size=a.loadSize, fine_size=a.fineSize, flip=bool(a.flip),
        seed=a.manualSeed, content_data=a.content_data,
        style_data=a.style_data, out_dir=a.outf, val_dir=a.valf,
        log_dir=a.log_dir, train_only_decoder=a.train_only_decoder,
        use_mpi=a.use_mpi, use_video=a.use_video, d_init=a.init_type,
        data_parallel=a.data_parallel, grad_accum=a.grad_accum,
        loss=loss, model=model,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.num_processes > 1:
        # Run this module once per process with the same --coordinator and
        # a unique --process_id; the mesh then spans the processes.
        if not args.coordinator:
            raise SystemExit("--num_processes > 1 needs --coordinator")
        distributed_init(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)
    cfg = config_from_args(args)
    print(cfg, flush=True)
    try:
        train(cfg, max_steps=args.max_steps, resume=args.continue_training,
              pretrained=args.pretrained, load_step=args.load_step,
              vgg_init=args.vgg_init, device=args.device)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
