"""Typed configuration of the model, the video pipeline and training.

Mirrors ``rerevst_tpu/config.py`` field for field, with torch dtypes.  The
port supports the default architecture and both ablation switches
(``dynamic_filter``, ``both_sty_con``; per-frame mode only, as in the JAX
package); a switch that selects a path the port does not have yet raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it, so no
setting is silently ignored (``outpairs`` excepted, see its comment).
"""

from __future__ import annotations

import dataclasses

import torch

#: Storage dtypes the port runs in.
STORAGE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  Raises where CUDA is absent and the caller did not pass
    ``device="cpu"`` — nothing falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture switches of the transformer network
    (``rerevst_tpu.config.ModelConfig``)."""

    #: Dynamic (content, style)-predicted 1x1 filter chain at relu4_1 scale.
    dynamic_filter: bool = True
    #: Filters predicted from content AND style (KernelFilter); False gives
    #: the style-only 3x3 filters of KernelFilter_S.
    both_sty_con: bool = True
    #: Channel width of the dynamic-filter bottleneck.
    filter_channels: int = 32
    #: VGG channel width at relu4_1.
    vgg_channels: int = 512
    #: Epsilon inside the InstanceNorm rsqrt.
    norm_eps: float = 1e-8
    #: Epsilon inside the style mean/std.
    mean_std_eps: float = 1e-5
    #: Storage dtype of activations and weights.  fp32 runs every conv and
    #: matmul in true fp32 (see ``models.layers.conv2d``).
    dtype: torch.dtype = torch.float32
    #: Dtype of normalization statistics and reductions (always fp32).
    stats_dtype: torch.dtype = torch.float32
    #: Product precision: 'auto' (fp32 storage -> true fp32 products; 16-bit
    #: storage -> the card's native 16-bit products) or 'highest'.
    precision: str = "auto"
    #: fp32 storage region inside a low-precision model ('none' only).
    fp32_mix: str = "none"
    mix_precision: str = "default"
    #: TPU layout variants of the same functions (not ported).
    parity_packed: bool = False
    luma_fold: bool = False
    #: Route the full-resolution 64-channel convs (encoder conv1_2, decoder
    #: res2.conv2 and the out conv) through the ``conv3x3_pairlane`` kernel
    #: in f16/bf16 sessions where the geometry allows it; fp32 sessions keep
    #: the default path.  The TPU's W-pair lane layout is not ported: the
    #: region stays NHWC in the session's storage dtype.
    pairlane: bool = False
    #: H-tiling of the full-resolution regions (1 = off).
    spatial_tiles: int = 1
    #: Accepted with any value and ignored: on the TPU it only picks a
    #: paired-output layout for the SAME out conv; the port runs the plain
    #: conv whatever it says.
    outpairs: str = "auto"

    def __post_init__(self):
        unsupported = [
            (self.parity_packed, "parity_packed=True",
             "ROADMAP.md Queue 1 item 8 (config variants)"),
            (self.luma_fold, "luma_fold=True",
             "ROADMAP.md Queue 1 item 8 (config variants)"),
            (self.spatial_tiles > 1, f"spatial_tiles={self.spatial_tiles}",
             "ROADMAP.md Queue 1 item 7 (ops/tiling.py)"),
            (self.fp32_mix != "none", f"fp32_mix={self.fp32_mix!r}",
             "ROADMAP.md Queue 1 item 8 (config variants)"),
            (self.precision not in ("auto", "highest"),
             f"precision={self.precision!r}",
             "ROADMAP.md Queue 1 item 8 (config variants)"),
        ]
        for bad, what, item in unsupported:
            if bad:
                raise NotImplementedError(
                    f"ModelConfig({what}) is not ported yet: {item}")
        if self.dtype not in STORAGE_DTYPES:
            raise ValueError(f"unsupported storage dtype {self.dtype}")

    def with_dtype(self, dtype: torch.dtype) -> "ModelConfig":
        return dataclasses.replace(self, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Settings of the video stylization pipeline
    (``rerevst_tpu.config.InferenceConfig``)."""

    #: Sample every `interval`-th frame (plus the last) for Pass 1.
    sample_interval: int = 8
    #: Sequence-level global feature sharing (two-pass inference).
    use_global: bool = True
    #: Reflect-pad margin and size granularity.
    pad: int = 64
    granularity: int = 64
    #: Frames stylized per device step in the hot loop.
    batch_size: int = 1
    #: Output video fps.
    fps: int = 24
    #: Pass-1 encode chunk (sampled frames encoded this many at a time).
    pass1_chunk: int = 8


#: The discriminator's init schemes (``models.discriminator.INIT_SCHEMES``).
D_INIT_SCHEMES = ("normal", "xavier", "kaiming", "orthogonal")

#: CLI dtype names (``rerevst_tpu.config.DTYPES``).
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def dtype_from_name(name: str) -> torch.dtype:
    """'bf16' | 'f16' | 'f32' -> torch dtype (shared by the CLIs)."""
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss toggles and weights (``rerevst_tpu.config.LossConfig``)."""

    style_content_loss: bool = True
    recon_loss: bool = True
    tv_loss: bool = True
    temporal_loss: bool = True
    relax_style: bool = True
    old_style_loss: bool = False
    #: The PatchGAN adversarial term (``--adaversarial_loss``) and its
    #: objective: 'lsgan' (the reference's), 'vanilla' or 'wgangp'.
    adversarial_loss: bool = False
    gan_mode: str = "lsgan"

    content_weight: float = 1.0
    style_weight: float = 20.0
    recon_weight: float = 20.0
    tv_weight: float = 10.0
    temporal_weight: float = 60.0
    gan_weight: float = 1.0
    old_weight: float = 10.0

    #: Compound Regularization: pixel noise and fake motion.
    data_sigma: bool = True
    data_w: bool = True
    noise_level: float = 0.001
    motion_level: float = 8.0
    shift_level: int = 10

    #: Relaxed style loss: the inner flow optimization.
    flow_scale: int = 8
    flow_iter: int = 16
    flow_max: float = 20.0
    flow_lr: float = 16.0
    flow_momentum: float = 0.9

    #: 'same' or 'bf16': the dtype of the inner loop's VGG passes (the flow,
    #: momentum and loss bookkeeping and the final loss stay fp32).
    relaxed_inner_dtype: str = "same"
    #: Smooth the relaxed flow at 1/N resolution (1 = the reference recipe).
    relaxed_blur_scale: int = 1

    def __post_init__(self):
        if self.gan_mode not in ("lsgan", "vanilla", "wgangp"):
            raise ValueError(f"unknown gan_mode {self.gan_mode!r}")
        if self.relaxed_inner_dtype not in ("same", "bf16"):
            raise ValueError(
                f"relaxed_inner_dtype {self.relaxed_inner_dtype!r}: "
                f"'same' or 'bf16'")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings (``rerevst_tpu.config.TrainConfig``)."""

    batch_size: int = 4
    epochs: int = 2
    lr: float = 1e-4
    log_every: int = 1000
    scalar_every: int = 10
    num_workers: int = 4
    load_size: int = 512
    fine_size: int = 256
    flip: bool = True
    seed: int = 0
    content_data: str = "./data/content/"
    style_data: str = "./data/style/"
    out_dir: str = "result"
    val_dir: str = "val"
    log_dir: str = "log"
    train_only_decoder: bool = False
    #: Figure-16 ablation datasets: MPI Sintel pairs with their backward
    #: flow, or video pairs with their forward flow, in place of the
    #: synthetic motion (``data.datasets.MPIDataset``/``VideoDataset``).
    use_mpi: bool = False
    use_video: bool = False
    #: Discriminator weight init: 'normal' | 'xavier' | 'kaiming' |
    #: 'orthogonal' (``models.discriminator.INIT_SCHEMES``).
    d_init: str = "normal"
    #: Data-parallel training over this many devices (0 or 1 = one card;
    #: more is ROADMAP.md Queue 1 item 7).
    data_parallel: int = 0
    #: Recompute each decode in the backward pass
    #: (``torch.utils.checkpoint``): less activation memory, more FLOPs.
    remat: bool = False
    #: Split each batch into this many micro-batches and average their
    #: gradients (fp32 sums) before the optimizer update.
    grad_accum: int = 1

    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)

    def __post_init__(self):
        if self.data_parallel > 1:
            raise NotImplementedError(
                f"TrainConfig(data_parallel={self.data_parallel}) is not "
                f"ported yet: ROADMAP.md Queue 1 item 7 (torch.distributed)")
        if self.d_init not in D_INIT_SCHEMES:
            raise ValueError(f"unknown d_init {self.d_init!r} "
                             f"(choose from {D_INIT_SCHEMES})")
        if self.model.pairlane:
            # The pair-lane conv kernel has no backward: a trainable tensor
            # through it would lose its gradient without an error.
            raise ValueError(
                "TrainConfig(model=ModelConfig(pairlane=True)): the "
                "pair-lane kernel is forward-only, training cannot run it")
