"""Typed configuration of the model and of the video pipeline.

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


#: CLI dtype names (``rerevst_tpu.config.DTYPES``).
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def dtype_from_name(name: str) -> torch.dtype:
    """'bf16' | 'f16' | 'f32' -> torch dtype (shared by the CLIs)."""
    return DTYPES[name]
