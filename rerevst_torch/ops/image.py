"""Image tensor transforms (NHWC, RGB) — ``rerevst_tpu/ops/image.py``.

ImageNet normalization, the reversed-channel desaturation quirk, and the
reflect-pad / x64 geometry of the reference's ReshapeTool.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: ImageNet statistics in RGB channel order.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _stat(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB NHWC -> ImageNet-normalized (integers cast to fp32 first)."""
    if not img.is_floating_point():
        img = img.to(torch.float32)
    return (img - _stat(IMAGENET_MEAN, img)) / _stat(IMAGENET_STD, img)


def denormalize(img: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized NHWC -> [0,1] RGB (no clamp)."""
    return img * _stat(IMAGENET_STD, img) + _stat(IMAGENET_MEAN, img)


def rgb_to_luma_reversed(img: torch.Tensor) -> torch.Tensor:
    """Desaturate a normalized image with the BT.601 weights in REVERSED
    channel order (0.299 on blue, 0.114 on red) — the quirk the released
    model was trained with.  The gray value is broadcast to all three
    channels and re-normalized."""
    rgb = denormalize(img)
    gray = (rgb[..., 2:3] * 0.299 + rgb[..., 1:2] * 0.587
            + rgb[..., 0:1] * 0.114)
    return normalize(gray.expand(rgb.shape))


def padded_size(h: int, w: int, pad: int = 64,
                granularity: int = 64) -> Tuple[int, int]:
    """(H, W) after reflect-padding: +2*pad, rounded up to `granularity`."""
    new_h = h + 2 * pad
    if new_h % granularity != 0:
        new_h += granularity - new_h % granularity
    new_w = w + 2 * pad
    if new_w % granularity != 0:
        new_w += granularity - new_w % granularity
    return new_h, new_w


def validate_pad_geometry(h: int, w: int, pad: int = 64,
                          granularity: int = 64) -> None:
    """Reject geometries whose symmetric reflect pad exceeds a frame side."""
    th, tw = padded_size(h, w, pad, granularity)
    worst_h = max(pad, th - pad - h)
    worst_w = max(pad, tw - pad - w)
    if worst_h > h or worst_w > w:
        raise ValueError(
            f"content {h}x{w} is too small for pad={pad}/granularity="
            f"{granularity}: reflect padding needs every side pad <= the "
            f"frame dimension (this geometry pads {h}x{w} -> {th}x{tw}, "
            f"worst side pads {worst_h}/{worst_w}).  Use a smaller pad/"
            f"granularity or content of at least {worst_h}x{worst_w} pixels.")


def pad_reflect_multiple(img: np.ndarray, pad: int = 64, granularity: int = 64,
                         target_hw: Optional[Tuple[int, int]] = None
                         ) -> np.ndarray:
    """Reflect-pad NHWC to the padded size, edge pixel included
    (cv2.BORDER_REFLECT == numpy mode='symmetric').  numpy in, numpy out:
    host-side batch prep never bounces through the device."""
    n, h, w, c = img.shape
    if target_hw is None:
        target_hw = padded_size(h, w, pad, granularity)
    th, tw = target_hw
    return np.pad(img, ((0, 0), (pad, th - pad - h), (pad, tw - pad - w),
                        (0, 0)), mode="symmetric")


def crop_back(img, orig_h: int, orig_w: int, pad: int = 64):
    """Undo pad_reflect_multiple."""
    return img[:, pad:pad + orig_h, pad:pad + orig_w, :]


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Normalized NHWC -> uint8 RGB, clamped and rounded (cv2's cvRound)."""
    x = torch.clamp(denormalize(img), 0.0, 1.0) * 255.0
    return torch.round(x).to(torch.uint8)
