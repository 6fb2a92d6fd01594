"""Resizing ops (NHWC) — ``rerevst_tpu/ops/resize.py``."""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsample (exact repeat), contiguous."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c) \
        .reshape(n, 2 * h, 2 * w, c)
