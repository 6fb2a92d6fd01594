"""Perceptual losses: style (mean/std matching), content, total variation —
``rerevst_tpu/losses/perceptual.py``.

The reference's ``calc_mean_std`` returns the *std* (sqrt of the unbiased
variance + eps) despite its local name ``var_x``: the style loss matches
means and stds.
"""

from __future__ import annotations

import torch

from rerevst_torch.models.vgg import VggFeatures
from rerevst_torch.ops.stats import mean_std


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def style_loss(feats_x: VggFeatures, feats_style: VggFeatures,
               eps: float = 1e-5) -> torch.Tensor:
    """Sum over the relu taps of MSE(mean) + MSE(std)."""
    total = 0.0
    for fx, fs in zip(feats_x, feats_style):
        mx, sx = mean_std(fx, eps)
        ms, ss = mean_std(fs, eps)
        total = total + _mse(mx, ms) + _mse(sx, ss)
    return total


def content_loss(feats_x: VggFeatures,
                 feats_content: VggFeatures) -> torch.Tensor:
    """MSE on relu4_1."""
    return _mse(feats_x.relu4_1, feats_content.relu4_1)


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV, mean-abs form, NHWC."""
    h_tv = torch.mean(torch.abs(x[:, 1:, :, :] - x[:, :-1, :, :]))
    w_tv = torch.mean(torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :]))
    return h_tv + w_tv
