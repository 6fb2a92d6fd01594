"""Moment/extremum reductions of the normalization layers —
``rerevst_tpu/ops/stats.py``.

Two distinct statistics, never to be conflated:

* ``instance_moments`` — biased variance, eps inside the rsqrt (InstanceNorm);
* ``mean_std`` — UNBIASED variance, eps added before the sqrt (style stats).

Reductions run in fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def instance_moments(x: torch.Tensor, axes: Sequence[int],
                     eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) over `axes`, keepdims; rstd = rsqrt(E[(x-mean)^2] + eps),
    the two-pass biased second moment."""
    axes = tuple(axes)
    xf = x.to(torch.float32)
    mean = xf.mean(axes, keepdim=True)
    var = torch.square(xf - mean).mean(axes, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, axes: Sequence[int] = (1, 2),
                  eps: float = 1e-8) -> torch.Tensor:
    """Stateless instance norm, (x - mean) * rsqrt(var + eps): with
    axes=(1, 2) on NHWC, per (sample, channel) over H, W.  Moments and the
    normalize in fp32, the result in x's dtype."""
    mean, rstd = instance_moments(x, axes, eps)
    return ((x.to(torch.float32) - mean) * rstd).to(x.dtype)


def mean_std(feat: torch.Tensor,
             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) mean/std over H,W of NHWC with torch-var
    semantics (unbiased, eps on the variance); two [N,1,1,C] tensors in the
    input's dtype."""
    n, h, w, c = feat.shape
    xf = feat.to(torch.float32)
    m = xf.mean((1, 2), keepdim=True)
    denom = max(h * w - 1, 1)
    var = torch.square(xf - m).sum((1, 2), keepdim=True) / denom
    std = torch.sqrt(var + eps)
    return m.to(feat.dtype), std.to(feat.dtype)


def channel_minmax(x: torch.Tensor, axes: Sequence[int] = (0, 1, 2)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (min, max) over `axes` of NHWC, keepdims."""
    return torch.amin(x, tuple(axes), keepdim=True), \
        torch.amax(x, tuple(axes), keepdim=True)
