"""GAN objectives — ``rerevst_tpu/losses/gan.py`` (the reference's
``GANLoss``, ``train/other_networks.py:75-134``)."""

from __future__ import annotations

import torch


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """'lsgan': mean squared error to 1 (real) or 0 (fake); 'vanilla':
    BCE with logits, mean reduction, in the stable form max(p, 0) - p t +
    log1p(exp(-|p|)); 'wgangp': -mean (real) or mean (fake), with no
    gradient penalty, as in the JAX package."""
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean(torch.square(prediction - target))
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        p = prediction
        return torch.mean(torch.clamp_min(p, 0) - p * target
                          + torch.log1p(torch.exp(-torch.abs(p))))
    if mode == "wgangp":
        m = torch.mean(prediction)
        return -m if target_is_real else m
    raise NotImplementedError(f"gan mode {mode!r}")
