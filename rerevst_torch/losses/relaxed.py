"""The Relaxed Style Loss — an optimization inside the loss —
``rerevst_tpu/losses/relaxed.py``.

The style target may warp under a smooth flow: ``flow_iter`` steps of SGD
with momentum (torch's: ``buf = m buf + g``, ``flow -= lr buf``) minimize
the style loss w.r.t. a coarse flow against a frozen copy of the stylized
features, the best iterate is kept, and the final, differentiable style loss
is taken against the best-warped style.

Each inner step takes its gradient with ``torch.autograd.grad`` w.r.t. the
flow alone: the VGG parameters, the style image and the target are
detached, so each iteration's graph is freed and nothing reaches the model
parameters.  The best iterate, its loss and its index stay on the device
(``torch.where``), so the loop never waits for the card.  Gradients reach
the model only through the final loss's stylized features.  The loop runs
under the profiler range ``INNER_LOOP_RANGE``, so a trace can tell its share
of a train step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rerevst_torch.config import LossConfig, ModelConfig
from rerevst_torch.losses.perceptual import style_loss
from rerevst_torch.models.vgg import VggFeatures, vgg_features
from rerevst_torch.ops.blur import gaussian_blur
from rerevst_torch.ops.resize import resize_bilinear
from rerevst_torch.ops.warp import flow_warp

#: The profiler range around the inner optimization.
INNER_LOOP_RANGE = "relaxed_style_loss.inner_loop"


def smooth_flow(flow: torch.Tensor, h: int, w: int, flow_max: float = 20.0,
                blur_scale: int = 1) -> torch.Tensor:
    """Coarse flow -> a bounded smooth full-resolution flow: bilinear
    upsample, tanh x flow_max, Gaussian blur 101x101 sigma 50.5.

    ``blur_scale`` > 1 (``LossConfig.relaxed_blur_scale``) runs tanh and a
    1/N-scaled blur at 1/N resolution and upsamples the smoothed field:
    about N^3 less blur work, an approximation."""
    if blur_scale > 1:
        ch, cw = h // blur_scale, w // blur_scale
        f = flow if tuple(flow.shape[1:3]) == (ch, cw) \
            else resize_bilinear(flow, ch, cw)
        f = torch.tanh(f) * flow_max
        k = max(3, (101 // blur_scale) | 1)  # odd, >= 3
        f = gaussian_blur(f, ksize=k, sigma=50.5 / blur_scale)
        return resize_bilinear(f, h, w)
    f = torch.tanh(resize_bilinear(flow, h, w)) * flow_max
    return gaussian_blur(f, ksize=101, sigma=50.5)


def _detached(tree, dtype=None):
    """A parameter dict or VggFeatures, detached (and cast to `dtype`)."""
    if isinstance(tree, dict):
        return {k: _detached(v, dtype) for k, v in tree.items()}
    if isinstance(tree, VggFeatures):
        return VggFeatures(*(_detached(v, dtype) for v in tree))
    t = tree.detach()
    return t if dtype is None else t.to(dtype)


def relaxed_style_loss(vgg_params: Dict, style_img: torch.Tensor,
                       f_styled: VggFeatures, cfg: LossConfig,
                       model_cfg: ModelConfig,
                       record: Optional[Dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(relaxed style loss, original style loss, robust style image).

    `f_styled` carries the gradients w.r.t. the model parameters;
    `style_img` is the normalized style batch [B,H,W,3].  A `record` dict
    receives the inner losses (``inner_losses``, one device scalar per
    iteration) and the best iterate's index (``best_iter``, -1 when no
    iterate beat the original loss)."""
    b, h, w, _ = style_img.shape
    eps = model_cfg.mean_std_eps
    dev = style_img.device

    vgg_sg = _detached(vgg_params)
    style_sg = style_img.detach()
    ori = style_loss(f_styled, vgg_features(vgg_sg, style_sg, "relu4_1"), eps)

    # The inner loop's VGG passes in bf16 ('bf16'), or in the model dtype;
    # the flow, momentum and loss bookkeeping stay fp32.
    inner_dt = torch.bfloat16 if (cfg.relaxed_inner_dtype == "bf16"
                                  and model_cfg.dtype != torch.bfloat16) \
        else None
    vgg_inner = _detached(vgg_params, inner_dt)
    style_inner = style_sg if inner_dt is None else style_sg.to(inner_dt)
    target_inner = _detached(f_styled, inner_dt)

    flow = torch.zeros((b, h // cfg.flow_scale, w // cfg.flow_scale, 2),
                       dtype=torch.float32, device=dev)
    mom = torch.zeros_like(flow)
    best_flow = torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev)
    best_loss = ori.detach().to(torch.float32)
    best_iter = torch.full((), -1, dtype=torch.int32, device=dev)
    with torch.profiler.record_function(INNER_LOOP_RANGE):
        for i in range(cfg.flow_iter):
            with torch.enable_grad():
                leaf = flow.requires_grad_(True)
                bounded = smooth_flow(leaf, h, w, cfg.flow_max,
                                      cfg.relaxed_blur_scale)
                warped = flow_warp(style_inner, bounded.to(style_inner.dtype),
                                   mode="bilinear")
                feats = vgg_features(vgg_inner, warped, "relu4_1")
                loss = style_loss(target_inner, feats, eps).to(torch.float32)
                (g,) = torch.autograd.grad(loss, leaf)
            with torch.no_grad():
                mom = cfg.flow_momentum * mom + g
                flow = leaf.detach() - cfg.flow_lr * mom
                loss, bounded = loss.detach(), bounded.detach()
                if record is not None:
                    record.setdefault("inner_losses", []).append(loss)
                better = loss < best_loss
                best_flow = torch.where(better, bounded, best_flow)
                best_loss = torch.where(better, loss, best_loss)
                best_iter = torch.where(better, best_iter.new_full((), i),
                                        best_iter)

    if record is not None:
        record["best_iter"] = best_iter
    improved = best_iter >= 0
    robust_style = flow_warp(style_sg, best_flow, mode="bilinear")
    robust_feats = vgg_features(vgg_sg, robust_style, "relu4_1")
    relaxed = style_loss(f_styled, robust_feats, eps)
    final = torch.where(improved, relaxed, ori)
    robust_out = torch.where(improved, robust_style, style_sg)
    return final, ori, robust_out
