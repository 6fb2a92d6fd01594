"""Plain PyTorch reference of one ReReVST training step (the G update).

Provenance: written for this benchmark after the published training code
(daooshee/ReReVST-Code ``train/train.py`` G update, ``train/style_networks.py``
relaxed style loss, ``train/loss_networks.py`` Compound Regularization) and
the arithmetic of the port's plain training path as it stood when the
benchmark was added (``rerevst_torch/train/step.py:compute_losses``,
``losses/{perceptual,temporal,relaxed}.py``, ``ops/{warp,blur,resize}.py``).
It imports nothing of the program.  Exact fp32 (TF32 off) throughout.

The random draws of the synthetic motion are taken from a
``torch.Generator`` in the program's order (coarse noise, shift, noise
level, pixel noise), so a generator in the same state gives the same
draws.  Departures from the port, exact in real arithmetic: warps are
``F.grid_sample`` (border, align_corners=False), resizes ``F.interpolate``
(bilinear, align_corners=False), blurs a reflect pad and a banded product,
and the decoder upsamples before its convs (``model.py``).

The losses and weights are the recipe's defaults: content 1, relaxed style
20 (16 inner steps of SGD with momentum on a 1/8-scale flow), recon 20,
temporal 60 on fake motion, TV 10; Adam(1e-4, 0.9, 0.999, 1e-8) over the
encoder, the style encoder and the decoder, the loss VGG frozen.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import (
    decode,
    desaturate,
    encode_style,
    exact,
    vgg,
)

W_CONTENT, W_STYLE, W_RECON, W_TEMPORAL, W_TV = 1.0, 20.0, 20.0, 60.0, 10.0
FLOW_SCALE, FLOW_ITER, FLOW_MAX, FLOW_LR, FLOW_MOMENTUM = 8, 16, 20.0, 16.0, 0.9
NOISE_LEVEL, MOTION_LEVEL, SHIFT_LEVEL = 0.001, 8.0, 10
TRAINED = ("encoder", "encoder_style", "decoder")


def leaves(params: Dict, keys=TRAINED) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of the trained subtrees, depth first in key order (the
    order the program's optimizer holds them in)."""
    out = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.append(("/".join(path + (k,)), v))

    for k in params:
        if k in keys:
            walk(params[k], (k,))
    return out


def _mse(a, b):
    return torch.mean(torch.square(a - b))


def _mean_std(x):
    n, h, w, _ = x.shape
    m = x.mean((1, 2), keepdim=True)
    v = torch.square(x - m).sum((1, 2), keepdim=True) / max(h * w - 1, 1)
    return m, torch.sqrt(v + 1e-5)


def style_loss(fx, fs):
    total = 0.0
    for a, b in zip(fx, fs):
        ma, sa = _mean_std(a)
        mb, sb = _mean_std(b)
        total = total + _mse(ma, mb) + _mse(sa, sb)
    return total


def tv_loss(x):
    return (torch.mean(torch.abs(x[:, 1:] - x[:, :-1]))
            + torch.mean(torch.abs(x[:, :, 1:] - x[:, :, :-1])))


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC bilinear, half-pixel centres, no antialiasing."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                         mode="bilinear", align_corners=False) \
        .permute(0, 2, 3, 1)


def warp(x: torch.Tensor, flow: torch.Tensor, mode: str) -> torch.Tensor:
    """Backward warp by a pixel flow (dx, dy), as the published code's
    ``grid_sample`` call computes it: grid = 2 (position - flow) / (size -
    1) - 1, sampled with align_corners=False (pixel = ((grid + 1) size -
    1) / 2) and border padding (the pixel clipped into the image); nearest
    rounds half to even.  Gathers, not ``F.grid_sample``: its fp32
    gradient with respect to the grid read 3e-3 off float64 on the CPU,
    where this form reads 1e-7."""
    n, h, w, c = x.shape
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    px = (((2.0 * (xs - flow[..., 0]) / max(w - 1, 1) - 1.0) + 1.0) * w
          - 1.0) / 2.0
    py = (((2.0 * (ys - flow[..., 1]) / max(h - 1, 1) - 1.0) + 1.0) * h
          - 1.0) / 2.0
    px = px.expand(n, h, w).clamp(0.0, w - 1)
    py = py.expand(n, h, w).clamp(0.0, h - 1)
    flat = x.reshape(n, h * w, c)

    def at(iy, ix):
        idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    if mode == "nearest":
        return at(torch.round(py).long(), torch.round(px).long())
    x0 = px.floor().long().clamp(0, w - 1)
    y0 = py.floor().long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bottom = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bottom * fy


def _band(n: int, taps: np.ndarray, lo: int, hi: int, device) -> torch.Tensor:
    """[n + lo + hi, n]: the 1-D correlation with `taps` as a product
    (column j of the output reads rows j .. j + k - 1 of the padded
    input)."""
    k = len(taps)
    m = np.zeros((n + lo + hi, n), np.float64)
    for j in range(n):
        m[j:j + k, j] = taps
    return torch.as_tensor(m.astype(np.float32), device=device)


def _blur(x: torch.Tensor, taps: np.ndarray, lo: int, hi: int):
    """Separable blur of NHWC `x`, REFLECT_101 borders (``F.pad``'s
    'reflect'), each pass one product with a banded matrix."""
    n, h, w, c = x.shape
    y = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi), mode="reflect")
    y = y.transpose(-1, -2) @ _band(h, taps, lo, hi, x.device)  # over H
    y = y.transpose(-1, -2) @ _band(w, taps, lo, hi, x.device)  # over W
    return y.permute(0, 2, 3, 1)


def gaussian_blur(x, ksize=101, sigma=50.5):
    t = np.arange(ksize, dtype=np.float64) - ksize // 2
    taps = np.exp(-t * t / (2 * sigma * sigma))
    return _blur(x, taps / taps.sum(), ksize // 2, ksize - 1 - ksize // 2)


def box_blur(x, ksize=100):
    return _blur(x, np.full(ksize, 1.0 / ksize), ksize // 2,
                 ksize - 1 - ksize // 2)


def fake_data(gen: torch.Generator, first: torch.Tensor):
    """The second frame and the fake flow of Compound Regularization, the
    draws in the program's order."""
    b, h, w, _ = first.shape
    dev = gen.device
    coarse = torch.randn((1, max(h // 100, 1), max(w // 100, 1), 2),
                         generator=gen, device=dev) * MOTION_LEVEL
    shift = torch.randint(-SHIFT_LEVEL, SHIFT_LEVEL + 1, (2,), generator=gen,
                          device=dev)
    flow = box_blur(resize(coarse, h, w) + shift.to(torch.float32))[0]
    flow = flow[None].expand(b, h, w, 2)
    second = warp(first, flow, "nearest")
    std = NOISE_LEVEL * (1.0 + torch.rand((), generator=gen, device=dev))
    second = second + torch.randn(second.shape, generator=gen, device=dev,
                                  dtype=second.dtype) * std
    return second, flow


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    return tree.detach()


def relaxed_style_loss(vgg_params, style, f_styled,
                       inner: Optional[List[float]] = None):
    """(relaxed loss, original loss): the style target warped by the best
    of 16 momentum-SGD iterates of a smooth flow.  `inner`, a list, gets
    each iteration's loss."""
    b, h, w, _ = style.shape
    vp = _detach(vgg_params)
    style = style.detach()
    ori = style_loss(f_styled, vgg(vp, style))
    target = _detach(f_styled)
    flow = torch.zeros((b, h // FLOW_SCALE, w // FLOW_SCALE, 2),
                       device=style.device)
    mom = torch.zeros_like(flow)
    best_flow = torch.zeros((b, h, w, 2), device=style.device)
    best_loss = ori.detach()
    improved = torch.zeros((), dtype=torch.bool, device=style.device)
    for _ in range(FLOW_ITER):
        with torch.enable_grad():
            leaf = flow.requires_grad_(True)
            bounded = gaussian_blur(torch.tanh(resize(leaf, h, w))
                                    * FLOW_MAX)
            loss = style_loss(target, vgg(vp, warp(style, bounded,
                                                   "bilinear")))
            (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            mom = FLOW_MOMENTUM * mom + g
            flow = leaf.detach() - FLOW_LR * mom
            if inner is not None:
                inner.append(float(loss.detach()))
            better = loss.detach() < best_loss
            best_flow = torch.where(better, bounded.detach(), best_flow)
            best_loss = torch.where(better, loss.detach(), best_loss)
            improved = improved | better
    relaxed = style_loss(f_styled, vgg(vp, warp(style, best_flow,
                                                 "bilinear")))
    return torch.where(improved, relaxed, ori), ori


def losses(params: Dict, content: torch.Tensor, style: torch.Tensor,
           gen: torch.Generator, robust: Optional[torch.Tensor] = None,
           inner: Optional[List[float]] = None
           ) -> Tuple[torch.Tensor, Dict]:
    """(total, the terms) of one step's batch.  With `robust` (the style
    batch as the program's relaxed loop warped it, or left it), the
    relaxed term is the style loss against it, and the reference's own
    loop runs beside it only to be read (``own_relaxed``, and each of its
    iterations' losses into `inner`)."""
    enc, dec, lossnet = params["encoder"], params["decoder"], \
        params["vgg_loss"]
    f_content = vgg(enc, content)[-1]
    sf = encode_style(params, style)
    styled = decode(dec, f_content, sf)
    f_styled = vgg(lossnet, styled)
    c_loss = _mse(f_styled[-1], vgg(lossnet, desaturate(content))[-1])
    own, ori = relaxed_style_loss(lossnet, style, f_styled, inner)
    s_loss = own if robust is None else style_loss(
        f_styled, vgg(_detach(lossnet), robust.detach()))
    recon_content = decode(dec, f_content, encode_style(params, content))
    recon_style = decode(dec, vgg(enc, desaturate(style))[-1], sf)
    r_loss = (torch.mean(torch.abs(recon_content - content))
              + torch.mean(torch.abs(recon_style - style)))
    second, flow = fake_data(gen, content)
    styled_second = decode(dec, vgg(enc, second.detach())[-1], sf)
    t_loss = torch.mean(torch.abs(warp(styled, flow, "nearest")
                                  - styled_second))
    tv = tv_loss(styled)
    total = (c_loss * W_CONTENT + s_loss * W_STYLE + r_loss * W_RECON
             + t_loss * W_TEMPORAL + tv * W_TV)
    return total, {"content": c_loss, "new_style": s_loss,
                   "old_style": ori, "recon": r_loss, "temporal": t_loss,
                   "tv": tv, "own_relaxed": own}


class Trainer:
    """Its own fp32 copy of the parameters and Adam over the trained
    leaves."""

    def __init__(self, params: Dict, lr: float = 1e-4):
        self.params = _copy(params)
        self.trained = leaves(self.params)
        for k, v in leaves(self.params, tuple(self.params)):
            v.requires_grad_(any(v is t for _, t in self.trained))
        self.opt = torch.optim.Adam([t for _, t in self.trained], lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)

    def step(self, content, style, gen, robust=None, inner=None
             ) -> Tuple[Dict, Dict]:
        """One update; ({term: loss, 'total': loss}, {path: gradient}).
        `inner`, a list, gets the relaxed loop's iteration losses."""
        with exact():
            total, terms = losses(self.params, content, style, gen, robust,
                                  inner)
            grads = torch.autograd.grad(
                total, [t for _, t in self.trained], allow_unused=True,
                materialize_grads=True)
        for (_, t), g in zip(self.trained, grads):
            t.grad = g
        self.opt.step()
        terms = {k: float(v.detach()) for k, v in terms.items()}
        terms["total"] = float(total.detach())
        return terms, {p: g.detach() for (p, _), g in
                       zip(self.trained, grads)}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone().to(torch.float32)
