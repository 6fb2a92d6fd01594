"""Backward warping by grid sampling (NHWC) — ``rerevst_tpu/ops/warp.py``.

``grid_sample`` is torch ``F.grid_sample`` with border padding, bilinear or
nearest, ``align_corners=False`` — the only settings the reference uses —
written as the JAX package writes it (clip the sampling coordinate into the
image, then gather), so that both packages compute the same op sequence and
the same gradients.  ``flow_warp`` is the reference's flow warp on top of it:

* bilinear, in the relaxed style loss (``train/style_networks.py:27-44``);
* nearest, in the Compound Regularization temporal loss
  (``train/loss_networks.py:20-38``).

``flow_warp_const_src`` is the bilinear warp with the image held constant
and the analytic flow-only backward of the JAX package's ``custom_vjp``
(a ``torch.autograd.Function`` here): no gather in the backward pass.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """Normalized coordinates [-1, 1] -> pixel positions, torch semantics."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather_2d(x: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
    """out[n, p, q, c] = x[n, iy[n,p,q], ix[n,p,q], c] (indices in range)."""
    n, h, w, c = x.shape
    idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    out = torch.gather(x.reshape(n, h * w, c), 1, idx)
    return out.reshape(n, iy.shape[1], iy.shape[2], c)


def _corners(x: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """The four bilinear corners of clipped coordinates (gx, gy) and the
    fractional weights [N,H,W,1]."""
    h, w = x.shape[1], x.shape[2]
    ix0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, w - 1)
    iy0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, h - 1)
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    fx = (gx - ix0.to(gx.dtype))[..., None]
    fy = (gy - iy0.to(gy.dtype))[..., None]
    return (_gather_2d(x, iy0, ix0), _gather_2d(x, iy0, ix1),
            _gather_2d(x, iy1, ix0), _gather_2d(x, iy1, ix1), fx, fy)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "border",
                align_corners: bool = False) -> torch.Tensor:
    """Sample NHWC `x` at normalized locations `grid` [N, Ho, Wo, 2] (x, y)."""
    if padding_mode != "border":
        raise NotImplementedError("only border padding is supported")
    n, h, w, c = x.shape
    gx = _unnormalize(grid[..., 0].to(torch.float32), w, align_corners)
    gy = _unnormalize(grid[..., 1].to(torch.float32), h, align_corners)
    # Border padding clips the sampling coordinate into the image.
    gx = torch.clamp(gx, 0.0, w - 1)
    gy = torch.clamp(gy, 0.0, h - 1)
    if mode == "nearest":
        # Round half to even (torch's nearbyint; jnp.round).
        return _gather_2d(x, torch.round(gy).to(torch.int64),
                          torch.round(gx).to(torch.int64))
    if mode != "bilinear":
        raise NotImplementedError(f"mode {mode!r}")
    v00, v01, v10, v11, fx, fy = _corners(x, gx, gy)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return (top * (1.0 - fy) + bot * fy).to(x.dtype)


def _flow_grid(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's sampling grid: position - flow, normalized by
    2/max(dim-1, 1) - 1 (with align_corners=False this leaves a slight
    edge-dependent offset, which is the reference's behaviour)."""
    f32 = dict(dtype=torch.float32, device=flow.device)
    xs = torch.arange(w, **f32)[None, None, :]
    ys = torch.arange(h, **f32)[None, :, None]
    gx = 2.0 * (xs - flow[..., 0].to(torch.float32)) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys - flow[..., 1].to(torch.float32)) / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              mode: str = "bilinear") -> torch.Tensor:
    """Backward-warp NHWC `x` by a pixel-space `flow` [N, H, W, 2] (dx, dy):
    the reference warp, grid-sampled with border padding."""
    n, h, w, _ = x.shape
    return grid_sample(x, _flow_grid(flow, h, w), mode=mode,
                       padding_mode="border", align_corners=False)


class _FlowWarpConstSrc(torch.autograd.Function):
    """The bilinear flow warp with an analytic backward w.r.t. the flow only.

    With out = (v00(1-fx) + v01 fx)(1-fy) + (v10(1-fx) + v11 fx) fy,

        d out/d gx = ((v01-v00)(1-fy) + (v11-v10) fy) [0 < gx' < w-1]
        d out/d gy = (bot - top)                      [0 < gy' < h-1]
        d gx/d flow_x = -w / max(w-1, 1)

    where gx' is the coordinate before the border clip: torch's
    border-padding convention, a strict zero at exactly clipped
    coordinates."""

    @staticmethod
    def forward(ctx, x, flow):
        n, h, w, c = x.shape
        grid = _flow_grid(flow, h, w)
        gx = _unnormalize(grid[..., 0], w, False)
        gy = _unnormalize(grid[..., 1], h, False)
        inx = ((gx > 0.0) & (gx < w - 1)).to(torch.float32)
        iny = ((gy > 0.0) & (gy < h - 1)).to(torch.float32)
        v00, v01, v10, v11, fx, fy = _corners(
            x, torch.clamp(gx, 0.0, w - 1), torch.clamp(gy, 0.0, h - 1))
        top = v00 * (1.0 - fx) + v01 * fx
        bot = v10 * (1.0 - fx) + v11 * fx
        out = (top * (1.0 - fy) + bot * fy).to(x.dtype)
        dgx = (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy
        ctx.save_for_backward(dgx, bot - top, inx, iny)
        ctx.flow_dtype = flow.dtype
        return out

    @staticmethod
    def backward(ctx, cot):
        dgx, dgy, inx, iny = ctx.saved_tensors
        h, w = dgx.shape[1], dgx.shape[2]
        cot = cot.to(dgx.dtype)
        gfx = (cot * dgx).sum(-1) * inx * (-float(w) / max(w - 1, 1))
        gfy = (cot * dgy).sum(-1) * iny * (-float(h) / max(h - 1, 1))
        return None, torch.stack([gfx, gfy], dim=-1).to(ctx.flow_dtype)


def flow_warp_const_src(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``flow_warp(x, flow, 'bilinear')`` with `x` a constant (no gradient)
    and the analytic flow gradient of ``_FlowWarpConstSrc``; the forward is
    the same op sequence as ``flow_warp``."""
    return _FlowWarpConstSrc.apply(x, flow)
