"""Exact overlap-and-discard spatial tiling of H-local regions —
``rerevst_tpu/ops/tiling.py``.

The sequence-global Pass-2 graph has no cross-spatial reduction (every norm
uses frozen per-sequence statistics), so any contiguous region of it —
convs with SAME zero padding, pools, nearest-2x upsamples, elementwise
ops — is H-local: its output rows depend only on input rows within the
region's receptive field.  Evaluating the region on overlapping H-slabs and
keeping each slab's interior therefore gives the untiled result (up to the
order of the convolutions' sums, which a library may choose by shape).

Why: the full-resolution stages hold the largest activations.  At true
1080p (2048x1216 padded) the encoder's conv1 block and the decoder's
res2 + out tail each hold [B,1216,2048,64] maps; tiling those regions T ways
bounds their working set at about 1/T while the rest of the network (at
half resolution or less) runs untiled.

Edge slabs are shifted inward to the uniform slab size, so the first and
last slab's outer edge is the true image edge, where the convs' own zero
padding is the right boundary.  At an interior slab edge the padding is
wrong, but its error reaches at most the region's receptive field into the
slab, and the kept interior sits at least ``halo`` rows away.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def can_tile_h(h: int, n_tiles: int, halo: int, scale: Tuple[int, int],
               align: int = 1) -> bool:
    """Whether ``tiled_over_h`` applies: H divides into `n_tiles` aligned
    tiles tall enough to shift the edge slabs inward (``th >= 2 halo`` keeps
    every kept region at least ``halo`` rows from an interior slab edge, the
    shifted edge tiles included)."""
    if n_tiles <= 1 or h % n_tiles:
        return False
    th = h // n_tiles
    num, den = scale
    return (th >= 2 * halo and th % align == 0 and halo % align == 0
            and (th * num) % den == 0 and (halo * num) % den == 0)


def tiled_over_h(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 n_tiles: int, halo: int,
                 scale: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Evaluate the H-local region `fn` over `n_tiles` overlapping H-slabs
    of the NHWC tensor `x`.

    `fn`: [B, hs, W, C] -> [B, hs num/den, W', C'] — any H-local map whose
    output rows scale H by ``scale = (num, den)`` ((2, 1) for the decoder's
    2x-upsampling tail, (1, 2) for the encoder's pooling head) and whose
    receptive field along H is at most `halo` input rows.

    Slab t covers the input rows [clip(t th - halo, 0, H - slab), + slab)
    with slab = th + 2 halo; the kept output rows are the slab-relative
    [(t th - start) num/den, + th num/den).  A Python loop runs the slabs one
    after another and writes each kept part into one output tensor, so the
    caching allocator frees a slab's temporaries before the next slab runs.
    Each slab is made contiguous (a row slab of an NHWC batch is not), as
    the kernels take contiguous tensors.  Requires ``can_tile_h``.
    """
    if n_tiles <= 1:
        return fn(x)
    b, h = x.shape[:2]
    num, den = scale
    if not can_tile_h(h, n_tiles, halo, scale):
        raise ValueError(f"cannot tile H={h} into {n_tiles} slabs with halo "
                         f"{halo} at scale {scale}")
    th = h // n_tiles
    slab = th + 2 * halo
    out_th = th * num // den
    out = None
    for t in range(n_tiles):
        start = min(max(t * th - halo, 0), h - slab)
        yt = fn(x[:, start:start + slab].contiguous())
        if out is None:
            out = yt.new_empty((b, h * num // den) + tuple(yt.shape[2:]))
        off = (t * th - start) * num // den
        out[:, t * out_th:(t + 1) * out_th] = yt[:, off:off + out_th]
        del yt
    return out
