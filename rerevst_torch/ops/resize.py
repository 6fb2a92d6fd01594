"""Resizing ops (NHWC) — ``rerevst_tpu/ops/resize.py``.

* ``upsample_nearest_2x`` — the decoder's upsampling: an exact 2x repeat.
* ``resize_bilinear`` — half-pixel bilinear without antialiasing, the
  formula of torch ``F.interpolate(mode='bilinear', align_corners=False)``
  and ``cv2.resize(INTER_LINEAR)``, with the source index clipped into the
  image; it upsamples the relaxed style loss's coarse flow and the fake
  flow's coarse noise.  Two separable gathers, as in the JAX package.
"""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsample (exact repeat), contiguous."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c) \
        .reshape(n, 2 * h, 2 * w, c)


def _linear_weights(out_size: int, in_size: int, device):
    """Source indices and weights of 1-D half-pixel linear interpolation."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device)
           + 0.5) * scale - 0.5
    src = torch.clamp(src, 0.0, in_size - 1)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    return i0, i1, src - i0


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NHWC to (out_h, out_w) as torch bilinear, align_corners=False,
    computed in fp32 and returned in x's dtype."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    xf = x.to(torch.float32)
    i0, i1, fy = _linear_weights(out_h, h, x.device)
    rows0 = xf.index_select(1, i0)
    rows1 = xf.index_select(1, i1)
    xf = rows0 + (rows1 - rows0) * fy[None, :, None, None]
    j0, j1, fx = _linear_weights(out_w, w, x.device)
    cols0 = xf.index_select(2, j0)
    cols1 = xf.index_select(2, j1)
    out = cols0 + (cols1 - cols0) * fx[None, None, :, None]
    return out.to(x.dtype)
