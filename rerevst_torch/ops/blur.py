"""Separable blurs (NHWC, depthwise) — ``rerevst_tpu/ops/blur.py``.

* ``gaussian_blur`` — kornia ``GaussianBlur2d((101,101),(50.5,50.5))``, which
  smooths the relaxed style loss's flow: the 1-D kernel is
  exp(-(x - ksize//2)^2 / (2 sigma^2)) normalized to sum 1, border
  REFLECT_101.
* ``box_blur`` — ``cv2.blur(ksize)``, which smooths the fake flow: OpenCV
  anchors an even kernel at ksize//2, so the padding is asymmetric
  (left k//2, right k-1-k//2), border REFLECT_101.

Both are two 1-D passes.  Each pass is one matrix product with a banded
[n, n] matrix that holds the taps with the border folded in: numpy's
``mode='reflect'`` padding, which reflects again where a pad reaches past
the far edge (the 101-tap blur pads 50 on each side, so any side under 51
pixels needs it: a test crop, or the flow at 1/N resolution under
``relaxed_blur_scale``).  A product is deterministic, cheap at these sizes
and so is its gradient; cuDNN takes a 101-tap depthwise fp32 convolution
to its FFT path, where one train step spent seconds.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from rerevst_torch.ops.precision import exact_products


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def reflect_index(j: np.ndarray, n: int) -> np.ndarray:
    """The source index of position `j` (any integer) under numpy's
    ``mode='reflect'`` padding of a side of `n`: the periodic even
    extension about the edge pixels, period 2 (n - 1)."""
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = np.mod(j, period)
    return np.where(j >= n, period - j, j)


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, ksize: int, sigma: Optional[float], lo: int,
                 hi: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """[n_out, n]: row i holds the taps of output i, each at the reflected
    source index it reads (taps that land on one source summed in float64).
    ``sigma`` None is the box kernel."""
    taps = (np.full(ksize, 1.0 / ksize, dtype=np.float32) if sigma is None
            else gaussian_kernel_1d(ksize, sigma)).astype(np.float64)
    n_out = n + lo + hi - ksize + 1
    rows = np.repeat(np.arange(n_out), ksize)
    src = reflect_index(np.arange(n_out)[:, None] + np.arange(ksize)[None]
                        - lo, n).ravel()
    m = np.zeros((n_out, n))
    np.add.at(m, (rows, src), np.tile(taps, n_out))
    return torch.from_numpy(m.astype(np.float32)).to(device=device,
                                                      dtype=dtype)


def _pass_1d(x: torch.Tensor, axis: int, ksize: int, sigma: Optional[float],
             lo: int, hi: int) -> torch.Tensor:
    """One 1-D pass along spatial `axis` (1 = H, 2 = W) of NHWC `x`."""
    m = _band_matrix(x.shape[axis], ksize, sigma, lo, hi, x.device, x.dtype)
    with exact_products(x):
        y = x.movedim(axis, -1) @ m.T
    return y.movedim(-1, axis).contiguous()


def gaussian_blur(x: torch.Tensor, ksize: int = 101,
                  sigma: float = 50.5) -> torch.Tensor:
    """Depthwise Gaussian blur with REFLECT_101 border (kornia's)."""
    pad = ksize // 2
    x = _pass_1d(x, 1, ksize, sigma, pad, ksize - 1 - pad)
    return _pass_1d(x, 2, ksize, sigma, pad, ksize - 1 - pad)


def box_blur(x: torch.Tensor, ksize: int = 100) -> torch.Tensor:
    """Depthwise box blur with REFLECT_101 border (``cv2.blur``'s)."""
    anchor = ksize // 2
    x = _pass_1d(x, 1, ksize, None, anchor, ksize - 1 - anchor)
    return _pass_1d(x, 2, ksize, None, anchor, ksize - 1 - anchor)
