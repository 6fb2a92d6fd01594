"""SSIM (Wang et al. 2004) and temporal (warped) SSIM of styled clips —
``rerevst_tpu/eval/ssim.py``.

The gaussian-window SSIM of the paper (11x11 window, sigma 1.5, K1 = 0.01,
K2 = 0.03, L = 255), with color images averaging their per-channel maps,
and a clip-level temporal SSIM between the flow-warped previous styled frame
and the current one under E_warp's flow and occlusion mask.

The JAX package blurs with ``cv2.GaussianBlur(..., BORDER_REFLECT)``; here
the window is a separable torch conv with the same normalized float32
kernel, and the border is built by index: BORDER_REFLECT repeats the edge
(``fedcba|abcdef``), which ``F.pad(mode="reflect")`` (``gfedcb|abcdef``)
does not.  Everything runs on torch tensors on the given device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from rerevst_torch.config import resolve_device
from rerevst_torch.eval.ewarp import _PairAccumulator, _f32, masked_warps

_K1, _K2, _L = 0.01, 0.03, 255.0
_WIN, _SIGMA = 11, 1.5


def _gauss_window(dev: torch.device) -> torch.Tensor:
    """cv2.getGaussianKernel(11, 1.5): computed in fp64, normalized, stored
    as fp32."""
    r = (_WIN - 1) / 2
    k = [math.exp(-0.5 * (i - r) ** 2 / _SIGMA ** 2) for i in range(_WIN)]
    return torch.tensor([v / sum(k) for v in k], dtype=torch.float32,
                        device=dev)


def _reflect_index(n: int, r: int, dev: torch.device) -> torch.Tensor:
    """Source index of each of n + 2r positions under BORDER_REFLECT."""
    i = torch.arange(-r, n + r, device=dev)
    return torch.where(i < 0, -i - 1, torch.where(i >= n, 2 * n - i - 1, i))


def _blur(x: torch.Tensor) -> torch.Tensor:
    """The 11x11 gaussian window over [N,H,W] maps, BORDER_REFLECT."""
    n, h, w = x.shape
    r = _WIN // 2
    k = _gauss_window(x.device)
    y = x[:, :, _reflect_index(w, r, x.device)][:, None]
    y = F.conv2d(y, k.reshape(1, 1, 1, _WIN))
    y = y[:, :, _reflect_index(h, r, x.device)]
    return F.conv2d(y, k.reshape(1, 1, _WIN, 1))[:, 0]


def ssim_map(a, b, device="cuda") -> torch.Tensor:
    """Per-pixel SSIM map of two images (uint8 or float in [0,255]); a
    multi-channel pair averages its per-channel maps.  fp32 [H,W]."""
    dev = resolve_device(device)
    a, b = _f32(a, dev), _f32(b, dev)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    mx, my, xx, yy, xy = _blur(torch.cat([x, y, x * x, y * y, x * y])) \
        .split(x.shape[0])
    c1, c2 = (_K1 * _L) ** 2, (_K2 * _L) ** 2
    mx2, my2, mxy = mx * mx, my * my, mx * my
    maps = (((2 * mxy + c1) * (2 * (xy - mxy) + c2))
            / ((mx2 + my2 + c1) * ((xx - mx2) + (yy - my2) + c2)))
    return maps.mean(0)


def ssim(a, b, mask=None, device="cuda") -> float:
    """Mean SSIM; with `mask` [H,W], the mask-weighted mean."""
    dev = resolve_device(device)
    m = ssim_map(a, b, dev).double()
    if mask is None:
        return float(m.mean())
    mask = _f32(mask, dev).double()
    return float((m * mask).sum() / max(float(mask.sum()), 1.0))


class TemporalSSIMAccumulator(_PairAccumulator):
    """Streaming temporal SSIM (``EwarpAccumulator``'s flow and mask, SSIM
    in place of L1)."""

    def _add(self, m, warped_s, styled, warped_o, original) -> None:
        w = float(m.double().sum())
        if w > 0:
            self._total += ssim(warped_s, styled, m, self.device) * w
            self._control += ssim(warped_o, original, m, self.device) * w
            self._weight += w

    def result(self) -> Dict[str, float]:
        return {
            "tssim": self._total / max(self._weight, 1.0),
            "tssim_control": self._control / max(self._weight, 1.0),
        }


def temporal_ssim(styled: Sequence, originals: Sequence,
                  flows: Optional[Sequence] = None,
                  masks: Optional[Sequence] = None,
                  device="cuda") -> Dict[str, float]:
    """Clip-level temporal SSIM: SSIM(warp(S_t), S_{t+1}) under E_warp's
    flow and occlusion mask (higher is better, 1.0 perfectly consistent),
    with the unstyled-pair control."""
    if len(styled) != len(originals) or len(styled) < 2:
        raise ValueError("need two or more styled frames, one per original")
    dev = resolve_device(device)
    total = control = weight = 0.0
    for t in range(len(styled) - 1):
        m, ws, wo = masked_warps(
            originals[t], originals[t + 1], styled[t],
            None if flows is None else flows[t],
            None if masks is None else masks[t], dev)
        w = float(m.double().sum())
        if w == 0:
            continue
        total += ssim(ws, styled[t + 1], m, dev) * w
        control += ssim(wo, originals[t + 1], m, dev) * w
        weight += w
    return {
        "tssim": total / max(weight, 1.0),
        "tssim_control": control / max(weight, 1.0),
        "pairs": len(styled) - 1,
    }
