"""Temporal-consistency evaluation: E_warp — ``rerevst_tpu/eval/ewarp.py``.

    E_warp = sum_t || M_t * (S_{t+1} - warp(S_t, F_{t->t+1})) ||_1 / sum_t |M_t|

over consecutive *styled* frames S, with the flow F estimated on the
*original* frames (Farneback, through cv2) or supplied (ground truth, or an
exact pan), and a validity mask M: in-frame warp support and photometric
consistency of the originals under the flow.  ``ewarp_control`` is the same
metric on the original frames, the floor set by the flow's own error.

The warps, masks and sums run on torch tensors on the given device (the
card unless the caller passes ``device="cpu"``); the sums accumulate in
fp64.  Only the Farneback flow needs cv2: without it, pass ``flows``.

The warp is exact bilinear sampling with zeros outside the frame, the
function of the JAX package's ``cv2.remap`` (INTER_LINEAR, BORDER_CONSTANT
0), which may quantize its bilinear weights: tests/test_torch_eval.py holds
the two together exactly at integer flows and to a stated tolerance at
sub-pixel ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from rerevst_torch.config import resolve_device
from rerevst_torch.data.video import require_cv2

def _f32(a, dev: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dev, torch.float32)


def farneback_flow(prev_bgr: np.ndarray, cur_bgr: np.ndarray) -> np.ndarray:
    """Dense forward flow prev->cur, [H,W,2] (dx, dy), on the host."""
    cv2 = require_cv2("Farneback optical flow",
                      "pass the flows (flows=[H,W,2] per frame pair)")
    g0 = cv2.cvtColor(prev_bgr, cv2.COLOR_BGR2GRAY)
    g1 = cv2.cvtColor(cur_bgr, cv2.COLOR_BGR2GRAY)
    return cv2.calcOpticalFlowFarneback(
        g0, g1, None, pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0)


def backward_warp(img, flow, device="cuda") -> torch.Tensor:
    """warp(img)[p] = img[p - flow[p]], bilinear, zero outside the frame.
    `img` [H,W] or [H,W,C], `flow` [H,W,2]; returns fp32 on `device`."""
    dev = resolve_device(device)
    img, flow = _f32(img, dev), _f32(flow, dev)
    h, w = flow.shape[:2]
    sx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] \
        - flow[..., 0]
    sy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] \
        - flow[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    src = img.reshape(h * w, -1)
    out = torch.zeros_like(src)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            out += (wx * wy * inside).reshape(-1, 1) * src[idx.reshape(-1)]
    return out.reshape(img.shape)


def occlusion_mask(prev_bgr, cur_bgr, flow, thresh: float = 20.0,
                   device="cuda") -> torch.Tensor:
    """Validity mask [H,W] (fp32 0/1): in-frame warp support AND photometric
    consistency of the *original* frames under the flow."""
    dev = resolve_device(device)
    h, w = flow.shape[:2]
    support = backward_warp(torch.ones(h, w), flow, dev) >= 0.999
    warped_prev = backward_warp(prev_bgr, flow, dev)
    err = (warped_prev - _f32(cur_bgr, dev)).abs().mean(-1)
    return (support & (err < thresh)).float()


def masked_warps(prev_o, cur_o, prev_s, flow=None, mask=None, device="cuda"):
    """What each temporal metric reads of one frame pair: (mask [H,W],
    warped previous styled frame, warped previous original), fp32 on
    `device`.  The flow is Farneback's and the mask ``occlusion_mask``'s
    unless given."""
    dev = resolve_device(device)
    if flow is None:
        flow = farneback_flow(prev_o, cur_o)
    m = (_f32(mask, dev) if mask is not None
         else occlusion_mask(prev_o, cur_o, flow, device=dev))
    return (m, backward_warp(prev_s, flow, dev),
            backward_warp(prev_o, flow, dev))


class _PairAccumulator:
    """Streaming form of a pairwise temporal metric: push (original, styled)
    frames as they come; only the previous pair stays in memory."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        require_cv2(f"{type(self).__name__} (Farneback optical flow)",
                    "call the clip-level function with flows=...")
        self._prev = None  # (original, styled)
        self._total = self._control = self._weight = 0.0
        self.pairs = 0

    def _add(self, m, warped_s, styled, warped_o, original) -> None:
        raise NotImplementedError

    def push(self, original: np.ndarray, styled: np.ndarray) -> None:
        if self._prev is not None:
            prev_o, prev_s = self._prev
            m, ws, wo = masked_warps(prev_o, original, prev_s,
                                     device=self.device)
            self._add(m, ws, styled, wo, original)
            self.pairs += 1
        self._prev = (original, styled)


def _l1_pair(m, warped_s, styled, warped_o, original, dev):
    """(styled L1 sum, control L1 sum, weight) of one pair, fp64."""
    m3 = m[..., None].double()
    weight = float(m.double().sum()) * 3
    total = float(((warped_s - _f32(styled, dev)).abs() * m3).sum())
    control = float(((warped_o - _f32(original, dev)).abs() * m3).sum())
    return total, control, weight


class EwarpAccumulator(_PairAccumulator):
    """Streaming E_warp; the same sums as ``ewarp`` over the pushed clip."""

    def _add(self, m, warped_s, styled, warped_o, original) -> None:
        total, control, weight = _l1_pair(m, warped_s, styled, warped_o,
                                          original, self.device)
        if weight > 0:
            self._total += total
            self._control += control
            self._weight += weight

    def result(self) -> Dict[str, float]:
        return {
            "ewarp": self._total / max(self._weight, 1.0),
            "ewarp_control": self._control / max(self._weight, 1.0),
            "pairs": self.pairs,
        }


def ewarp(styled: Sequence[np.ndarray], originals: Sequence[np.ndarray],
          flows: Optional[Sequence[np.ndarray]] = None,
          masks: Optional[Sequence[np.ndarray]] = None,
          device="cuda") -> Dict[str, float]:
    """E_warp over a clip of BGR uint8 frames.  Returns {'ewarp',
    'ewarp_control', 'pairs'} in [0,255] pixel units."""
    if len(styled) != len(originals) or len(styled) < 2:
        raise ValueError("need two or more styled frames, one per original")
    dev = resolve_device(device)
    total = control = weight = 0.0
    for t in range(len(styled) - 1):
        m, ws, wo = masked_warps(
            originals[t], originals[t + 1], styled[t],
            None if flows is None else flows[t],
            None if masks is None else masks[t], dev)
        tt, cc, ww = _l1_pair(m, ws, styled[t + 1], wo, originals[t + 1], dev)
        if ww > 0:
            total, control, weight = total + tt, control + cc, weight + ww
    return {
        "ewarp": total / max(weight, 1.0),
        "ewarp_control": control / max(weight, 1.0),
        "pairs": len(styled) - 1,
    }
