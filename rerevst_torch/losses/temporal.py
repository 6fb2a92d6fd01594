"""Compound Regularization: the synthetic-motion temporal loss —
``rerevst_tpu/losses/temporal.py``.

  fake flow = bilinear-resized coarse Gaussian noise (sigma = motion_level)
              + a random integer global shift (+-shift_level, inclusive)
              + a 100x100 box blur
  fake data = nearest-warp(first frame) + Gaussian pixel noise with
              std = noise_level (1 + U[0, 1))
  loss      = L1(nearest-warp(styled first), styled second)

The draws come from an explicit ``torch.Generator`` on the frame's device,
so a train step never leaves the device.  They cannot reproduce the JAX
package's PRNG streams: ``fake_flow_from_noise`` is the deterministic part,
which takes the coarse noise and the shift as arguments.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rerevst_torch.config import LossConfig
from rerevst_torch.ops.blur import box_blur
from rerevst_torch.ops.resize import resize_bilinear
from rerevst_torch.ops.warp import flow_warp


def fake_flow_from_noise(coarse: torch.Tensor, shift: torch.Tensor,
                         height: int, width: int) -> torch.Tensor:
    """One fake flow field [H, W, 2] from coarse noise [1, h, w, 2] (already
    scaled by the motion level) and an integer shift [2]."""
    flow = resize_bilinear(coarse, height, width)
    flow = flow + shift.to(flow.dtype)
    return box_blur(flow, ksize=100)[0]


def generate_fake_flow(gen: torch.Generator, height: int, width: int,
                       motion_level: float = 8.0,
                       shift_level: int = 10) -> torch.Tensor:
    """One fake flow field [H, W, 2] on the generator's device."""
    dev = gen.device
    if motion_level > 0:
        ch, cw = max(height // 100, 1), max(width // 100, 1)
        coarse = torch.randn((1, ch, cw, 2), generator=gen,
                             device=dev) * motion_level
        shift = torch.randint(-shift_level, shift_level + 1, (2,),
                              generator=gen, device=dev)
        return fake_flow_from_noise(coarse, shift, height, width)
    shift = torch.randint(-shift_level, shift_level + 1, (2,), generator=gen,
                          device=dev)
    return shift.to(torch.float32).expand(height, width, 2)


def generate_fake_data(gen: torch.Generator, first_frame: torch.Tensor,
                       cfg: LossConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(second_frame, forward_flow) from one normalized frame batch
    [B,H,W,3]."""
    b, h, w, _ = first_frame.shape
    if cfg.data_w:
        flow = generate_fake_flow(gen, h, w, cfg.motion_level,
                                  cfg.shift_level)
        flow = flow[None].expand(b, h, w, 2)
        second = flow_warp(first_frame, flow, mode="nearest")
    else:
        flow = torch.zeros((b, h, w, 2), dtype=first_frame.dtype,
                           device=first_frame.device)
        second = first_frame
    if cfg.data_sigma:
        std = cfg.noise_level * (1.0 + torch.rand((), generator=gen,
                                                  device=gen.device))
        second = second + torch.randn(second.shape, generator=gen,
                                      device=gen.device,
                                      dtype=second.dtype) * std
    return second, flow


def temporal_loss(styled_first: torch.Tensor, styled_second: torch.Tensor,
                  flow: torch.Tensor, use_warp: bool = True):
    """L1 between the warped styled first frame and the styled second;
    returns (loss, warped_first)."""
    warped = flow_warp(styled_first, flow, mode="nearest") if use_warp \
        else styled_first
    return torch.mean(torch.abs(warped - styled_second)), warped


def temporal_loss_mpi(new_cur_frame: torch.Tensor, pre_frame: torch.Tensor,
                      backward_flow: torch.Tensor,
                      backward_mask: torch.Tensor):
    """Figure-16 ablation on MPI Sintel's ground-truth backward flow
    (``train/loss_networks.py:117-130``): L1 between the masked
    nearest-warp of the current frame and the masked previous frame;
    returns (loss, fake previous frame)."""
    fake_pre = flow_warp(new_cur_frame, backward_flow, mode="nearest")
    fake_pre = fake_pre * backward_mask
    pre = pre_frame * backward_mask
    return torch.mean(torch.abs(fake_pre - pre)), fake_pre


def temporal_loss_video(cur_frame: torch.Tensor, pre_frame: torch.Tensor,
                        forward_flow: torch.Tensor,
                        forward_mask: torch.Tensor):
    """Figure-16 ablation on real-video pairs and their forward flow
    (``train/loss_networks.py:132-145``): L1 between the masked
    nearest-warp of the previous frame and the masked current frame;
    returns (loss, fake current frame)."""
    fake_cur = flow_warp(pre_frame, forward_flow, mode="nearest")
    fake_cur = fake_cur * forward_mask
    cur = cur_frame * forward_mask
    return torch.mean(torch.abs(fake_cur - cur)), fake_cur
