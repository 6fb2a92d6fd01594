"""The U-Net generator — ``rerevst_tpu/models/unet.py``.

The reference carries a progressive-growing ``UnetGenerator`` that no
driver calls (``train/other_networks.py:137-296``); neither package's paths
call this one either: it is kept for the inventory.  NHWC: `num_downs`
conv(k4, s2) + leaky encoder levels mirrored by nearest-2x upsample + conv3x3
+ leaky decoder levels with skip concatenation, a tanh output conv.

Widths (ngf, num_downs = n): encoder level i outputs w_i = min(ngf 2^i,
8 ngf); decoder level i outputs w_{i-1} (ngf at i = 0) and takes its skip
concatenated with the level below.
"""

from __future__ import annotations

from typing import Dict

import torch

from rerevst_torch.models.layers import conv2d, init_conv_normal, leaky_relu
from rerevst_torch.ops.resize import upsample_nearest_2x


def _widths(ngf: int, num_downs: int):
    return [min(ngf * (2 ** i), ngf * 8) for i in range(num_downs)]


def init_unet_params(gen: torch.Generator, in_ch: int = 3, out_ch: int = 3,
                     ngf: int = 64, num_downs: int = 8,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """normal(0, 0.02) HWIO weights and zero biases, on the generator's
    device."""
    w = _widths(ngf, num_downs)
    params: Dict = {}
    cin = in_ch
    for i in range(num_downs):
        params[f"down{i}"] = init_conv_normal(gen, 4, 4, cin, w[i],
                                              dtype=dtype)
        cin = w[i]
    for i in range(num_downs):
        cin_i = w[i] + (w[i] if i < num_downs - 1 else 0)
        cout_i = w[i - 1] if i > 0 else ngf
        params[f"up{i}"] = init_conv_normal(gen, 3, 3, cin_i, cout_i,
                                            dtype=dtype)
    params["out"] = init_conv_normal(gen, 3, 3, ngf, out_ch, dtype=dtype)
    return params


def unet(params: Dict, x: torch.Tensor, num_downs: int = 8) -> torch.Tensor:
    """Forward pass; H and W must be divisible by 2 ** num_downs."""
    skips = []
    h = x
    for i in range(num_downs):
        h = leaky_relu(conv2d(params[f"down{i}"], h, stride=2, padding=1))
        skips.append(h)
    for i in reversed(range(num_downs)):
        if i < num_downs - 1:
            h = torch.cat([h, skips[i]], dim=-1)
        h = upsample_nearest_2x(h)
        h = leaky_relu(conv2d(params[f"up{i}"], h, padding=1))
    return torch.tanh(conv2d(params["out"], h, padding=1))
