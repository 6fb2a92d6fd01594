"""VGG19 feature extractor through relu4_1 — ``rerevst_tpu/models/vgg.py``.

The content encoder, the style encoder and the loss network share this
backbone with separate weights: which weights are passed in decides which
network runs.  Pools come before conv2_1, conv3_1 and conv4_1.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from rerevst_torch.models.layers import conv2d, max_pool_2x2

#: (name, cin, cout) of the 9 convs through conv4_1, in order.
VGG_CONVS = (
    ("conv1_1", 3, 64),
    ("conv1_2", 64, 64),
    ("conv2_1", 64, 128),
    ("conv2_2", 128, 128),
    ("conv3_1", 128, 256),
    ("conv3_2", 256, 256),
    ("conv3_3", 256, 256),
    ("conv3_4", 256, 256),
    ("conv4_1", 256, 512),
)

_POOL_BEFORE = {"conv2_1", "conv3_1", "conv4_1"}

RELU_TAPS = {
    "relu1_1": "conv1_1",
    "relu2_1": "conv2_1",
    "relu3_1": "conv3_1",
    "relu4_1": "conv4_1",
}


class VggFeatures(NamedTuple):
    """The four relu taps (None past the requested one)."""
    relu1_1: Optional[torch.Tensor]
    relu2_1: Optional[torch.Tensor]
    relu3_1: Optional[torch.Tensor]
    relu4_1: Optional[torch.Tensor]


def vgg_features(params: Dict, x: torch.Tensor,
                 upto: str = "relu4_1") -> VggFeatures:
    """Run the backbone, returning every relu tap up to `upto`."""
    taps = {}
    h = x
    for name, _, _ in VGG_CONVS:
        if name in _POOL_BEFORE:
            h = max_pool_2x2(h)
        h = torch.relu(conv2d(params[name], h, padding=1))
        for tap, conv_name in RELU_TAPS.items():
            if conv_name == name:
                taps[tap] = h
        if RELU_TAPS.get(upto) == name:
            break
    return VggFeatures(taps.get("relu1_1"), taps.get("relu2_1"),
                       taps.get("relu3_1"), taps.get("relu4_1"))


def encode(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Content encoder: the relu4_1 map only."""
    return vgg_features(params, x, "relu4_1").relu4_1
