"""VGG19 feature extractor through relu4_1 — ``rerevst_tpu/models/vgg.py``.

The content encoder, the style encoder and the loss network share this
backbone with separate weights: which weights are passed in decides which
network runs.  Pools come before conv2_1, conv3_1 and conv4_1.

With ``pairlane=True`` the content encoder's conv1_2 (the full-resolution
64->64 conv) runs the ``conv3x3_pairlane`` kernel, under the JAX package's
gates: 16-bit storage and a geometry the TPU kernel tiles.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from rerevst_torch.kernels import conv3x3_pairlane
from rerevst_torch.models.layers import (
    conv2d,
    from_torch_conv,
    init_conv_torch_default,
    max_pool_2x2,
    weights_as,
)

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

#: torchvision vgg19.features index of each conv (checkpoint conversion).
TORCH_FEATURE_INDEX = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv3_4": 16,
    "conv4_1": 19,
}

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


def init_vgg_params(gen: torch.Generator, dtype: torch.dtype = torch.float32,
                    scheme: str = "torch") -> Dict:
    """scheme='torch': ``nn.Conv2d``'s default init (an untrained reference;
    deep features shrink to ~1e-4).  scheme='he_relu': ReLU-gain He-normal
    weights and zero bias, which keep the features O(1) through all nine
    convs — the choice when no pretrained VGG weights exist."""
    if scheme == "torch":
        return {name: init_conv_torch_default(gen, 3, 3, cin, cout,
                                              dtype=dtype)
                for name, cin, cout in VGG_CONVS}
    if scheme != "he_relu":
        raise ValueError(scheme)
    params = {}
    for name, cin, cout in VGG_CONVS:
        std = math.sqrt(2.0 / (9 * cin))
        params[name] = {
            "w": torch.randn((3, 3, cin, cout), generator=gen,
                             device=gen.device, dtype=dtype) * std,
            "b": torch.zeros((cout,), dtype=dtype, device=gen.device),
        }
    return params


def from_torch_features(state_dict, prefix: str = "",
                        dtype: Optional[torch.dtype] = torch.float32) -> Dict:
    """A torchvision ``vgg19().features`` state_dict slice
    (``{prefix}0.weight`` -> OIHW) -> the backbone's parameters; works for
    the reference checkpoints' ``Encoder.slice.<i>`` and the torchvision
    layout alike."""
    params = {}
    for name, idx in TORCH_FEATURE_INDEX.items():
        wkey = f"{prefix}{idx}.weight"
        if wkey in state_dict:
            params[name] = from_torch_conv(
                state_dict[wkey], state_dict.get(f"{prefix}{idx}.bias"),
                dtype)
    return params


def vgg_features(params: Dict, x: torch.Tensor, upto: str = "relu4_1",
                 pairlane: bool = False) -> VggFeatures:
    """Run the backbone, returning every relu tap up to `upto`.
    ``pairlane`` runs conv1_2 through the ``conv3x3_pairlane`` kernel."""
    taps = {}
    h = x
    for name, _, _ in VGG_CONVS:
        if name in _POOL_BEFORE:
            h = max_pool_2x2(h)
        p = params[name]
        if pairlane and name == "conv1_2":
            h = conv3x3_pairlane(h, *weights_as(p, h.dtype))
        else:
            h = conv2d(p, h, padding=1)
        h = torch.relu(h)
        for tap, conv_name in RELU_TAPS.items():
            if conv_name == name:
                taps[tap] = h
        if RELU_TAPS.get(upto) == name:
            break
    return VggFeatures(taps.get("relu1_1"), taps.get("relu2_1"),
                       taps.get("relu3_1"), taps.get("relu4_1"))


def encode_pairlane_ok(x: torch.Tensor) -> bool:
    """Geometry gate of the pair-lane encoder head, as in the JAX package
    (``rerevst_tpu/models/vgg.py:encode_pairlane_ok``): H divisible by 8 and
    even W.  The card's kernel needs neither; the gate keeps the routing,
    and so the launch counts, the same in both packages."""
    return x.shape[1] % 8 == 0 and x.shape[2] % 2 == 0


def encode(params: Dict, x: torch.Tensor,
           pairlane: bool = False) -> torch.Tensor:
    """Content encoder: the relu4_1 map only.  ``pairlane`` routes conv1_2
    through the ``conv3x3_pairlane`` kernel for 16-bit storage and a
    geometry that passes ``encode_pairlane_ok``, as the JAX package gates
    its pair-lane head; otherwise it is ignored."""
    pairlane = pairlane and x.dtype != torch.float32 and encode_pairlane_ok(x)
    return vgg_features(params, x, "relu4_1", pairlane).relu4_1
