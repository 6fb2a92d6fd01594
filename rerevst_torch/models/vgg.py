"""VGG19 feature extractor through relu4_1 — ``rerevst_tpu/models/vgg.py``.

The content encoder, the style encoder and the loss network share this
backbone with separate weights: which weights are passed in decides which
network runs.  Pools come before conv2_1, conv3_1 and conv4_1.

With ``pairlane=True`` the content encoder's conv1_2 (the full-resolution
64->64 conv) runs the ``conv3x3_pairlane`` kernel, under the JAX package's
gates: 16-bit storage and a geometry the TPU kernel tiles.  With
``head_tiles > 1`` the content encoder's conv1 block runs over overlapping
H-slabs (``ops/tiling.py``), under the JAX package's gate.  ``packed`` is
the JAX package's parity-packed conv1 block, computed without the packed
layout: it closes both of those gates, as there.  ``encode_luma`` is the
encoder with the desaturation folded into conv1_1.  Every conv takes the
``precision`` level it is given (``ops/precision.py``).
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
from rerevst_torch.ops import halo
from rerevst_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
from rerevst_torch.ops.tiling import can_tile_h, tiled_over_h

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
                 pairlane: bool = False,
                 precision: Optional[str] = None) -> VggFeatures:
    """Run the backbone, returning every relu tap up to `upto`.
    ``pairlane`` runs conv1_2 through the ``conv3x3_pairlane`` kernel (on an
    H shard, over the shard and one halo row each side: ``ops/halo.py``)."""
    taps = {}
    h = x
    for name, _, _ in VGG_CONVS:
        if name in _POOL_BEFORE:
            h = max_pool_2x2(h)
        p = params[name]
        if pairlane and name == "conv1_2":
            w, b = weights_as(p, h.dtype)
            h = halo.same_conv(lambda v: conv3x3_pairlane(v, w, b), h)
        else:
            h = conv2d(p, h, padding=1, precision=precision)
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


#: H receptive field of the encoder's conv1 block in full-resolution rows:
#: conv1_1 (1) + conv1_2 (1) + the 2x2 pool's alignment — 3, rounded to 4
#: (even, so slab edges stay pool-aligned).
_HEAD_HALO = 4


def _head(params: Dict, x: torch.Tensor,
          precision: Optional[str]) -> torch.Tensor:
    """conv1_1, relu, conv1_2, relu, pool1: the full-resolution block."""
    h = torch.relu(conv2d(params["conv1_1"], x, padding=1,
                          precision=precision))
    h = torch.relu(conv2d(params["conv1_2"], h, padding=1,
                          precision=precision))
    return max_pool_2x2(h)


def _body(params: Dict, h: torch.Tensor,
          precision: Optional[str]) -> torch.Tensor:
    """conv2_1 .. relu4_1 after the conv1 block and pool1."""
    for name, _, _ in VGG_CONVS[2:]:
        if name in _POOL_BEFORE and name != "conv2_1":
            h = max_pool_2x2(h)  # pool1 already ran with the head
        h = torch.relu(conv2d(params[name], h, padding=1,
                              precision=precision))
    return h


def encode_luma(params: Dict, luma: torch.Tensor,
                precision: Optional[str] = None) -> torch.Tensor:
    """The content encoder on the desaturated input with conv1_1 folded
    (``rerevst_tpu/models/vgg.py:encode_luma``).

    The desaturated frame is an affine image of one luma map g in each
    channel, x_c = a_c g + d_c (a_c = 1 / std_c, d_c = -mean_c / std_c), so
    by linearity conv1_1(x) = conv3x3(g, w1) + conv3x3(ones, wd) + b with
    w1 = sum_c a_c W[..,c,:] and wd = sum_c d_c W[..,c,:], both summed in
    fp32 and cast to g's dtype, as the JAX package does.  The ones-conv is
    the batch-independent border map [1,H,W,64] that zero padding makes of
    the constant term; it runs through ``conv2d``, so on an H shard the
    halo gives it the neighbours' rows and the map is the whole frame's.
    `luma` is ``ops.image.rgb_to_luma01(frame)`` ([N,H,W,1] in [0,1]).
    Equal to ``encode`` of the desaturated frame up to reassociation."""
    p = params["conv1_1"]
    w = p["w"].to(torch.float32)  # [3,3,3,64]
    a = torch.as_tensor(1.0 / IMAGENET_STD, device=w.device)
    d = torch.as_tensor(-IMAGENET_MEAN / IMAGENET_STD, device=w.device)
    dt = luma.dtype
    w1 = torch.einsum("hwco,c->hwo", w, a)[:, :, None, :].to(dt)
    wd = torch.einsum("hwco,c->hwo", w, d)[:, :, None, :].to(dt)
    ones = luma.new_ones((1,) + tuple(luma.shape[1:3]) + (1,))
    border = conv2d({"w": wd}, ones, padding=1, precision=precision)
    h = conv2d({"w": w1}, luma, padding=1, precision=precision)
    h = torch.relu(h + border + p["b"].to(dt))
    h = torch.relu(conv2d(params["conv1_2"], h, padding=1,
                          precision=precision))
    return _body(params, max_pool_2x2(h), precision)


def encode(params: Dict, x: torch.Tensor, pairlane: bool = False,
           head_tiles: int = 1, precision: Optional[str] = None,
           packed: bool = False) -> torch.Tensor:
    """Content encoder: the relu4_1 map only.  ``pairlane`` routes conv1_2
    through the ``conv3x3_pairlane`` kernel for 16-bit storage and a
    geometry that passes ``encode_pairlane_ok``, as the JAX package gates
    its pair-lane head; otherwise it is ignored.  ``packed`` (the JAX
    package's parity-packed conv1 block) computes the plain block and
    closes the pair-lane and tiling gates, as there.

    ``head_tiles > 1`` runs the conv1 block over that many overlapping
    H-slabs (``ops/tiling.py``: the block's two [B,H,W,64] maps are the
    encoder's share of the peak memory at large geometries), under the JAX
    package's gate: not on the pair-lane route, even W, and an H that
    ``can_tile_h`` divides; otherwise the block runs whole.  The encoder
    has no normalization, so the tiled block gives the untiled values."""
    if head_tiles > 1 and not packed and not pairlane \
            and x.shape[2] % 2 == 0 \
            and can_tile_h(x.shape[1], head_tiles, _HEAD_HALO, (1, 2),
                           align=2):
        h = tiled_over_h(lambda xs: _head(params, xs, precision), x,
                         head_tiles, _HEAD_HALO, (1, 2))
        return _body(params, h, precision)
    pairlane = (pairlane and not packed and x.dtype != torch.float32
                and encode_pairlane_ok(x))
    return vgg_features(params, x, "relu4_1", pairlane, precision).relu4_1
