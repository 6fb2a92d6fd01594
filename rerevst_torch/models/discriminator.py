"""The 70x70 PatchGAN discriminator and its init —
``rerevst_tpu/models/discriminator.py``.

conv(3 -> 64, k4, s2) + leaky, then [conv(k4, s2, no bias) + BN + leaky] x
(n_layers - 1) doubling the channels (capped at 8 ndf), conv(k4, s1, no
bias) + BN + leaky, conv(-> 1, k4, s1): the reference's
``NLayerDiscriminator`` (``train/other_networks.py:300-344``).  Every conv
pads by 1, so a 256^2 input runs 256 -> 128 -> 64 -> 32 -> 31 -> 30.

BatchNorm always uses the batch's statistics (biased variance, eps 1e-5, in
fp32, cast back): the reference never runs D in eval mode, so no running
statistics exist.  Parameters keep the JAX package's layout (HWIO conv
weights, ``bn{n}: {scale, bias}``), so weights move across as arrays.

Init: the four ``init_weights`` schemes (``train/other_networks.py:28-49``)
for the convs, BN scale N(1, 0.02) and zero biases under every scheme.  The
draws come from an explicit ``torch.Generator``: the distributions of the
JAX package, other values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from rerevst_torch.config import D_INIT_SCHEMES as INIT_SCHEMES
from rerevst_torch.models.layers import conv2d, leaky_relu


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def init_conv_weight(gen: torch.Generator, shape, scheme: str = "normal",
                     gain: float = 0.02,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One HWIO conv weight ``(kh, kw, cin, cout)`` with torch's
    ``init_weights`` semantics: 'normal' N(0, gain); 'xavier'
    xavier_normal_(gain); 'kaiming' kaiming_normal_(a=0, fan_in);
    'orthogonal' orthogonal_(gain) over the (cout, cin kh kw) flattening."""
    kh, kw, cin, cout = shape
    fan_in, fan_out = kh * kw * cin, kh * kw * cout
    if scheme == "normal":
        std = gain
    elif scheme == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    elif scheme == "kaiming":
        std = math.sqrt(2.0 / fan_in)
    elif scheme == "orthogonal":
        rows, cols = cout, kh * kw * cin
        q, r = torch.linalg.qr(_normal(gen, (max(rows, cols),
                                             min(rows, cols))))
        q = q * torch.sign(torch.diagonal(r))  # torch's sign convention
        w2d = q.T if rows < cols else q        # (rows, cols)
        w = (gain * w2d).reshape(cout, cin, kh, kw)
        return w.permute(2, 3, 1, 0).contiguous().to(dtype)
    else:
        raise ValueError(f"unknown init scheme {scheme!r} "
                         f"(choose from {INIT_SCHEMES})")
    return (_normal(gen, shape) * std).to(dtype)


def init_discriminator_params(gen: torch.Generator, in_ch: int = 3,
                              ndf: int = 64, n_layers: int = 3,
                              dtype: torch.dtype = torch.float32,
                              scheme: str = "normal",
                              gain: float = 0.02) -> Dict:
    """The PatchGAN's tree on the generator's device: ``conv0`` (bias),
    ``conv1..conv{n_layers}`` (no bias) each with ``bn{n}``, and
    ``conv_out`` (bias)."""

    def conv(cin, cout, bias):
        p = {"w": init_conv_weight(gen, (4, 4, cin, cout), scheme, gain,
                                   dtype)}
        if bias:
            p["b"] = torch.zeros((cout,), dtype=dtype, device=gen.device)
        return p

    def bn(c):
        return {"scale": (1.0 + _normal(gen, (c,)) * 0.02).to(dtype),
                "bias": torch.zeros((c,), dtype=dtype, device=gen.device)}

    params: Dict = {"conv0": conv(in_ch, ndf, True)}
    nf_prev = 1
    for n in range(1, n_layers + 1):
        nf = min(2 ** n, 8)
        params[f"conv{n}"] = conv(ndf * nf_prev, ndf * nf, False)
        params[f"bn{n}"] = bn(ndf * nf)
        nf_prev = nf
    params["conv_out"] = conv(ndf * nf_prev, 1, True)
    return params


def batch_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm over (N, H, W) of NHWC: the batch's mean and
    biased variance, in fp32, the result in x's dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean((0, 1, 2), keepdim=True)
    var = torch.square(xf - mean).mean((0, 1, 2), keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def discriminator(params: Dict, x: torch.Tensor,
                  n_layers: int = 3) -> torch.Tensor:
    """PatchGAN logits ``[B, H', W', 1]`` of NHWC `x` (no sigmoid)."""
    h = leaky_relu(conv2d(params["conv0"], x, stride=2, padding=1))
    for n in range(1, n_layers):
        h = conv2d(params[f"conv{n}"], h, stride=2, padding=1)
        h = leaky_relu(batch_norm(params[f"bn{n}"], h))
    h = conv2d(params[f"conv{n_layers}"], h, stride=1, padding=1)
    h = leaky_relu(batch_norm(params[f"bn{n_layers}"], h))
    return conv2d(params["conv_out"], h, stride=1, padding=1)
