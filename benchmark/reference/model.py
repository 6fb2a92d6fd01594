"""Plain PyTorch reference of the ReReVST stylization network, both modes.

Provenance: written for this benchmark after the published network
(daooshee/ReReVST-Code, ``test/style_network_global.py`` for the two-pass
global mode, ``test/style_network_frame.py`` for per-frame mode) and after
the arithmetic of the port's plain paths as they stood when the benchmark
was added (``rerevst_torch/models/{vgg,transformer,layers}.py``,
``ops/{image,stats}.py``, ``data/transforms.py`` and the plain versions of
the ``norm_affine_clamp`` and ``dynamic_filter_pair`` kernels).  It imports
nothing of the program and calls none of its functions.

Everything is NHWC fp32 with TF32 off (``exact()``).  Departures from the
port, all exact in real arithmetic: a residual block upsamples first and
then runs its 3x3 conv and 1x1 shortcut at the doubled size, as the
published network does; host prep and post-processing are numpy.

``Reference(..., passes=1)`` states the configuration's precision 'default'
instead of exact products: inside ``rounded_convs(1)`` every 3x3 SAME conv
of a feature map (the VGG convs, the filter blocks' and predictors' down
and up convs, the residual blocks' second conv, the out conv) takes its
input and weights rounded to nearest TF32 (round half away from zero, as
PTX's cvt.rna.tf32.f32 does) and multiplies them exactly; the residual
blocks' conv after the upsample and every other product stay exact.

Two-pass global mode: ``collect_stats`` freezes the 11 normalization sites'
mean, rstd and the extrema of the normalized activations, and the six
filters, over the sampled frames' features; ``decode_global`` normalizes
every site with them, clamps to the extrema and applies the style affine.
Per-frame mode: ``decode``, instance norms and filters of each frame.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
NORM_EPS = 1e-8      # inside the instance norm's rsqrt
MEAN_STD_EPS = 1e-5  # on the style statistics' unbiased variance
VGG_CONVS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
             "conv3_2", "conv3_3", "conv3_4", "conv4_1")
POOL_BEFORE = ("conv2_1", "conv3_1", "conv4_1")
TAPS = {"conv1_1": 0, "conv2_1": 1, "conv3_1": 2, "conv4_1": 3}


@contextlib.contextmanager
def exact():
    """Exact fp32 products: TF32 off for cuDNN and cuBLAS, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --------------------------------------------------------------------------
# Host prep and post-processing (numpy)
# --------------------------------------------------------------------------

def bgr_to_model(frames: np.ndarray) -> np.ndarray:
    """BGR uint8 [N,H,W,3] -> ImageNet-normalized RGB float32."""
    rgb = frames[..., ::-1].astype(np.float32) / 255.0
    return (rgb - MEAN) / STD


def padded_size(h: int, w: int, pad: int = 64, gran: int = 64
                ) -> Tuple[int, int]:
    return (-(-(h + 2 * pad) // gran) * gran, -(-(w + 2 * pad) // gran) * gran)


def pad_reflect(x: np.ndarray, pad: int = 64, gran: int = 64) -> np.ndarray:
    """Reflect-pad (edge pixel repeated) by `pad`, then to a multiple of
    `gran` on the bottom and right."""
    n, h, w, _ = x.shape
    th, tw = padded_size(h, w, pad, gran)
    return np.pad(x, ((0, 0), (pad, th - pad - h), (pad, tw - pad - w),
                      (0, 0)), mode="symmetric")


def model_to_bgr(y: np.ndarray) -> np.ndarray:
    """Normalized RGB [N,H,W,3] -> BGR uint8, clipped and rounded to
    nearest even."""
    img = np.clip(y * STD + MEAN, 0.0, 1.0) * 255.0
    return np.rint(img[..., ::-1]).astype(np.uint8)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

#: TF32 passes of the 3x3 SAME convs: 0 exact, 1 operands rounded to TF32.
_PASSES = [0]


@contextlib.contextmanager
def rounded_convs(passes: int):
    """The 3x3 SAME convs at `passes` (0 or 1) inside the block."""
    if passes not in (0, 1):
        raise ValueError(f"passes {passes}: the reference states 0 or 1")
    saved = _PASSES[0]
    _PASSES[0] = passes
    try:
        yield
    finally:
        _PASSES[0] = saved


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest TF32 (10 mantissa bits), ties away
    from zero: add half of the dropped 13 bits to the magnitude's bits, then
    clear them.  Finite values below the largest TF32 number only."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv(p: Dict, x: torch.Tensor, padding: int = 1,
         upsampled: bool = False) -> torch.Tensor:
    """NHWC conv with HWIO weights and zero padding.  Inside
    ``rounded_convs(1)`` a 3x3 SAME conv rounds its operands to TF32,
    unless it reads an `upsampled` map (the port folds that conv into the
    upsample and runs it exact)."""
    w = p["w"]
    if (_PASSES[0] == 1 and padding == 1 and not upsampled
            and tuple(w.shape[:2]) == (3, 3)):
        x, w = tf32_round(x), tf32_round(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), p.get("b"),
                 padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def desaturate(x: torch.Tensor) -> torch.Tensor:
    """The released model's reversed-luma desaturation (0.299 on blue),
    broadcast to three channels and normalized again."""
    mean = torch.as_tensor(MEAN, device=x.device)
    std = torch.as_tensor(STD, device=x.device)
    rgb = x * std + mean
    gray = rgb[..., 2:3] * 0.299 + rgb[..., 1:2] * 0.587 \
        + rgb[..., 0:1] * 0.114
    return (gray.expand(rgb.shape) - mean) / std


def vgg(params: Dict, x: torch.Tensor, upto: str = "conv4_1"
        ) -> List[torch.Tensor]:
    """VGG-19 relu taps relu1_1 .. up to `upto`'s relu."""
    taps = []
    h = x
    for name in VGG_CONVS:
        if name in POOL_BEFORE:
            h = pool(h)
        h = torch.relu(conv(params[name], h))
        if name in TAPS:
            taps.append(h)
        if name == upto:
            break
    return taps


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per (sample, channel) over H, W: biased variance, eps in the rsqrt."""
    m = x.mean((1, 2), keepdim=True)
    v = torch.square(x - m).mean((1, 2), keepdim=True)
    return (x - m) * torch.rsqrt(v + NORM_EPS)


def mean_std(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (sample, channel): unbiased variance, eps before the sqrt."""
    n, h, w, _ = x.shape
    m = x.mean((1, 2), keepdim=True)
    v = torch.square(x - m).sum((1, 2), keepdim=True) / max(h * w - 1, 1)
    return m, torch.sqrt(v + MEAN_STD_EPS)


class Style(NamedTuple):
    map: torch.Tensor
    means: Tuple[torch.Tensor, ...]
    stds: Tuple[torch.Tensor, ...]


class Norm(NamedTuple):
    mean: torch.Tensor
    rstd: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def encode_style(params: Dict, style: torch.Tensor) -> Style:
    taps = vgg(params["encoder_style"], style)
    ms = [mean_std(t) for t in taps]
    return Style(taps[-1], tuple(m for m, _ in ms), tuple(s for _, s in ms))


def encode_content(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return vgg(params["encoder"], desaturate(x))[-1]


# --------------------------------------------------------------------------
# Global mode: Pass 1 and Pass 2
# --------------------------------------------------------------------------

def _freeze(x: torch.Tensor) -> Tuple[torch.Tensor, Norm]:
    """Moments over (N, H, W) and the extrema of the normalized batch."""
    m = x.mean((0, 1, 2), keepdim=True)
    rstd = torch.rsqrt(torch.square(x - m).mean((0, 1, 2), keepdim=True)
                       + NORM_EPS)
    xn = (x - m) * rstd
    return xn, Norm(m, rstd, xn.amin((0, 1, 2), keepdim=True),
                    xn.amax((0, 1, 2), keepdim=True))


def _apply(st: Norm, x: torch.Tensor, s=None, m=None, relu=False):
    if relu:
        x = leaky(x)
    t = torch.minimum(torch.maximum((x - st.mean) * st.rstd, st.lo), st.hi)
    return t if s is None else t * s + m


def _pooled_filter(p: Dict, content: torch.Tensor, ns: torch.Tensor,
                   over_batch: bool) -> torch.Tensor:
    """FilterPredictor: the down conv's spatial means of content and style,
    through the FC, as [B or 1, 32, 32] filters."""
    pc = conv(p["down"], content).mean((1, 2))
    if over_batch:
        pc = pc.mean(0, keepdim=True)
    ps = conv(p["down"], ns).mean((1, 2)).expand(pc.shape[0], -1)
    f = linear(p["fc"], torch.cat([pc, ps], 1))
    return f.reshape(f.shape[0], 32, 32)


def _filt(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """out[b,h,w,p] = sum_q x[b,h,w,q] f[b or 0,p,q]."""
    if f.shape[0] == 1:
        return x @ f[0].T
    return torch.einsum("bhwq,bpq->bhwp", x, f)


def collect_stats(dec: Dict, feats: torch.Tensor, style: Style
                  ) -> Tuple[Dict[str, Norm], Dict[str, torch.Tensor]]:
    """Pass 1 over the sampled frames' relu4_1 features."""
    norms: Dict[str, Norm] = {}
    filters: Dict[str, torch.Tensor] = {}
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds
    h, norms["pre"] = _freeze(feats)
    ns = (style.map - m4) / s4
    for i in (1, 2, 3):
        p = dec[f"filter{i}"]
        inner = conv(p["down"], h)
        fa = filters[f"f{i}a"] = _pooled_filter(p["p1"], h, ns, True)
        fb = filters[f"f{i}b"] = _pooled_filter(p["p2"], h, ns, True)
        inner = _filt(leaky(_filt(inner, fa)), fb)
        h = h + conv(p["up"], inner)

    def ada(h, key, m, s):
        hn, norms[key] = _freeze(h)
        return hn * s + m

    def res(h, p, ka, kb):
        u = up2(h)
        t, norms[ka] = _freeze(leaky(conv(p["conv1"], u, upsampled=True)))
        t, norms[kb] = _freeze(leaky(conv(p["conv2"], t)))
        return conv(p["shortcut"], u, padding=0) + t

    h = ada(h, "ada4", m4, s4)
    h = res(h, dec["res4"], "res4a", "res4b")
    h = ada(h, "ada3", m3, s3)
    h = res(h, dec["res3"], "res3a", "res3b")
    h = ada(h, "ada2", m2, s2)
    h = res(h, dec["res2"], "res2a", "res2b")
    ada(h, "ada1", m1, s1)
    return norms, filters


def decode_global(dec: Dict, x: torch.Tensor, style: Style,
                  norms: Dict[str, Norm], filters: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Pass 2 under the frozen statistics."""
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds
    h = _apply(norms["pre"], x)
    for i in (1, 2, 3):
        p = dec[f"filter{i}"]
        t = conv(p["down"], h)
        t = _filt(leaky(_filt(t, filters[f"f{i}a"])), filters[f"f{i}b"])
        h = h + conv(p["up"], t)

    def res(h, p, ka, kb):
        u = up2(h)
        t = _apply(norms[ka], conv(p["conv1"], u, upsampled=True), relu=True)
        t = _apply(norms[kb], conv(p["conv2"], t), relu=True)
        return conv(p["shortcut"], u, padding=0) + t

    h = _apply(norms["ada4"], h, s4, m4)
    h = res(h, dec["res4"], "res4a", "res4b")
    h = _apply(norms["ada3"], h, s3, m3)
    h = res(h, dec["res3"], "res3a", "res3b")
    h = _apply(norms["ada2"], h, s2, m2)
    h = res(h, dec["res2"], "res2a", "res2b")
    h = _apply(norms["ada1"], h, s1, m1)
    return conv(dec["out"], h)


# --------------------------------------------------------------------------
# Per-frame mode
# --------------------------------------------------------------------------

def decode(dec: Dict, x: torch.Tensor, style: Style) -> torch.Tensor:
    """Per-frame decoder: instance norms, filters predicted per frame; the
    style affine of relu4_1 after the filter chain."""
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds
    h = instance_norm(x)
    ns = (style.map - m4) / s4
    for i in (1, 2, 3):
        p = dec[f"filter{i}"]
        t = conv(p["down"], h)
        fa = _pooled_filter(p["p1"], h, ns, False)
        fb = _pooled_filter(p["p2"], h, ns, False)
        h = h + conv(p["up"], _filt(leaky(_filt(t, fa)), fb))
    h = h * s4 + m4

    def res(h, p):
        u = up2(h)
        t = instance_norm(leaky(conv(p["conv1"], u, upsampled=True)))
        t = instance_norm(leaky(conv(p["conv2"], t)))
        return conv(p["shortcut"], u, padding=0) + t

    h = res(h, dec["res4"])
    h = instance_norm(h) * s3 + m3
    h = res(h, dec["res3"])
    h = instance_norm(h) * s2 + m2
    h = res(h, dec["res2"])
    h = instance_norm(h) * s1 + m1
    return conv(dec["out"], h)


# --------------------------------------------------------------------------
# Whole clips
# --------------------------------------------------------------------------

def to_device(tree, device):
    """An fp32 copy of a parameter tree on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32)


def sample_indices(n: int, interval: int) -> List[int]:
    """Pass 1's frames: every `interval`-th frame, and the last."""
    return [s * interval for s in range((n - 1) // interval)] + [n - 1]


class Reference:
    """The reference network on `device` with fp32 copies of `params`."""

    def __init__(self, params: Dict, style_bgr: np.ndarray, device,
                 passes: int = 0):
        self.device = torch.device(device)
        self.passes = passes
        self.params = to_device({k: v for k, v in params.items()
                                 if k in ("encoder", "encoder_style",
                                          "decoder")}, self.device)
        with torch.no_grad(), exact(), rounded_convs(passes):
            self.style = encode_style(self.params,
                                      self._tensor(bgr_to_model(
                                          style_bgr[None])))

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, torch.float32)

    def pass1(self, samples: Sequence[np.ndarray], chunk: int = 8):
        """The frozen statistics of one clip from its sampled frames."""
        with torch.no_grad(), exact(), rounded_convs(self.passes):
            feats = torch.cat([
                encode_content(self.params, self._tensor(bgr_to_model(
                    np.stack(samples[i:i + chunk]))))
                for i in range(0, len(samples), chunk)])
            return collect_stats(self.params["decoder"], feats, self.style)

    def frames(self, frames: Sequence[np.ndarray], stats=None,
               block: int = 4) -> List[np.ndarray]:
        """Stylized BGR uint8 frames: global mode under `stats` (from
        ``pass1``), per-frame mode without; `block` frames at a time."""
        out = []
        pad = 64
        with torch.no_grad(), exact(), rounded_convs(self.passes):
            for i in range(0, len(frames), block):
                chunk = np.stack(frames[i:i + block])
                h, w = chunk.shape[1:3]
                x = self._tensor(pad_reflect(bgr_to_model(chunk), pad))
                f = encode_content(self.params, x)
                if stats is None:
                    y = decode(self.params["decoder"], f, self.style)
                else:
                    y = decode_global(self.params["decoder"], f, self.style,
                                      *stats)
                y = y[:, pad:pad + h, pad:pad + w].float().cpu().numpy()
                out.extend(model_to_bgr(y))
        return out
