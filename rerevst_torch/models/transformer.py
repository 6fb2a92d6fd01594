"""The style-transfer network's inference path — ``rerevst_tpu/models/transformer.py``.

Two graphs share the content and style encoders:

* the per-frame graph, ``decode``: stateless instance norms and filters
  predicted for each frame (and its two ablations: plain AdaIN without the
  filter chain, ``dynamic_filter=False``; style-only 3x3 filters,
  ``both_sty_con=False``);
* the two-pass global graph: Pass 1 (``collect_stats`` freezes 11
  ``NormStats`` and 6 filters over the sampled frames) and Pass 2
  (``decode_global`` under those frozen statistics).  It exists for the
  default architecture only, as in the JAX package.

All conditioning state is explicit:

* ``StyleFeatures`` — everything derived from a style image;
* ``SeqStats`` — everything derived from a (style, sampled frames) pair.

``blend_pytrees`` and ``blend_pytrees_batched`` blend several of either
(multi-style interpolation); ``decode_global`` takes the per-sample state
the batched blend gives ([B,1,1,C] statistics, [B,P,Q] filters) as it
takes the shared one.

On the card the 11 normalization sites of ``decode_global`` run the
``norm_affine_clamp`` kernel and its three filter chains the
``dynamic_filter_pair`` kernel; with ``ModelConfig(pairlane=True)`` the
full-resolution 64-channel convs (encoder conv1_2, res2.conv2, the out conv)
run the ``conv3x3_pairlane`` kernel in f16/bf16 sessions.  On the CPU the
same wrappers compute their plain versions.  The per-frame graph computes
its norms and filters in plain PyTorch, as the JAX package computes them
outside its kernels; on the pair-lane route only its encoder's conv1_2 runs
``conv3x3_pairlane``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rerevst_torch.config import ModelConfig
from rerevst_torch.kernels import (
    conv3x3_pairlane,
    dynamic_filter_pair,
    norm_affine_clamp,
)
from rerevst_torch.models import vgg
from rerevst_torch.models.layers import (
    apply_dynamic_filter,
    apply_dynamic_filter_3x3,
    conv2d,
    init_conv_normal,
    init_linear_normal,
    leaky_relu,
    linear,
    upsample2x_conv1x1,
    upsample2x_conv3x3,
    weights_as,
)
from rerevst_torch.ops.image import rgb_to_luma_reversed
from rerevst_torch.ops.stats import (
    channel_minmax,
    instance_moments,
    instance_norm,
    mean_std,
)


class StyleFeatures(NamedTuple):
    """The style encoder's output: the raw relu4_1 map and the per-tap
    (relu1_1..relu4_1) channel mean/std, each [N,1,1,C] in the storage
    dtype."""
    map: torch.Tensor
    means: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    stds: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class NormStats(NamedTuple):
    """Frozen global InstanceNorm state, fp32 [1,1,1,C] each."""
    mean: torch.Tensor
    rstd: torch.Tensor
    xmin: torch.Tensor  # extrema of the *normalized* activations
    xmax: torch.Tensor


class SeqStats(NamedTuple):
    """Per-(sequence, style) frozen decoder state.

    norms keys: 'pre', 'ada4'..'ada1', 'res{4,3,2}{a,b}' (11 sites).
    filters keys: 'f{1,2,3}{a,b}' — six fp32 [1,P,Q] filter matrices.
    """
    norms: Dict[str, NormStats]
    filters: Dict[str, torch.Tensor]


def _tree_map(fn, *trees):
    """``jax.tree.map`` over the conditioning trees: NamedTuples, tuples,
    dicts and tensors."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(tr[k] for tr in trees)) for k in t}
    if isinstance(t, tuple):
        out = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    raise TypeError(f"cannot blend a {type(t).__name__}")


def blend_pytrees(trees: Sequence, weights: Sequence[float]):
    """Weighted sum of identically-structured conditioning trees (multi-style
    blending), in fp32: leaf shapes are kept."""
    w = [float(v) for v in weights]

    def combine(*leaves):
        out = leaves[0].float() * w[0]
        for leaf, wi in zip(leaves[1:], w[1:]):
            out = out + leaf.float() * wi
        return out

    return _tree_map(combine, *trees)


def blend_pytrees_batched(trees: Sequence, weights):
    """Per-sample weighted sums: `weights` is [B, n_trees], one blend per
    batch row, in fp32.  A leaf of leading dim 1 comes back with leading dim
    B (NormStats [1,1,1,C] -> [B,1,1,C]; filters [1,P,Q] -> [B,P,Q]): the
    per-sample shapes ``decode_global`` takes."""
    w = torch.as_tensor(np.asarray(weights, np.float32))

    def combine(*leaves):
        stacked = torch.stack([leaf.float() for leaf in leaves])  # [S,1,...]
        out = torch.tensordot(w.to(stacked.device), stacked, dims=1)
        return out.reshape((w.shape[0],) + tuple(stacked.shape[2:]))

    return _tree_map(combine, *trees)


# ---------------------------------------------------------------------------
# Parameter initialization (``rerevst_tpu``'s tree, drawn from a
# torch.Generator: the same distributions, other values)
# ---------------------------------------------------------------------------

def _init_predictor(gen: torch.Generator, cfg: ModelConfig,
                    style_only: bool) -> Dict:
    ic, vc = cfg.filter_channels, cfg.vgg_channels
    down = init_conv_normal(gen, 3, 3, vc, ic, dtype=cfg.dtype)
    if style_only:  # FilterPredictor_S: FC(ic -> 9 ic ic)
        fc = init_linear_normal(gen, ic, 9 * ic * ic, dtype=cfg.dtype)
    else:  # FilterPredictor: FC(2 ic -> ic ic)
        fc = init_linear_normal(gen, 2 * ic, ic * ic, dtype=cfg.dtype)
    return {"down": down, "fc": fc}


def _init_kernel_filter(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    ic, vc = cfg.filter_channels, cfg.vgg_channels
    style_only = not cfg.both_sty_con
    return {
        "down": init_conv_normal(gen, 3, 3, vc, ic, dtype=cfg.dtype),
        "up": init_conv_normal(gen, 3, 3, ic, vc, dtype=cfg.dtype),
        "p1": _init_predictor(gen, cfg, style_only),
        "p2": _init_predictor(gen, cfg, style_only),
    }


def _init_resblock(gen: torch.Generator, cin: int, cout: int,
                   dtype: torch.dtype) -> Dict:
    return {
        "conv1": init_conv_normal(gen, 3, 3, cin, cout, dtype=dtype),
        "conv2": init_conv_normal(gen, 3, 3, cout, cout, dtype=dtype),
        "shortcut": init_conv_normal(gen, 1, 1, cin, cout, bias=False,
                                     dtype=dtype),
    }


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """The decoder's tree: normal(0, 0.02) weights, zero biases."""
    params = {
        "res4": _init_resblock(gen, 512, 256, cfg.dtype),
        "res3": _init_resblock(gen, 256, 128, cfg.dtype),
        "res2": _init_resblock(gen, 128, 64, cfg.dtype),
        "out": init_conv_normal(gen, 3, 3, 64, 3, dtype=cfg.dtype),
    }
    if cfg.dynamic_filter:
        for i in (1, 2, 3):
            params[f"filter{i}"] = _init_kernel_filter(gen, cfg)
    return params


def init_transformer_params(gen: torch.Generator, cfg: ModelConfig,
                            with_loss_net: bool = True,
                            vgg_scheme: str = "torch") -> Dict:
    """The whole tree — ``encoder``, ``encoder_style``, ``decoder`` and, with
    `with_loss_net`, the frozen loss network ``vgg_loss`` — on the
    generator's device.  ``vgg_scheme='he_relu'`` gives magnitude-preserving
    VGG features (see ``vgg.init_vgg_params``)."""
    params = {
        "encoder": vgg.init_vgg_params(gen, cfg.dtype, vgg_scheme),
        "encoder_style": vgg.init_vgg_params(gen, cfg.dtype, vgg_scheme),
        "decoder": init_decoder_params(gen, cfg),
    }
    if with_loss_net:
        params["vgg_loss"] = vgg.init_vgg_params(gen, cfg.dtype, vgg_scheme)
    return params


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def encode_content(params: Dict, frame: torch.Tensor, cfg: ModelConfig,
                   desaturate: bool = True) -> torch.Tensor:
    """Content branch: reversed-luma desaturation (inference), then
    VGG -> relu4_1 in the storage dtype."""
    x = rgb_to_luma_reversed(frame) if desaturate else frame
    return vgg.encode(params["encoder"], x.to(cfg.dtype),
                      pairlane=cfg.pairlane)


def encode_style(params: Dict, style: torch.Tensor,
                 cfg: ModelConfig) -> StyleFeatures:
    """EncoderStyle: per-tap (mean, std) + the raw relu4_1 map."""
    feats = vgg.vgg_features(params["encoder_style"], style.to(cfg.dtype),
                             "relu4_1")
    means, stds = [], []
    for tap in feats:
        m, s = mean_std(tap, eps=cfg.mean_std_eps)
        means.append(m)
        stds.append(s)
    return StyleFeatures(feats.relu4_1, tuple(means), tuple(stds))


# ---------------------------------------------------------------------------
# Per-frame (stateless) graph
# ---------------------------------------------------------------------------

def _instance_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-sample InstanceNorm over (H, W) (``ops.stats.instance_norm``)."""
    return instance_norm(x, (1, 2), eps)


def _predict_filter(p: Dict, content: torch.Tensor, style_map: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """FilterPredictor.forward: pooled content and style features -> one
    [P,Q] filter per content sample, [B,P,Q] in the storage dtype (the
    style's pooled features broadcast over the content batch)."""
    pc = conv2d(p["down"], content, padding=1).mean((1, 2))
    ps = conv2d(p["down"], style_map, padding=1).mean((1, 2))
    if ps.shape[0] == 1 and pc.shape[0] != 1:
        ps = ps.expand(pc.shape)
    f = linear(p["fc"], torch.cat([pc, ps], dim=1))
    ic = cfg.filter_channels
    return f.reshape(-1, ic, ic)


def _predict_filter_s(p: Dict, style_map: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """FilterPredictor_S.forward: the style alone -> [N,P,Q,3,3] filters."""
    ps = conv2d(p["down"], style_map, padding=1).mean((1, 2))
    f = linear(p["fc"], ps)
    ic = cfg.filter_channels
    return f.reshape(-1, ic, ic, 3, 3)


def _kernel_filter(p: Dict, content: torch.Tensor, style_map: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """KernelFilter.forward (KernelFilter_S under ``both_sty_con=False``)
    with filters predicted for this batch."""
    h = conv2d(p["down"], content, padding=1)
    if cfg.both_sty_con:
        h = apply_dynamic_filter(
            h, _predict_filter(p["p1"], content, style_map, cfg))
        h = leaky_relu(h)
        h = apply_dynamic_filter(
            h, _predict_filter(p["p2"], content, style_map, cfg))
    else:
        h = apply_dynamic_filter_3x3(h, _predict_filter_s(p["p1"], style_map,
                                                          cfg))
        h = leaky_relu(h)
        h = apply_dynamic_filter_3x3(h, _predict_filter_s(p["p2"], style_map,
                                                          cfg))
    return content + conv2d(p["up"], h, padding=1)


def _resblock(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """ResidualBlock.forward with stateless norms; the nearest-2x upsample
    feeds both the shortcut (1x1 conv, then the upsample) and conv1."""
    xs = upsample2x_conv1x1(p["shortcut"], x)
    h = upsample2x_conv3x3(p["conv1"], x)
    h = _instance_norm(leaky_relu(h), cfg.norm_eps)
    h = conv2d(p["conv2"], h, padding=1)
    h = _instance_norm(leaky_relu(h), cfg.norm_eps)
    return xs + h


def decode(params_dec: Dict, x: torch.Tensor, style: StyleFeatures,
           cfg: ModelConfig) -> torch.Tensor:
    """Per-frame decoder graph: the filter chain runs on the instance-normed
    content, then the relu4_1 style affine is re-applied (no norm site
    between the filters and res4, unlike the global graph); under
    ``dynamic_filter=False`` plain AdaIN takes the chain's place."""
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds

    def adain(h, m, s):
        return _instance_norm(h, cfg.norm_eps) * s + m

    if cfg.dynamic_filter:
        nc = _instance_norm(x, cfg.norm_eps)
        ns = (style.map - m4) / s4
        h = _kernel_filter(params_dec["filter1"], nc, ns, cfg)
        h = _kernel_filter(params_dec["filter2"], h, ns, cfg)
        h = _kernel_filter(params_dec["filter3"], h, ns, cfg)
        h = h * s4 + m4
    else:
        h = adain(x, m4, s4)

    h = _resblock(params_dec["res4"], h, cfg)
    h = adain(h, m3, s3)
    h = _resblock(params_dec["res3"], h, cfg)
    h = adain(h, m2, s2)
    h = _resblock(params_dec["res2"], h, cfg)
    h = adain(h, m1, s1)
    return conv2d(params_dec["out"], h, padding=1)


# ---------------------------------------------------------------------------
# Global (frozen statistics) graph — Pass 2
# ---------------------------------------------------------------------------

def _norm_apply(st: NormStats, x: torch.Tensor,
                style_std: Optional[torch.Tensor] = None,
                style_mean: Optional[torch.Tensor] = None,
                leaky: bool = False) -> torch.Tensor:
    """Frozen-stats normalize + clamp, optionally after a leaky-relu and
    followed by the style affine — one ``norm_affine_clamp`` call, computed
    in fp32 and stored in x's dtype."""
    return norm_affine_clamp(x, st, style_std, style_mean, leaky)


def _kernel_filter_frozen(p: Dict, content: torch.Tensor, fa: torch.Tensor,
                          fb: torch.Tensor) -> torch.Tensor:
    """KernelFilter.forward with frozen filters; the filter pair between the
    down and up convs is one ``dynamic_filter_pair`` call."""
    h = conv2d(p["down"], content, padding=1)
    h = dynamic_filter_pair(h, fa, fb)
    return content + conv2d(p["up"], h, padding=1)


def _conv3x3(p: Dict, x: torch.Tensor, pairlane: bool) -> torch.Tensor:
    """A full-resolution 64-channel SAME 3x3 conv: the ``conv3x3_pairlane``
    kernel on the pair-lane route, ``conv2d`` otherwise."""
    if pairlane:
        return conv3x3_pairlane(x, *weights_as(p, x.dtype))
    return conv2d(p, x, padding=1)


def _resblock_global(p: Dict, x: torch.Tensor, sa: NormStats,
                     sb: NormStats, pairlane: bool = False) -> torch.Tensor:
    """ResidualBlock.forward under frozen norms; the nearest-2x upsample
    feeds both the shortcut and conv1; ``pairlane`` runs conv2 through the
    ``conv3x3_pairlane`` kernel (res2 only)."""
    xs = upsample2x_conv1x1(p["shortcut"], x)
    h = upsample2x_conv3x3(p["conv1"], x)
    h = _norm_apply(sa, h, leaky=True)
    h = _conv3x3(p["conv2"], h, pairlane)
    h = _norm_apply(sb, h, leaky=True)
    return xs + h


def decode_global(params_dec: Dict, x: torch.Tensor, style: StyleFeatures,
                  stats: SeqStats, cfg: ModelConfig) -> torch.Tensor:
    """Global decoder graph: every norm uses frozen sequence statistics with
    min/max clamping; the filter chain's output is re-normalized at the extra
    'ada4' site before the style affine; filters come frozen from `stats`.

    ``cfg.pairlane`` runs res2.conv2 and the out conv through the
    ``conv3x3_pairlane`` kernel under the JAX package's gate for its
    pair-lane tail: 16-bit storage, and res2's input with H divisible by 4
    and even W.  One deliberate difference: there an f16 session runs that
    region (and the pair-lane encoder head) in bf16, only because Mosaic has
    no f16; the card's kernel takes f16, so the region stays in the
    session's storage dtype."""
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds
    norms, filt = stats.norms, stats.filters

    h = _norm_apply(norms["pre"], x)
    h = _kernel_filter_frozen(params_dec["filter1"], h, filt["f1a"], filt["f1b"])
    h = _kernel_filter_frozen(params_dec["filter2"], h, filt["f2a"], filt["f2b"])
    h = _kernel_filter_frozen(params_dec["filter3"], h, filt["f3a"], filt["f3b"])

    h = _norm_apply(norms["ada4"], h, s4, m4)
    h = _resblock_global(params_dec["res4"], h, norms["res4a"], norms["res4b"])
    h = _norm_apply(norms["ada3"], h, s3, m3)
    h = _resblock_global(params_dec["res3"], h, norms["res3a"], norms["res3b"])
    h = _norm_apply(norms["ada2"], h, s2, m2)
    pl = (cfg.pairlane and cfg.dtype != torch.float32
          and h.shape[1] % 4 == 0 and h.shape[2] % 2 == 0)
    h = _resblock_global(params_dec["res2"], h, norms["res2a"], norms["res2b"],
                         pl)
    h = _norm_apply(norms["ada1"], h, s1, m1)
    return _conv3x3(params_dec["out"], h, pl)


# ---------------------------------------------------------------------------
# Global statistics collection — Pass 1
# ---------------------------------------------------------------------------

def _norm_compute(x: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, NormStats]:
    """InstanceNorm.compute over (N,H,W): (normalized batch, NormStats), with
    the two-pass variance of ``instance_moments``."""
    xf = x.to(torch.float32)
    mean, rstd = instance_moments(xf, (0, 1, 2), eps)
    xn = (xf - mean) * rstd
    xmin, xmax = channel_minmax(xn, (0, 1, 2))
    return xn.to(x.dtype), NormStats(mean, rstd, xmin, xmax)


def _filter_compute(p: Dict, content_batch: torch.Tensor,
                    style_map: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """FilterPredictor.compute: content pooled over the whole sampled batch ->
    one fp32 [1,P,Q] filter per sequence.  The pooling and the FC run in fp32
    in every storage dtype: the frozen filters stay fp32."""
    pc = conv2d(p["down"], content_batch, padding=1).float().mean((1, 2))
    pc = pc.mean(0, keepdim=True)
    ps = conv2d(p["down"], style_map, padding=1).float().mean((1, 2))
    fc = {k: v.float() for k, v in p["fc"].items()}
    f = linear(fc, torch.cat([pc, ps], dim=1))
    ic = cfg.filter_channels
    return f.reshape(-1, ic, ic)


def collect_stats(params_dec: Dict, x: torch.Tensor, style: StyleFeatures,
                  cfg: ModelConfig) -> SeqStats:
    """Decoder.compute: run the global graph over the sampled-frame batch
    ``x`` ([N, H/8, W/8, 512] content features), freezing every norm and
    filter."""
    eps = cfg.norm_eps
    norms: Dict[str, NormStats] = {}
    filters: Dict[str, torch.Tensor] = {}
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds

    h, norms["pre"] = _norm_compute(x, eps)
    ns = (style.map - m4) / s4

    for i, name in ((1, "filter1"), (2, "filter2"), (3, "filter3")):
        p = params_dec[name]
        inner = conv2d(p["down"], h, padding=1)
        fa = _filter_compute(p["p1"], h, ns, cfg)
        filters[f"f{i}a"] = fa
        inner = leaky_relu(apply_dynamic_filter(inner, fa))
        fb = _filter_compute(p["p2"], h, ns, cfg)
        filters[f"f{i}b"] = fb
        inner = apply_dynamic_filter(inner, fb)
        h = h + conv2d(p["up"], inner, padding=1)

    def ada_compute(h, key, m, s):
        hn, norms[key] = _norm_compute(h, eps)
        return hn * s + m

    def res_compute(h, p, ka, kb):
        xs = upsample2x_conv1x1(p["shortcut"], h)
        t = upsample2x_conv3x3(p["conv1"], h)
        t, norms[ka] = _norm_compute(leaky_relu(t), eps)
        t = conv2d(p["conv2"], t, padding=1)
        t, norms[kb] = _norm_compute(leaky_relu(t), eps)
        return xs + t

    h = ada_compute(h, "ada4", m4, s4)
    h = res_compute(h, params_dec["res4"], "res4a", "res4b")
    h = ada_compute(h, "ada3", m3, s3)
    h = res_compute(h, params_dec["res3"], "res3a", "res3b")
    h = ada_compute(h, "ada2", m2, s2)
    h = res_compute(h, params_dec["res2"], "res2a", "res2b")
    ada_compute(h, "ada1", m1, s1)  # freezes 'ada1'; output discarded
    return SeqStats(norms, filters)


def stylize(params: Dict, frame: torch.Tensor, style: StyleFeatures,
            cfg: ModelConfig, stats: Optional[SeqStats] = None
            ) -> torch.Tensor:
    """Full forward: desaturate -> encode -> decode, the global graph iff
    ``stats`` is given (``rerevst_tpu``'s ``TransformerNet.stylize``)."""
    f = encode_content(params, frame, cfg, desaturate=True)
    if stats is None:
        return decode(params["decoder"], f, style, cfg)
    return decode_global(params["decoder"], f, style, stats, cfg)


class TransformerNet:
    """A model config and pure functions over parameter trees
    (``rerevst_tpu.models.transformer.TransformerNet``)."""

    def __init__(self, cfg: Optional[ModelConfig] = None):
        self.cfg = cfg or ModelConfig()

    def init_params(self, gen: torch.Generator,
                    with_loss_net: bool = True) -> Dict:
        return init_transformer_params(gen, self.cfg, with_loss_net)

    def encode_content(self, params: Dict, frame: torch.Tensor,
                       desaturate: bool = True) -> torch.Tensor:
        return encode_content(params, frame, self.cfg, desaturate)

    def encode_style(self, params: Dict, style: torch.Tensor
                     ) -> StyleFeatures:
        return encode_style(params, style, self.cfg)

    def stylize(self, params: Dict, frame: torch.Tensor,
                style: StyleFeatures, stats: Optional[SeqStats] = None
                ) -> torch.Tensor:
        """Full forward: desaturate -> encode -> decode (global iff
        `stats`)."""
        return stylize(params, frame, style, self.cfg, stats)

    def collect(self, params: Dict, content_feats: torch.Tensor,
                style: StyleFeatures) -> SeqStats:
        return collect_stats(params["decoder"], content_feats, style,
                             self.cfg)

    def validation(self, params: Dict, frame: torch.Tensor,
                   style_img: torch.Tensor) -> torch.Tensor:
        """The training-time validation pass: the COLOR content through the
        per-frame graph (no desaturation)."""
        f = encode_content(params, frame, self.cfg, desaturate=False)
        return decode(params["decoder"], f,
                      encode_style(params, style_img, self.cfg), self.cfg)
