"""Streaming sequence-statistics collection for long clips —
``rerevst_tpu/parallel/streaming.py``.

The sampled frames' features live on the host (any array: a numpy memmap of
the session's spool, typically); the device holds one chunk at a time.

The collection graph has 14 cross-frame reduction stages in dependency order
(each stage's input needs every earlier stage frozen):

  pre | f1 | f2 | f3 | ada4 | res4a | res4b | ada3 | res3a | res3b
      | ada2 | res2a | res2b | ada1

For each stage every chunk goes through the frozen prefix of the global
decoder — the port's own ``_norm_apply`` (the ``norm_affine_clamp`` kernel,
its leaky prologue at the ``res*a`` and ``res*b`` sites) and
``_kernel_filter_frozen`` (the ``dynamic_filter_pair`` kernel) — and one
pass of reductions: count, mean, M2, min and max per channel, in fp32 on
the device, merged across chunks by Welford on the host in fp64.  The
extrema of the normalized values are an affine image of the raw extrema,
so no second pass is needed.  The ``res*a`` and ``res*b`` stages reduce
over leaky(conv), before the norm.  Filter stages sum the pooled predictor
inputs in fp64 (``_pool_pred``); the filters come out fp32.

Cost: about 7x the batched collection's operations, the price of O(chunk)
device memory.  Results match the batched ``collect_stats`` up to fp
reassociation (and, in 16-bit storage, up to where each rounds to the
storage dtype: the kernels keep the affine and the filter pair's
intermediate in fp32).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from rerevst_torch.config import ModelConfig
from rerevst_torch.models.layers import (
    conv2d,
    leaky_relu,
    linear,
    upsample2x_conv1x1,
    upsample2x_conv3x3,
)
from rerevst_torch.models.transformer import (
    NormStats,
    SeqStats,
    StyleFeatures,
    _kernel_filter_frozen,
    _norm_apply,
)

#: reduction stages in dependency order
STAGES = ("pre", "f1", "f2", "f3", "ada4", "res4a", "res4b",
          "ada3", "res3a", "res3b", "ada2", "res2a", "res2b", "ada1")


def _prefix_to(params_dec: Dict, x: torch.Tensor, style: StyleFeatures,
               stats: Dict[str, NormStats], filters: Dict[str, torch.Tensor],
               cfg: ModelConfig, upto: str) -> torch.Tensor:
    """Run the frozen-stats decode prefix; return the tensor the stage `upto`
    reduces over (for a filter stage, the content its predictors pool)."""
    m1, m2, m3, m4 = style.means
    s1, s2, s3, s4 = style.stds
    if upto == "pre":
        return x
    h = _norm_apply(stats["pre"], x)
    for i in (1, 2, 3):
        if upto == f"f{i}":
            return h
        h = _kernel_filter_frozen(params_dec[f"filter{i}"], h,
                                  filters[f"f{i}a"], filters[f"f{i}b"])
    for ada, m, s, res in (("ada4", m4, s4, "res4"), ("ada3", m3, s3, "res3"),
                           ("ada2", m2, s2, "res2")):
        if upto == ada:
            return h
        h = _norm_apply(stats[ada], h, s, m)
        p = params_dec[res]
        t = upsample2x_conv3x3(p["conv1"], h)
        if upto == res + "a":
            return leaky_relu(t)
        t = conv2d(p["conv2"], _norm_apply(stats[res + "a"], t, leaky=True),
                   padding=1)
        if upto == res + "b":
            return leaky_relu(t)
        h = upsample2x_conv1x1(p["shortcut"], h) \
            + _norm_apply(stats[res + "b"], t, leaky=True)
    if upto == "ada1":
        return h
    raise ValueError(upto)


class _Welford:
    """Chunk-mergeable per-channel moments and extrema, fp64 on the host."""

    def __init__(self, c: int):
        self.count = 0.0
        self.mean = np.zeros(c, np.float64)
        self.m2 = np.zeros(c, np.float64)
        self.min = np.full(c, np.inf, np.float64)
        self.max = np.full(c, -np.inf, np.float64)

    def update(self, cnt, mean, m2, mn, mx) -> None:
        mean, m2 = np.float64(mean), np.float64(m2)
        delta = mean - self.mean
        tot = self.count + cnt
        if tot == 0:
            return
        self.m2 += m2 + delta * delta * (self.count * cnt / tot)
        self.mean += delta * (cnt / tot)
        self.count = tot
        self.min = np.minimum(self.min, mn)
        self.max = np.maximum(self.max, mx)

    def finalize(self, eps: float, device) -> NormStats:
        mean = self.mean
        var = self.m2 / max(self.count, 1.0)
        rstd = 1.0 / np.sqrt(var + eps)
        xmin = (self.min - mean) * rstd
        xmax = (self.max - mean) * rstd

        def _c(a):
            return torch.as_tensor(a.reshape(1, 1, 1, -1), dtype=torch.float32,
                                   device=device)

        return NormStats(_c(mean), _c(rstd), _c(xmin), _c(xmax))


class _ChunkFeed:
    """Lazy chunk iterator over a host feature array (a memmap stays on disk
    between stages).  Each chunk goes up in one copy and is cast on the
    device to the storage dtype — lossless, the spooled fp32 values came
    from it."""

    def __init__(self, feats_host, chunk_size: int, dtype: torch.dtype,
                 device: torch.device):
        self.feats = feats_host
        self.n = feats_host.shape[0]
        self.chunk = max(1, int(chunk_size))
        self.dtype = dtype
        self.device = device

    def __iter__(self) -> Iterator[torch.Tensor]:
        for i in range(0, self.n, self.chunk):
            ch = self.feats[i:i + self.chunk]
            if not isinstance(ch, torch.Tensor):
                ch = torch.from_numpy(np.array(ch))  # a memmap is read-only
            yield ch.to(self.device).to(self.dtype)


def _chunk_moments(t: torch.Tensor) -> torch.Tensor:
    """[mean, M2, min, max] per channel over (N, H, W) of one chunk, fp32 on
    the device, stacked for one fetch."""
    tf = t.float()
    mean = tf.mean((0, 1, 2))
    m2 = (tf - mean).square().sum((0, 1, 2))
    return torch.stack([mean, m2, tf.amin((0, 1, 2)), tf.amax((0, 1, 2))])


def collect_stats_streaming(params_dec: Dict, feats_host, style: StyleFeatures,
                            cfg: ModelConfig, chunk_size: int = 4,
                            mesh=None) -> SeqStats:
    """collect_stats over `feats_host` [N, h, w, 512] (a host array, memmap
    or CPU tensor) with O(chunk_size) device memory, on the device that holds
    the style features."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: ROADMAP.md Queue 1 item 7")
    device = style.map.device
    feed = _ChunkFeed(feats_host, chunk_size, cfg.dtype, device)
    norms: Dict[str, NormStats] = {}
    filters: Dict[str, torch.Tensor] = {}
    # The style side of the predictors is frame-independent.
    ns = (style.map - style.means[3]) / style.stds[3]

    with torch.inference_mode():
        for stage in STAGES:
            if stage in ("f1", "f2", "f3"):
                i = int(stage[1])
                ic = cfg.filter_channels
                for sub, pk in (("a", "p1"), ("b", "p2")):
                    fprm = params_dec[f"filter{i}"][pk]
                    pc = _pool_pred(fprm, feed, params_dec, style, norms,
                                    filters, cfg, stage)
                    ps = conv2d(fprm["down"], ns, padding=1).float() \
                        .mean((1, 2))
                    fc = {k: v.float() for k, v in fprm["fc"].items()}
                    f = linear(fc, torch.cat([pc, ps], dim=1))
                    filters[f"f{i}{sub}"] = f.reshape(-1, ic, ic)
                continue
            wf = None
            for ch in feed:
                t = _prefix_to(params_dec, ch, style, norms, filters, cfg,
                               stage)
                mean, m2, mn, mx = _chunk_moments(t).cpu().numpy()
                if wf is None:
                    wf = _Welford(mean.shape[0])
                wf.update(float(np.prod(t.shape[:3])), mean, m2, mn, mx)
            norms[stage] = wf.finalize(cfg.norm_eps, device)
    return SeqStats(norms, filters)


def _pool_pred(fprm: Dict, feed: _ChunkFeed, params_dec: Dict,
               style: StyleFeatures, norms: Dict, filters: Dict,
               cfg: ModelConfig, stage: str) -> torch.Tensor:
    """Pooled predictor-content vector for one FilterPredictor: the mean over
    all frames of the spatial mean of its own down conv, summed in fp64."""
    acc, cnt = 0.0, 0
    for ch in feed:
        h = _prefix_to(params_dec, ch, style, norms, filters, cfg, stage)
        pc = conv2d(fprm["down"], h, padding=1).float().mean((1, 2))
        acc = acc + pc.sum(0).cpu().numpy().astype(np.float64)
        cnt += pc.shape[0]
    return torch.as_tensor((acc / cnt)[None], dtype=torch.float32,
                           device=style.map.device)
