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

With a mesh, each chunk's frames split over the shards and the chunk's
reductions combine across them (``parallel/collectives.py``), the pad
frames masked out.

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
    _prec,
    content_dtype,
)
from rerevst_torch.parallel.collectives import run_sharded, tree_to
from rerevst_torch.parallel.mesh import Mesh, pad_to_multiple

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
    prec = _prec(cfg)
    if upto == "pre":
        return x
    h = _norm_apply(stats["pre"], x)
    for i in (1, 2, 3):
        if upto == f"f{i}":
            return h
        h = _kernel_filter_frozen(params_dec[f"filter{i}"], h,
                                  filters[f"f{i}a"], filters[f"f{i}b"], prec)
    for ada, m, s, res in (("ada4", m4, s4, "res4"), ("ada3", m3, s3, "res3"),
                           ("ada2", m2, s2, "res2")):
        if upto == ada:
            return h
        h = _norm_apply(stats[ada], h, s, m)
        p = params_dec[res]
        t = upsample2x_conv3x3(p["conv1"], h, prec)
        if upto == res + "a":
            return leaky_relu(t)
        t = conv2d(p["conv2"], _norm_apply(stats[res + "a"], t, leaky=True),
                   padding=1, precision=prec)
        if upto == res + "b":
            return leaky_relu(t)
        h = upsample2x_conv1x1(p["shortcut"], h, prec) \
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
    between stages), for the shards of `mesh` (one shard on one device
    without a mesh).  Each chunk goes up in one copy per shard and is cast
    on the device to the features' dtype (``content_dtype``) — lossless,
    the spooled fp32 values came from it.

    A chunk holds at least one frame per shard; it is padded on the host to
    a multiple of the shard count (repeating its last frame) and split over
    this process's shards: each iteration gives (per-shard chunks,
    per-shard masks), the masks None where the chunk needed no pad, else
    keeping the pad out of every reduction.  Every process of a
    multi-process mesh reads the same host array and takes its own shards'
    rows of each chunk."""

    def __init__(self, feats_host, chunk_size: int, dtype: torch.dtype,
                 mesh):
        self.feats = feats_host
        self.n = feats_host.shape[0]
        self.chunk = max(1, int(chunk_size), mesh.size)
        self.dtype = dtype
        self.mesh = mesh

    def __iter__(self) -> Iterator:
        mesh = self.mesh
        for i in range(0, self.n, self.chunk):
            ch = self.feats[i:i + self.chunk]
            if not isinstance(ch, torch.Tensor):
                ch = torch.from_numpy(np.array(ch))  # a memmap is read-only
            ch, mask = pad_to_multiple(ch, mesh.size)
            per = ch.shape[0] // mesh.size
            lo = mesh.process_index * len(mesh.devices) * per
            rows = [slice(lo + k * per, lo + (k + 1) * per)
                    for k in range(len(mesh.devices))]
            padded = bool((mask == 0).any())
            yield ([ch[r].to(d).to(self.dtype)
                    for r, d in zip(rows, mesh.devices)],
                   [mask[r].to(d) if padded else None
                    for r, d in zip(rows, mesh.devices)])


def _real(mask, x: torch.Tensor, fill: float) -> torch.Tensor:
    """`x` with its pad frames' values set to `fill` (where, not a
    product: a pad row's inf * 0 would be NaN); `x` itself where the chunk
    has no pad."""
    if mask is None:
        return x
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)) > 0, x,
                       fill)


def _frames(mask, x: torch.Tensor, comm) -> float:
    """The real frames of a chunk, over every shard."""
    if mask is None:
        return float(x.shape[0] * comm.size)
    return float(comm.psum(mask.sum()))


def _moments(t: torch.Tensor, p: Dict, mask, comm):
    """(mean, M2, min, max, count) per channel of one chunk's stage tensor
    `t` over (N, H, W) of every shard's real frames, fp32 on the device and
    fetched in one copy."""
    tf = t.float()
    cnt = _frames(mask, t, comm) * (t.shape[1] * t.shape[2])
    mean = comm.psum(_real(mask, tf, 0.0).sum((0, 1, 2))) / cnt
    m2 = comm.psum(_real(mask, (tf - mean).square(), 0.0).sum((0, 1, 2)))
    mn = comm.pmin(_real(mask, tf, float("inf")).amin((0, 1, 2)))
    mx = comm.pmax(_real(mask, tf, float("-inf")).amax((0, 1, 2)))
    mean, m2, mn, mx = torch.stack([mean, m2, mn, mx]).cpu().numpy()
    return mean, m2, mn, mx, cnt


def _pool_sums(i: int, pk: str, precision: str):
    """The chunk reduction of one FilterPredictor's pooled content: the sum
    over every shard's real frames of the spatial mean of its own down conv
    (fp64 on the host), and the frame count."""
    def reduce(h: torch.Tensor, p: Dict, mask, comm):
        pc = conv2d(p[f"filter{i}"][pk]["down"], h, padding=1,
                    precision=precision).float().mean((1, 2))
        s = comm.psum(_real(mask, pc, 0.0).sum(0))
        return s.cpu().numpy().astype(np.float64), _frames(mask, pc, comm)
    return reduce


def _chunk_results(feed: _ChunkFeed, params_dec: Dict, style: StyleFeatures,
                   norms: Dict, filters: Dict, cfg: ModelConfig, stage: str,
                   reduce):
    """`reduce` of each chunk's stage tensor, chunk by chunk; each chunk
    runs on every shard in lockstep, its reductions across the shards."""
    mesh = feed.mesh
    reps = [(mesh.replica(params_dec, d), mesh.replica(style, d),
             tree_to(norms, d), tree_to(filters, d)) for d in mesh.devices]

    def local(comm, x, m, rep):
        p, s, nm, fl = rep
        return reduce(_prefix_to(p, x, s, nm, fl, cfg, stage), p, m, comm)

    for chs, masks in feed:
        yield run_sharded(local, mesh, chs, masks, reps)[0]


def collect_stats_streaming(params_dec: Dict, feats_host, style: StyleFeatures,
                            cfg: ModelConfig, chunk_size: int = 4,
                            mesh=None) -> SeqStats:
    """collect_stats over `feats_host` [N, h, w, 512] (a host array, memmap
    or CPU tensor) with O(chunk_size) device memory, on the device that holds
    the style features.

    `mesh`: shard each chunk's frames over a mesh (``parallel/mesh.py``):
    each chunk's moments, extrema and pooled sums reduce across the shards,
    and the host's Welford merge across chunks is unchanged.  The chunks
    run in the dtype ``encode_content`` gives the features (fp32 under
    ``fp32_mix`` 'full' and 'body'), at the session's precision."""
    device = style.map.device
    prec = _prec(cfg)
    feed = _ChunkFeed(feats_host, chunk_size, content_dtype(cfg),
                      mesh or Mesh((device,)))
    norms: Dict[str, NormStats] = {}
    filters: Dict[str, torch.Tensor] = {}
    # The style side of the predictors is frame-independent.
    ns = (style.map - style.means[3]) / style.stds[3]

    def chunks(stage, reduce):
        return _chunk_results(feed, params_dec, style, norms, filters, cfg,
                              stage, reduce)

    with torch.inference_mode():
        for stage in STAGES:
            if stage in ("f1", "f2", "f3"):
                i = int(stage[1])
                ic = cfg.filter_channels
                for sub, pk in (("a", "p1"), ("b", "p2")):
                    fprm = params_dec[f"filter{i}"][pk]
                    # The pooled content: the mean over all frames, in fp64.
                    acc, cnt = 0.0, 0
                    for s, c in chunks(stage, _pool_sums(i, pk, prec)):
                        acc, cnt = acc + s, cnt + c
                    pc = torch.as_tensor((acc / cnt)[None],
                                         dtype=torch.float32, device=device)
                    ps = conv2d(fprm["down"], ns, padding=1,
                                precision=prec).float().mean((1, 2))
                    fc = {k: v.float() for k, v in fprm["fc"].items()}
                    f = linear(fc, torch.cat([pc, ps], dim=1))
                    filters[f"f{i}{sub}"] = f.reshape(-1, ic, ic)
                continue
            wf = None
            for mean, m2, mn, mx, cnt in chunks(stage, _moments):
                if wf is None:
                    wf = _Welford(mean.shape[0])
                wf.update(cnt, mean, m2, mn, mx)
            norms[stage] = wf.finalize(cfg.norm_eps, device)
    return SeqStats(norms, filters)
