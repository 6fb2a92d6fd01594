"""Intra-frame (H-sharded) Pass 2 with a hand-written halo exchange —
``rerevst_tpu/parallel/spatial.py``.

Batch sharding (``parallel/pipeline.py``) helps only when there are frames
to spread: a batch-1 frame, the latency point of serving, would use one
shard of the mesh.  This module shards the frame instead: its H rows split
over the shards, and where the JAX package lets GSPMD insert collective
permutes, each shard here runs the ordinary model under a thread-local halo
context (``ops/halo.py``).  Under frozen statistics every op of Pass 2 is
H-local except the 3x3 convolutions, the folded upsample conv and the
pair-lane conv, which take their boundary rows from the neighbouring shards
(``comm.exchange_rows``: zeros at a frame's edge), and the 2x2 max pools,
local while every shard holds an even number of rows at each pool.

Hybrid batch x H: for 1 < B < n the mesh folds to (B, n / B): shard k holds
rows ``k % (n / B)`` of frame ``k // (n / B)``.

``spatial_tiles`` is dropped under sharding, as in the JAX package: the
shards already bound each device's share of the working set.

A deliberate difference in the gate: ``spatial_ok`` also asks that every
shard hold a multiple of 8 rows, so that each holds whole rows of relu4_1
after the encoder's three pools.  GSPMD pads a shard that does not (h = 576
over 16 shards: 36 rows, 4.5 after the pools); a hand halo cannot, so such
a batch takes the batch-sharded path (B > 1) or runs on one device (B = 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from rerevst_torch.config import ModelConfig
from rerevst_torch.models.transformer import (
    SeqStats,
    StyleFeatures,
    blend_pytrees,
    blend_pytrees_batched,
    decode_global,
    encode_content,
)
from rerevst_torch.ops import halo
from rerevst_torch.parallel.collectives import run_sharded
from rerevst_torch.parallel.mesh import Mesh


def spatial_ok(batch: int, h: int, mesh: Mesh) -> bool:
    """Whether the H-sharded (or hybrid batch x H) Pass 2 applies to a
    [batch, h, W, 3] frame batch: a single-process mesh, the shard count
    folds over (batch, H rows), and every H shard holds a multiple of 8
    rows (whole relu4_1 rows: see the module's docstring)."""
    n = mesh.size
    if n <= 1 or mesh.process_count > 1:
        return False
    if batch >= n or n % batch:
        return False
    rows = n // batch
    return h % rows == 0 and h // rows >= 8 and (h // rows) % 8 == 0


def spatial_feats_ok(batch: int, fh: int, mesh: Mesh) -> bool:
    """``multistyle_decode_spatial`` applicability: like ``spatial_ok`` for
    a relu4_1 FEATURE map of `fh` rows (the decoder has no pool): every H
    shard keeps >= 2 feature rows."""
    n = mesh.size
    if n <= 1 or mesh.process_count > 1:
        return False
    if batch >= n or n % batch:
        return False
    rows = n // batch
    return fh % rows == 0 and (fh // rows) >= 2


def _untiled(cfg: ModelConfig) -> ModelConfig:
    if cfg.spatial_tiles > 1:
        return dataclasses.replace(cfg, spatial_tiles=1)
    return cfg


def _slabs(x: torch.Tensor, mesh: Mesh, rows: int) -> List[torch.Tensor]:
    """Shard k's slab: rows block ``k % rows`` of frame ``k // rows``."""
    hl = x.shape[1] // rows
    return [x[k // rows:k // rows + 1, (k % rows) * hl:(k % rows + 1) * hl]
            .contiguous().to(dev) for k, dev in enumerate(mesh.devices)]


def _gather(outs: Sequence[torch.Tensor], rows: int,
            device: torch.device) -> torch.Tensor:
    outs = [o.to(device) for o in outs]
    return torch.cat([torch.cat(outs[b:b + rows], 1)
                      for b in range(0, len(outs), rows)])


def stylize_spatial_sharded(params: Dict, frames: torch.Tensor,
                            style: StyleFeatures, stats: SeqStats,
                            cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """Stylize `frames` [B,H,W,3] with H (and, for B > 1, the batch too)
    sharded over `mesh`; returns [B,H,W,3] on the device of `frames`.  Call
    only when ``spatial_ok(B, H, mesh)``."""
    cfg = _untiled(cfg)
    rows = mesh.size // frames.shape[0]
    devs = mesh.devices

    def local(comm, x, p, s, st):
        with halo.h_sharded(comm.exchange_rows):
            f = encode_content(p, x, cfg, desaturate=True)
            return decode_global(p["decoder"], f, s, st, cfg)

    outs = run_sharded(local, mesh, _slabs(frames, mesh, rows),
                       [mesh.replica(params, d) for d in devs],
                       [mesh.replica(style, d) for d in devs],
                       [mesh.replica(stats, d) for d in devs],
                       h_shards=rows)
    return _gather(outs, rows, frames.device)


def multistyle_decode_spatial(params: Dict, feats: torch.Tensor,
                              styles: Sequence[StyleFeatures],
                              stats: Sequence[SeqStats], weights,
                              cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """Multi-style blended decode with the FEATURE map's H axis (and, for
    B > 1, the batch) sharded over `mesh`.  `weights`: [S] (one blend for
    the batch) or [B, S] (a blend per frame, sharded with the batch).
    Returns [B,H,W,3] on the device of `feats`.  Call only when
    ``spatial_feats_ok``."""
    cfg = _untiled(cfg)
    per_frame = np.ndim(weights) == 2
    rows = mesh.size // feats.shape[0]
    devs = mesh.devices

    def local(comm, f, row, p, sts, sqs):
        if per_frame:
            sf, st = blend_pytrees_batched(sts, row), \
                blend_pytrees_batched(sqs, row)
        else:
            sf, st = blend_pytrees(sts, weights), blend_pytrees(sqs, weights)
        with halo.h_sharded(comm.exchange_rows):
            return decode_global(p["decoder"], f, sf, st, cfg)

    w = np.asarray(weights, np.float32)
    blend_rows = [w[k // rows:k // rows + 1] if per_frame else None
                  for k in range(len(devs))]
    outs = run_sharded(local, mesh, _slabs(feats, mesh, rows), blend_rows,
                       [mesh.replica(params, d) for d in devs],
                       [mesh.replica(styles, d) for d in devs],
                       [mesh.replica(stats, d) for d in devs],
                       h_shards=rows)
    return _gather(outs, rows, feats.device)
