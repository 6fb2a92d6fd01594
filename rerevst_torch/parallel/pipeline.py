"""Frame-parallel stylization (Pass 2 across shards) —
``rerevst_tpu/parallel/pipeline.py``.

Once the sequence statistics are frozen, Pass 2 is independent per frame:
the frame batch is split over the mesh's shards, the parameters, style and
statistics are replicated to each shard's device once (cached on the mesh),
and each shard runs ``encode_content`` + ``decode_global`` on its part.  No
collective runs in the hot loop.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from rerevst_torch.config import ModelConfig
from rerevst_torch.models.transformer import (
    SeqStats,
    StyleFeatures,
    blend_pytrees_batched,
    decode_global,
    encode_content,
)
from rerevst_torch.parallel.collectives import run_sharded, shard_batch
from rerevst_torch.parallel.mesh import (
    Mesh,
    lift_local,
    pad_to_multiple,
)


def stylize_frames_sharded(params: Dict, frames: torch.Tensor,
                           style: StyleFeatures, stats: SeqStats,
                           cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """Stylize a frame batch ([N,H,W,3] normalized RGB) with the batch axis
    split over `mesh`; returns [N,H,W,3] on the device of `frames`.  N is
    padded to a multiple of the shard count and cropped back.

    In a multi-process mesh `frames` is this process's LOCAL batch, which
    must divide over its shards (padding styled frames cannot be masked
    away); the call returns this process's rows."""
    if mesh.process_count > 1:
        frames = lift_local(mesh, frames, what="Pass 2 frame batch")
    n = frames.shape[0]
    padded, _ = pad_to_multiple(frames, len(mesh.devices))
    devs = mesh.devices

    def local(comm, x, p, s, st):
        f = encode_content(p, x, cfg, desaturate=True)
        return decode_global(p["decoder"], f, s, st, cfg)

    outs = run_sharded(local, mesh, shard_batch(padded, mesh),
                       [mesh.replica(params, d) for d in devs],
                       [mesh.replica(style, d) for d in devs],
                       [mesh.replica(stats, d) for d in devs])
    return torch.cat([o.to(frames.device) for o in outs])[:n]


def decode_blended_sharded(params: Dict, feats: torch.Tensor,
                           styles: Sequence[StyleFeatures],
                           stats: Sequence[SeqStats], weights,
                           cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """The multi-style batch decode with the batch split over `mesh`:
    `feats` [B,h,w,512] relu4_1 features, `weights` [B, n_styles], one blend
    per frame (``blend_pytrees_batched`` on each shard's rows).  Returns
    [B,H,W,3] on the device of `feats`."""
    w = np.asarray(weights, np.float32)
    n = feats.shape[0]
    fp, _ = pad_to_multiple(feats, len(mesh.devices))
    wp, _ = pad_to_multiple(w, len(mesh.devices))
    per = fp.shape[0] // len(mesh.devices)
    devs = mesh.devices

    def local(comm, f, rows, p, sts, sqs):
        sf = blend_pytrees_batched(sts, rows)
        st = blend_pytrees_batched(sqs, rows)
        return decode_global(p["decoder"], f, sf, st, cfg)

    outs = run_sharded(local, mesh, shard_batch(fp, mesh),
                       [wp[i * per:(i + 1) * per] for i in range(len(devs))],
                       [mesh.replica(params, d) for d in devs],
                       [mesh.replica(styles, d) for d in devs],
                       [mesh.replica(stats, d) for d in devs])
    return torch.cat([o.to(feats.device) for o in outs])[:n]
