"""Sharded sequence-statistics collection (Pass 1 across shards) —
``rerevst_tpu/parallel/stats.py``.

The frame axis of the sampled features is split over the mesh's shards and
every norm, extremum and filter reduction of ``collect_stats`` becomes a
``psum``/``pmin``/``pmax`` across them (``parallel/collectives.py``): no
concatenated batch on one device.
"""

from __future__ import annotations

from typing import Dict

import torch

from rerevst_torch.config import ModelConfig
from rerevst_torch.models.transformer import (
    SeqStats,
    StyleFeatures,
    collect_stats,
)
from rerevst_torch.parallel.collectives import run_sharded, shard_batch, \
    tree_to
from rerevst_torch.parallel.mesh import (
    Mesh,
    lift_local,
    pad_to_multiple,
)


def collect_stats_sharded(params_dec: Dict, feats: torch.Tensor,
                          style: StyleFeatures, cfg: ModelConfig,
                          mesh: Mesh) -> SeqStats:
    """collect_stats with the frame axis sharded over `mesh`; the result
    lands on the device of `feats`.

    Frames that pad the batch to a multiple of the shard count are masked
    out of every reduction, so the result matches the single-device
    unpadded collection up to fp reassociation.  In a multi-process mesh
    `feats` is this process's LOCAL batch, padded and masked locally
    (``lift_local``)."""
    if mesh.process_count > 1:
        feats, mask = lift_local(mesh, feats, pad=True)
    else:
        feats, mask = pad_to_multiple(feats, mesh.size)
    devs = mesh.devices

    def local(comm, x, m, p, s):
        return collect_stats(p, x, s, cfg,
                             reduce_fns=(comm.psum, comm.pmin, comm.pmax),
                             mask=m)

    out = run_sharded(local, mesh, shard_batch(feats, mesh),
                      shard_batch(mask, mesh),
                      [mesh.replica(params_dec, d) for d in devs],
                      [mesh.replica(style, d) for d in devs])
    return tree_to(out[0], feats.device)
