"""The device mesh — ``rerevst_tpu/parallel/mesh.py`` on ``torch.distributed``.

The workload is frame- and batch-parallel, so the mesh is one axis of
shards.  ``Mesh`` is a small frozen value: this process's shard devices, the
``torch.distributed`` group that joins the processes (or None), and this
process's index and the process count.  A mesh's shards run in lockstep on
worker threads that the mesh owns (``parallel/collectives.py``).

Two deliberate differences from the JAX package:

* a multi-process mesh has one device per process (one rank per card, the
  torch idiom); JAX allows several per process;
* torch has no global array, so ``lift_local`` returns the local batch (a
  process's shard *is* what it holds), padded and masked as JAX pads it.

``frame_mesh(n, devices=[...])`` may name one device several times: the
shards are then logical shards of that device (the CPU, or one card), which
is how the CPU tests and a one-card run drive every sharded path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of shards: ``devices`` are this process's (a device may
    repeat); ``group`` joins ``process_count`` processes, or is None in one
    process."""
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.process_count > 1 and len(self.devices) != 1:
            raise ValueError(
                f"a multi-process mesh has one device per process; got "
                f"{len(self.devices)} in process {self.process_index}")

    @property
    def size(self) -> int:
        """Shards over every process."""
        return len(self.devices) * self.process_count

    @property
    def transport(self) -> str:
        """How the shards' collectives travel: 'threads' within one
        process; across processes the group's backend, and for gloo with
        CUDA tensors 'gloo-host' (staged through host memory)."""
        if self.group is None:
            return "threads"
        backend = dist.get_backend(self.group)
        if backend == "gloo" and self.devices[0].type == "cuda":
            return "gloo-host"
        return backend

    def workers(self):
        """The mesh's shard workers (created at first use, live as long as
        the mesh)."""
        from rerevst_torch.parallel.collectives import ShardWorkers

        pool = self.__dict__.get("_workers")
        if pool is None:
            pool = ShardWorkers(self)
            object.__setattr__(self, "_workers", pool)
        return pool

    def replica(self, tree, device: torch.device, make=None, fresh=None):
        """`tree` on `device`, made once per tree and device and cached on
        the mesh.  By default `tree` is nested dicts, tuples and tensors,
        copied with ``tree_to`` (a tree already there is returned as is);
        `make(tree, device)` builds another kind of replica, and a cached
        one for which `fresh(replica)` is false is built anew (the replica
        of a state that changes)."""
        from rerevst_torch.parallel.collectives import tree_to

        cache = self.__dict__.setdefault("_replicas", {})
        key = (id(tree), str(device))
        hit = cache.get(key)
        if hit is not None and hit[0] is tree and (fresh is None
                                                   or fresh(hit[1])):
            return hit[1]
        rep = (make or tree_to)(tree, device)
        if len(cache) >= 32:  # trees of finished sessions or clips
            cache.pop(next(iter(cache)))
        cache[key] = (tree, rep)  # holding `tree` keeps its id unique
        return rep

    def close(self) -> None:
        """Stop the worker threads."""
        pool = self.__dict__.pop("_workers", None)
        if pool is not None:
            pool.close()


def distributed_init(coordinator: str, num_processes: int, process_id: int,
                     device="cuda", backend: Optional[str] = None) -> None:
    """Multi-process init: ``torch.distributed.init_process_group`` at
    ``tcp://{coordinator}`` with the world size and rank given here; the
    ``nccl`` backend for a CUDA device and ``gloo`` for the CPU, unless
    `backend` names one (two ranks on one card need gloo: NCCL refuses two
    ranks on one GPU).  Under NCCL the rank takes card
    ``process_id % device_count``.  No-op for ``num_processes <= 1``."""
    if num_processes <= 1:
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_device(device="cuda") -> torch.device:
    """`device` with its index: a bare ``cuda`` is this process's current
    card (in a multi-process run, the one ``distributed_init`` set)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def frame_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over (the first `n_devices` of) `devices`, by default every
    visible card.

    After ``distributed_init`` the mesh spans the processes, one device per
    process: this process's card (or `devices[0]`), and `n_devices`, if
    given, must be the world size.  In one process `n_devices` may not
    exceed the visible cards unless `devices` names the devices; a device
    named several times gives logical shards of it."""
    if multi_process():
        world = dist.get_world_size()
        if n_devices not in (None, 0, world):
            raise ValueError(f"a multi-process mesh has one device per "
                             f"process: {world} shards, not {n_devices}")
        dev = process_device(devices[0] if devices else "cuda")
        return Mesh((dev,), dist.group.WORLD, dist.get_rank(), world)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices and n_devices > count:
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} visible "
                f"cards; {count} visible (name the devices to shard one "
                f"device logically: frame_mesh(n, devices=[...]))")
        if count == 0:
            raise RuntimeError("no visible card for the mesh; pass devices=")
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = [process_device(d) for d in devices]
    if n_devices:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} devices from "
                             f"{len(devs)} named")
        devs = devs[:n_devices]
    return Mesh(tuple(devs))


def device_mesh(n_devices: int, device="cuda") -> Mesh:
    """The CLIs' mesh for ``--devices N`` (or ``--data_parallel N``) on
    ``--device``: in a multi-process run the processes' mesh; on the CPU N
    logical shards; on the card N visible cards, or a raise."""
    dev = torch.device(device)
    if multi_process():
        return frame_mesh(n_devices or None, devices=[process_device(dev)])
    if dev.type == "cpu":
        return frame_mesh(n_devices, devices=[dev] * n_devices)
    return frame_mesh(n_devices)


def multi_process() -> bool:
    """Whether ``distributed_init`` joined this process to others."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def mesh_process_count(mesh: Mesh) -> int:
    """Number of processes owning this mesh's shards (``mesh.process_count``,
    under the JAX package's name)."""
    return mesh.process_count


def local_device_count_in(mesh: Mesh) -> int:
    """This process's shard count within `mesh` (``len(mesh.devices)``,
    under the JAX package's name)."""
    return len(mesh.devices)


def pad_to_multiple(x, mult: int, axis: int = 0):
    """Pad `x` along `axis` (repeating the last slice) to a multiple of
    `mult`; returns (padded, valid_mask [padded_len] fp32).  numpy in,
    numpy out; a tensor in, tensors out on its device."""
    n = x.shape[axis]
    pad = (-n) % mult
    if isinstance(x, np.ndarray):
        mask = np.concatenate([np.ones((n,), np.float32),
                               np.zeros((pad,), np.float32)])
        if pad:
            last = np.take(x, [n - 1], axis=axis)
            x = np.concatenate([x] + [last] * pad, axis=axis)
        return x, mask
    mask = torch.cat([torch.ones((n,), dtype=torch.float32, device=x.device),
                      torch.zeros((pad,), dtype=torch.float32,
                                  device=x.device)])
    if pad:
        last = x.narrow(axis, n - 1, 1)
        x = torch.cat([x] + [last] * pad, dim=axis)
    return x, mask


def lift_local(mesh: Mesh, x, *, pad: bool = False, what: str = "batch"):
    """This process's LOCAL batch-axis array, ready for its shards of
    `mesh` (call when ``mesh.process_count > 1``).  Padding happens
    locally, to this process's device multiple:

    - ``pad=True``: pad (repeating the last slice) and return ``(x, mask)``
      — the mask keeps pad rows out of every downstream reduction
      (inference statistics);
    - ``pad=False``: return ``x``, raising ValueError on a non-divisible
      local batch (training, where silent padding would bias the averaged
      gradients)."""
    per = len(mesh.devices)
    if pad:
        return pad_to_multiple(x, per, axis=0)
    if x.shape[0] % per:
        raise ValueError(
            f"multi-host {what} must be divisible by this process's "
            f"{per} mesh devices; got {x.shape[0]}")
    return x
