"""Running a function once per shard, in lockstep — the port's counterpart
of ``shard_map`` with ``psum``/``pmin``/``pmax``/``pmean`` and the
collective-permute of a halo exchange.

``run_sharded(fn, mesh, *per_shard_args)`` calls ``fn(comm, *args_i)`` for
each local shard i of `mesh`, on the mesh's worker thread for that shard
(one persistent thread per local shard, created with the mesh's first run
and living as long as the mesh: cuDNN makes its plans per thread, so new
threads per call would plan anew every time).  Each thread runs on its
shard's device and that device's default stream, with the caller's grad and
inference modes.  A mesh with one local shard runs ``fn`` on the caller's
thread.

``comm`` gives the collectives, each a rendezvous of every local shard:

* ``psum``/``pmin``/``pmax``/``pmean`` of a tensor or a list of tensors.
  Within the process each shard combines every shard's partial in shard
  order (0, 1, ...), so every shard gets the same bits whatever the
  threads' timing; across processes the combined value then goes through
  ``torch.distributed.all_reduce`` (SUM, MIN or MAX) on the mesh's group.
* ``exchange_rows(x, halo)``: `x` [B,h,W,C] with `halo` boundary rows of
  the shards above and below attached, zeros at a frame's edge; the shards
  of one frame are ``h_shards`` consecutive shards.

The transport is chosen by the group's backend: under NCCL the tensors stay
on the card; under gloo a CUDA tensor is staged through host memory here,
in this module only (``Mesh.transport`` names which ran).  A shard that
raises breaks the rendezvous, so the others stop too, and the first error
is raised to the caller.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def tree_to(tree, device: torch.device):
    """Nested dicts, tuples, NamedTuples and tensors with every tensor on
    `device` (a tensor already there is not copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [tree_to(v, device) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree


def shard_batch(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Split `x` along axis 0 into the mesh's local shards, each on its
    shard's device; the length must divide evenly."""
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


class _Round:
    """The shared state of one ``run_sharded`` call."""

    def __init__(self, mesh, h_shards: int):
        self.mesh = mesh
        self.n = len(mesh.devices)
        self.h_shards = h_shards
        self.slots: List[List] = [[None] * self.n, [None] * self.n]
        self.turns = [0] * self.n
        self.barrier = threading.Barrier(self.n)

    def _share(self, i: int, value) -> List:
        """Deposit shard i's value and wait for every shard's; returns the
        slots.  Successive collectives alternate between two slot sets: a
        shard reaches the set again only after every shard has passed the
        next collective's barrier, so after every shard has read this one,
        and one barrier per collective suffices."""
        slots = self.slots[self.turns[i] & 1]
        self.turns[i] += 1
        slots[i] = value
        self.barrier.wait()
        return slots

    def reduce(self, i: int, x, op: str):
        leaves = list(x) if isinstance(x, (list, tuple)) else [x]
        if self.n > 1:
            dev = self.mesh.devices[i]
            slots = self._share(i, leaves)
            fn = _OPS[op]
            out = []
            for j in range(len(leaves)):
                acc = slots[0][j].to(dev)
                for k in range(1, self.n):
                    acc = fn(acc, slots[k][j].to(dev))
                out.append(acc)
            leaves = out
        if self.mesh.group is not None:
            leaves = _all_reduce(leaves, op, self.mesh)
        return leaves if isinstance(x, (list, tuple)) else leaves[0]

    def exchange_rows(self, i: int, x: torch.Tensor, halo: int
                      ) -> torch.Tensor:
        if self.mesh.group is not None:
            raise ValueError("H sharding runs within one process")
        dev = self.mesh.devices[i]
        pos = i % self.h_shards
        slots = self._share(i, x)
        edge = (x.shape[0], halo) + tuple(x.shape[2:])
        top = (slots[i - 1][:, -halo:].to(dev) if pos > 0
               else x.new_zeros(edge))
        bot = (slots[i + 1][:, :halo].to(dev)
               if pos < self.h_shards - 1 else x.new_zeros(edge))
        return torch.cat([top, x, bot], 1)


def _all_reduce(leaves: List[torch.Tensor], op: str, mesh
                ) -> List[torch.Tensor]:
    """All-reduce across the mesh's processes, one call per dtype: the
    leaves of a dtype travel as one flat buffer, on the card under NCCL and
    through host memory under gloo."""
    rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    staged = mesh.transport == "gloo-host"
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [j for j, t in enumerate(leaves) if t.dtype == dtype]
        flat = torch.cat([leaves[j].reshape(-1) for j in idx])
        buf = flat.cpu() if staged else flat.clone()
        dist.all_reduce(buf, rop, group=mesh.group)
        buf = buf.to(flat.device)
        at = 0
        for j in idx:
            k = leaves[j].numel()
            out[j] = buf[at:at + k].reshape(leaves[j].shape)
            at += k
    return out


class Comm:
    """One shard's handle on a ``run_sharded`` call: its local ``index``,
    ``global_index`` and ``device``, the mesh ``size`` (every process's
    shards), and the collectives."""

    def __init__(self, rnd: _Round, index: int):
        self._rnd = rnd
        self.index = index
        mesh = rnd.mesh
        self.device = mesh.devices[index]
        self.global_index = mesh.process_index * len(mesh.devices) + index
        self.size = mesh.size

    def psum(self, x):
        return self._rnd.reduce(self.index, x, "sum")

    def pmin(self, x):
        return self._rnd.reduce(self.index, x, "min")

    def pmax(self, x):
        return self._rnd.reduce(self.index, x, "max")

    def pmean(self, x):
        s = self.psum(x)
        if isinstance(s, list):
            return [t / self.size for t in s]
        return s / self.size

    def exchange_rows(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        return self._rnd.exchange_rows(self.index, x, halo)


def _device_context(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class ShardWorkers:
    """One worker thread per local shard of a mesh (none for a mesh of one
    local shard); ``run`` hands each its part of one call."""

    def __init__(self, mesh):
        self.mesh = mesh
        n = len(mesh.devices)
        self._lock = threading.Lock()  # one call at a time on the threads
        self._queues: List[queue.SimpleQueue] = []
        self._threads: List[threading.Thread] = []
        if n > 1:
            for i in range(n):
                self._queues.append(queue.SimpleQueue())
                t = threading.Thread(target=self._loop, args=(i,),
                                     name=f"rerevst-shard-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    def _loop(self, i: int) -> None:
        dev = self.mesh.devices[i]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.set_stream(torch.cuda.default_stream(dev))
        q = self._queues[i]
        while True:
            job = q.get()
            if job is None:
                return
            job()

    def run(self, fn: Callable, per_shard_args: Sequence[tuple],
            h_shards: int = 1) -> list:
        n = len(self.mesh.devices)
        rnd = _Round(self.mesh, h_shards)
        if n == 1:
            with _device_context(self.mesh.devices[0]):
                return [fn(Comm(rnd, 0), *per_shard_args[0])]
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        futures = [Future() for _ in range(n)]

        def job(i):
            def call():
                try:
                    mode = (torch.inference_mode() if inference
                            else torch.set_grad_enabled(grad))
                    with mode:
                        futures[i].set_result(
                            fn(Comm(rnd, i), *per_shard_args[i]))
                except BaseException as e:  # noqa: BLE001 — handed over
                    rnd.barrier.abort()     # release the waiting shards
                    futures[i].set_exception(e)
            return call

        with self._lock:
            for i in range(n):
                self._queues[i].put(job(i))
            errors = [f.exception() for f in futures]
        first = next((e for e in errors
                      if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return [f.result() for f in futures]

    def close(self) -> None:
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=60)


def run_sharded(fn: Callable, mesh, *per_shard_args: Sequence,
                h_shards: int = 1) -> list:
    """``[fn(comm_i, *(a[i] for a in per_shard_args)) for each local
    shard i]``, the shards in lockstep on the mesh's workers; `h_shards`
    consecutive shards hold the H slabs of one frame
    (``comm.exchange_rows``)."""
    n = len(mesh.devices)
    for a in per_shard_args:
        if len(a) != n:
            raise ValueError(f"per-shard argument of length {len(a)} for "
                             f"{n} local shards")
    if n % h_shards:
        raise ValueError(f"{h_shards} H shards per frame do not divide "
                         f"{n} shards")
    args = [tuple(a[i] for a in per_shard_args) for i in range(n)]
    return mesh.workers().run(fn, args, h_shards)
