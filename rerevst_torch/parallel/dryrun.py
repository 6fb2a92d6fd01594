"""Dry runs of the multi-device layer at small shapes — the counterparts of
the JAX package's ``dryrun_multichip`` and
``dryrun_multichip_multiprocess``.

Each runs, over a mesh, one sharded train step (seeded weights with
he_relu VGGs, the default losses with a two-step relaxed loop, 64x64
crops, one sample per shard), sharded Pass 1
and Pass 2 over one frame per shard, and in one process an H-sharded
batch-1 Pass 2.  The data of global shard g is drawn from seed g whatever
the process layout, so a run over two processes and a run over two shards
of one process see the same global batch and can be compared.

    python -m rerevst_torch.parallel.dryrun [N] [--processes P]
        [--device cpu|cuda]

runs N shards in one process (N visible cards by default; logical shards
of the CPU with ``--device cpu``), or P processes joined through
``torch.distributed`` (NCCL when there is a card per process, else gloo
with every rank on ``cuda:0``; gloo on the CPU).  Like every entry point
of the port it runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from rerevst_torch.config import (
    LossConfig,
    ModelConfig,
    TrainConfig,
    resolve_device,
)
from rerevst_torch.models.transformer import (
    encode_content,
    encode_style,
    init_transformer_params,
)
from rerevst_torch.parallel.collectives import tree_to
from rerevst_torch.parallel.mesh import (
    Mesh,
    device_mesh,
    distributed_init,
    frame_mesh,
    process_device,
)
from rerevst_torch.parallel.pipeline import stylize_frames_sharded
from rerevst_torch.parallel.spatial import spatial_ok, stylize_spatial_sharded
from rerevst_torch.parallel.stats import collect_stats_sharded
from rerevst_torch.train.state import init_train_state, tree_leaves
from rerevst_torch.train.step import make_sharded_train_step

_REPO = Path(__file__).resolve().parent.parent.parent
_SIZE = 64


def _shard_data(g: int) -> Dict[str, torch.Tensor]:
    """Global shard g's content, style and frame, [1,64,64,3] each."""
    rng = np.random.default_rng(1000 + g)
    return {k: torch.from_numpy(
        (rng.standard_normal((1, _SIZE, _SIZE, 3)) * 0.5).astype(np.float32))
        for k in ("content", "style", "frame")}


def _digest(tree) -> List[float]:
    """Sum, sum of |x| and size of every leaf (a comparable fingerprint)."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else \
        ((None, t) for t in _flat(tree))
    return [v for _, t in leaves
            for v in (float(t.double().sum()), float(t.double().abs().sum()),
                      float(t.numel()))]


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [t for v in tree for t in _flat(v)]


def dryrun_body(mesh: Mesh, device) -> Dict:
    """The dry-run workload over `mesh` on `device` (this process's part):
    one sharded train step, sharded Pass 1 and Pass 2, and in one process an
    H-sharded batch-1 Pass 2.  Returns digests of what each produced."""
    dev = process_device(device)
    first = mesh.process_index * len(mesh.devices)
    data = [_shard_data(g) for g in range(first, first + len(mesh.devices))]
    content, style, frames = (torch.cat([d[k] for d in data]).to(dev)
                              for k in ("content", "style", "frame"))
    cfg = TrainConfig(model=ModelConfig(), loss=LossConfig(flow_iter=2))
    # he_relu VGG weights keep relu4_1's channels alive: with torch's
    # default init deep features shrink to ~1e-4, and the frozen rstd of
    # near-dead channels amplifies the rounding of any other sum order, so
    # two process layouts could not be compared.
    params = tree_to(init_transformer_params(
        torch.Generator().manual_seed(0), cfg.model, with_loss_net=True,
        vgg_scheme="he_relu"), dev)
    state = init_train_state(params, cfg)
    step = make_sharded_train_step(cfg, mesh)
    state, metrics = step(state, content, style,
                          torch.Generator(device=dev).manual_seed(3))
    if state.step != 1:
        raise RuntimeError(f"train step count {state.step}, want 1")
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise RuntimeError(f"metrics not finite: {bad}")

    mcfg = cfg.model
    with torch.inference_mode():
        # Global shard 0's style, on every process.
        sf = encode_style(params, _shard_data(0)["style"].to(dev), mcfg)
        feats = encode_content(params, frames, mcfg)
        stats = collect_stats_sharded(params["decoder"], feats, sf, mcfg,
                                      mesh)
        out = stylize_frames_sharded(params, frames, sf, stats, mcfg, mesh)
        if out.shape != frames.shape:
            raise RuntimeError(f"Pass 2 gave {tuple(out.shape)} for "
                               f"{tuple(frames.shape)}")
        res = {"loss": float(metrics["total"]),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "params": _digest({k: state.params[k]
                                  for k in ("encoder", "decoder")}),
               "stats": _digest(stats),
               "pass2_rows": [float(o.double().sum()) for o in out],
               "transport": mesh.transport}
        if mesh.process_count == 1 and spatial_ok(1, _SIZE, mesh):
            sp = stylize_spatial_sharded(params, frames[:1], sf, stats, mcfg,
                                         mesh)
            if sp.shape != frames[:1].shape or not bool(sp.isfinite().all()):
                raise RuntimeError("H-sharded Pass 2 gave no finite frame")
            res["spatial_vs_batch"] = float((sp - out[:1]).abs().max())
    return res


def dryrun_multichip(n_devices: int = 8, device="cuda") -> Dict:
    """The dry run over `n_devices` shards of one process: `n_devices`
    visible cards, or logical shards of the CPU with ``device="cpu"``."""
    device = resolve_device(device)
    mesh = device_mesh(n_devices, device)
    try:
        res = dryrun_body(mesh, device)
    finally:
        mesh.close()
    print(f"dryrun_multichip({n_devices}): train step + sharded two-pass OK; "
          f"total loss {res['loss']:.6f}; transport {res['transport']}",
          flush=True)
    return res


def _worker(process_id: int, num_processes: int, port: int, device: str,
            backend: str) -> None:
    """One process of ``dryrun_multichip_multiprocess``."""
    distributed_init(f"localhost:{port}", num_processes, process_id,
                     device=device, backend=backend)
    try:
        res = dryrun_body(frame_mesh(devices=[device]), device)
    finally:
        torch.distributed.destroy_process_group()
    print("DRYRUN " + json.dumps(res), flush=True)


def dryrun_multichip_multiprocess(n_processes: int = 2, device="cuda",
                                  timeout: float = 600) -> List[Dict]:
    """The multi-process dry run: `n_processes` processes on this host, each
    with one shard, joined through ``torch.distributed`` (on the card NCCL
    over distinct cards where there are enough, else gloo with every rank on
    ``cuda:0``; gloo with ``device="cpu"``).  Asserts that every process
    took the same step (loss and parameters equal); returns each process's
    digests.  Each process has `timeout` seconds."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= n_processes:
        backend = "nccl"
    with socket.socket() as s:  # a free rendezvous port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    procs = []
    for pid in range(n_processes):
        code = ("from rerevst_torch.parallel.dryrun import _worker; "
                f"_worker({pid}, {n_processes}, {port}, {str(dev)!r}, "
                f"{backend!r})")
        # Output to a file, not a pipe: a rank blocked on a full pipe would
        # stall its peers in a collective.
        log = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(_REPO), env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True)))
    outs = []
    try:
        for pid, (log, p) in enumerate(procs):
            p.wait(timeout=timeout)
            log.seek(0)
            out = log.read()
            if p.returncode != 0:
                raise RuntimeError(f"dry-run process {pid} failed "
                                   f"(rc={p.returncode}):\n{out}")
            outs.append(out)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for pid, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
        if not lines:
            raise RuntimeError(f"dry-run process {pid} printed no result:\n"
                               f"{out}")
        results.append(json.loads(lines[-1][len("DRYRUN "):]))
    for key in ("loss", "params"):
        if any(r[key] != results[0][key] for r in results):
            raise RuntimeError(f"processes disagree on the averaged step's "
                               f"{key}")
    print(f"dryrun_multichip_multiprocess({n_processes}): every process "
          f"agrees, loss {results[0]['loss']:.6f}; transport "
          f"{results[0]['transport']}", flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser("rerevst_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=8,
                   help="shards of one process")
    p.add_argument("--processes", type=int, default=0,
                   help="run this many processes of one shard each instead")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    if a.processes:
        dryrun_multichip_multiprocess(a.processes, a.device)
    else:
        dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
