#!/usr/bin/env python3
"""Where the time of the in-process mesh goes on several cards, against one
card and against one process per card.

    python3 scripts/mesh_scaling.py [--rounds 5] [--iters 10]

On whatever cards the machine has (up to 4):

* Pass 2, the global f16 session of ``chip_smoke.py`` (bundled checkpoint,
  seeded 512x512 style and clip, one batch of 16 padded to 640x640): the
  unmeshed session on ``cuda:0``, then ``stylize_frames_sharded`` over the
  first 2 and 4 cards (one thread per card), in turns for ``--rounds``
  rounds; each round the median wall milliseconds of ``--iters``
  synchronized calls, and the host's load average.  Beside them, one
  shard's share (16 / n frames) alone on ``cuda:0``: its device ms and its
  host enqueue ms (``chip_smoke.time_ms``).  While the threads hold the
  GIL in turn, a call over n cards takes at least n times one share's
  enqueue.
* The data-parallel train step, ``TrainConfig()`` (every default loss) at
  batch 4 of 256x256 from the bundled checkpoint: one card
  (``make_train_step``), the in-process mesh over 2 (and 4) cards, and 2
  (and 4) processes of one card each joined through NCCL
  (``distributed_init``); median wall ms of 5 steps after one.

Prints one JSON line per measurement, the card's name and power limit
first; the ranks run as ``--rank i --world n --port p`` of this script.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TRAIN_STEPS = 5


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def _wall_ms(fn, devices, iters: int) -> float:
    """Median wall ms of `iters` calls, each synchronized on `devices`."""
    fn()
    _sync(devices)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def pass2(rounds: int, iters: int) -> None:
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.parallel import frame_mesh
    from rerevst_torch.parallel.pipeline import stylize_frames_sharded

    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    base = Stylization(ckpt, cfg=ModelConfig(dtype=torch.float16),
                       device="cuda")
    base.prepare_style(cs.synth_style(cs.CONTENT, cs.CONTENT, seed=1))
    clip = cs.synth_clip(cs.CLIP_FRAMES, cs.CONTENT, cs.CONTENT, seed=0)
    list(base.stylize_video(clip, batch_size=cs.BATCH))
    x = base._upload(base._prep_batch_host(clip[:cs.BATCH]))
    count = min(torch.cuda.device_count(), 4)
    cards = [torch.device("cuda", i) for i in range(count)]
    meshes = {n: frame_mesh(n, devices=cards[:n]) for n in (2, 4)
              if n <= count}
    runs = {1: (lambda: base._stylize(x), cards[:1])}
    for n, mesh in meshes.items():
        runs[n] = ((lambda mesh=mesh: stylize_frames_sharded(
            base.params, x, base.style, base.stats, base.cfg, mesh)),
            mesh.devices)
    with torch.inference_mode():
        shares = {}
        for n in runs:
            share = x[:cs.BATCH // n]
            t = cs.time_ms(torch, lambda share=share: base._stylize(share),
                           iters=iters, warmup=2)
            shares[n] = {"frames": share.shape[0], "device_ms": t["ms"],
                         "host_enqueue_ms": t["host_ms"]}
        _emit({"pass2_share_alone_on_cuda0": shares})
        table = {n: [] for n in runs}
        for r in range(rounds):
            row = {"round": r, "loadavg_1min": os.getloadavg()[0]}
            for n, (fn, devs) in runs.items():
                ms = _wall_ms(fn, devs, iters)
                table[n].append(ms)
                row[f"{n}_cards_ms"] = ms
            _emit({"pass2_round": row})
    _emit({"pass2_f16_batch16": {
        f"{n}_cards": {"median_ms": statistics.median(v), "min_ms": min(v),
                       "max_ms": max(v),
                       "n_times_share_enqueue_ms":
                           n * shares[n]["host_enqueue_ms"],
                       "share_device_ms": shares[n]["device_ms"]}
        for n, v in table.items()}})
    for mesh in meshes.values():
        mesh.close()


def _train_setup(dev):
    from rerevst_torch.config import TrainConfig
    from rerevst_torch.train.state import init_train_state

    cfg = TrainConfig()
    host, _ = cs.train_host_params(torch)
    batch = cs.train_batches(1, 4, 256, seed=700)[0]
    c, s = (torch.from_numpy(batch[k]) for k in ("Content", "Style"))
    return cfg, init_train_state(cs._tree_to(host, dev), cfg), c, s


def _steps_ms(step, state, c, s, gen, devices, barrier=None):
    times, loss = [], None
    for i in range(TRAIN_STEPS + 1):
        if barrier is not None:
            barrier()
        _sync(devices)
        t0 = time.perf_counter()
        state, m = step(state, c, s, gen)
        loss = float(m["total"])
        _sync(devices)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, loss


def train() -> None:
    from rerevst_torch.parallel import frame_mesh
    from rerevst_torch.train.step import make_sharded_train_step, \
        make_train_step

    dev = torch.device("cuda", 0)
    count = min(torch.cuda.device_count(), 4)
    cfg, state, c, s = _train_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    med, times, loss = _steps_ms(make_train_step(cfg), state, c.to(dev),
                                 s.to(dev), gen, [dev])
    _emit({"train_step": {"layout": "1 card", "median_ms": med,
                          "steps_ms": times, "loss": loss}})
    for n in (2, 4):
        if n > count:
            continue
        mesh = frame_mesh(n, devices=[torch.device("cuda", i)
                                      for i in range(n)])
        cfg, state, _, _ = _train_setup(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
        med, times, loss = _steps_ms(make_sharded_train_step(cfg, mesh),
                                     state, c.to(dev), s.to(dev), gen,
                                     mesh.devices)
        mesh.close()
        _emit({"train_step": {"layout": f"{n} cards, one process (threads)",
                              "median_ms": med, "steps_ms": times,
                              "loss": loss}})
        med, times, loss = _ranks(n)
        _emit({"train_step": {"layout": f"{n} cards, {n} processes (NCCL)",
                              "median_ms": med, "steps_ms": times,
                              "loss": loss}})


def _ranks(n: int):
    """The train step over `n` processes of one card each: rank 0's
    (median, steps, loss)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(i), "--world", str(n),
         "--port", str(port)], stdout=subprocess.PIPE, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise SystemExit(f"rank failed (rc {p.returncode})")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    if any(r["loss"] != res[0]["loss"] for r in res):
        raise SystemExit(f"ranks disagree: {[r['loss'] for r in res]}")
    return res[0]["median_ms"], res[0]["steps_ms"], res[0]["loss"]


def rank_main(rank: int, world: int, port: int) -> None:
    from rerevst_torch.parallel import distributed_init, frame_mesh
    from rerevst_torch.train.step import make_sharded_train_step

    distributed_init(f"localhost:{port}", world, rank, device="cuda")
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = frame_mesh(world, devices=[dev])
        cfg, state, c, s = _train_setup(dev)
        per = c.shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
        med, times, loss = _steps_ms(
            make_sharded_train_step(cfg, mesh), state, c[rows].to(dev),
            s[rows].to(dev), gen, [dev],
            barrier=torch.distributed.barrier)
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"median_ms": med, "steps_ms": times, "loss": loss}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_scaling: CUDA is not available", file=sys.stderr)
        return 2
    if a.rank is not None:
        rank_main(a.rank, a.world, a.port)
        return 0
    from rerevst_torch.kernels import _build

    _build.library()
    _emit({"card": cs.nvidia_smi(), "device_count": torch.cuda.device_count(),
           "cpu_count": os.cpu_count()})
    pass2(a.rounds, a.iters)
    train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
