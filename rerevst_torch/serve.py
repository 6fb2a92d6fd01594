"""HTTP video-stylization service — ``rerevst_tpu/serve.py`` for the port.

    python -m rerevst_torch.serve --checkpoint model.msgpack --port 8787
    python -m rerevst_torch.serve --checkpoint model.msgpack --device cpu

The same routes, status codes, error JSON, caps, counters and flags as
``rerevst_tpu.serve``, plus ``--device`` (the card by default).

Endpoints (image payloads are encoded images — png/jpg — as request bodies;
they need OpenCV, and answer 500 with the ImportError where it is missing):

  GET  /healthz            -> {"ok": true, "device": ..., "has_style",
                              "has_stats"}
  GET  /metrics            Prometheus text: uptime, per-endpoint request
                           counters, open clip sessions, micro-batch totals
  POST /style              set the style image; resets sequence state
  POST /pass1?last=0|1     feed a sampled frame to Pass 1 (global stats);
                           last=1 finalizes (compute())
  POST /stylize            stylize one frame -> image bytes (Pass 2)
  POST /video?interval=N   whole clip in one request (N frames as a .npz
                           body), returns stylized frames as an .npz

Multi-style interpolation (the reference's ``Multi-style Interpolation/``
variant as a service):

  POST /styles             .npz of N pre-sized style images -> blended session
  POST /interpolate        .npz of frames (+ optional "weights"
                           [n_frames, n_styles] array; default linear sweep)
                           -> .npz of stylized frames

Clips larger than the body cap use the chunked clip-session protocol (every
request and response stays under the cap; the server spools each frame to
disk as ``.npy`` and runs the two-pass pipeline over the spool, so server
RAM stays bounded too):

  POST /clip/open?interval=N          -> {"clip": token}
  POST /clip/<token>/frames           .npz chunk of frames -> {"received": n}
  POST /clip/<token>/finish           run the two-pass pipeline -> {"frames": n}
       ...?async=1                    202 + background run (a long clip
                                      would hold one request open for
                                      minutes); poll /status, /result 409s
                                      until done
  GET  /clip/<token>/status           {"status", "progress", "done", "error"}
  GET  /clip/<token>/result?start=S&count=C  -> .npz of stylized frames [S, S+C)
  POST /clip/<token>/close            delete the session's spool

Concurrency: ONE ``Stylization`` session per process, and every call into it
serialized through a lock and run on ONE device thread.  The server accepts
connections on threads (a new one per request), so health checks and error
replies stay responsive during long video requests, but stylization never
runs concurrently (one card, one stream of work), and never on the request's
own thread: PyTorch keeps cuDNN's execution plans and handle per thread, so
a request served on a fresh thread would build the plan of every conv shape
anew.  Scale by running one process per card and sharding clips across them
(Pass 2 is embarrassingly parallel, so any frame-level load balancing is
correct).

Hardening: request bodies are capped (``--max-body-mb``, HTTP 413), clip
length is capped (``--max-frames``), per-connection socket timeouts bound
stuck clients, and every error returns structured JSON (``{"error":
{"type", "message"}}``) — 400 for bad payloads, 409 for protocol-state
violations (e.g. /stylize before /style), 500 (logged with traceback) for
anything unexpected.

``--aot`` serves global-mode Pass 2 from an AOT bundle (``convert
--export-aot``; ``io/aot.py``) where geometry and batch match, and
``--tiles`` runs the full-resolution regions over H-slabs
(``ops/tiling.py``), and ``--mix`` runs a region of a 16-bit session with
fp32 storage (``ModelConfig.fp32_mix``; 'out', 'res2', 'dec' and 'full'
stylize into fp32 before the uint8 conversion).
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
import traceback
import uuid
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig, ModelConfig, dtype_from_name
from rerevst_torch.data.source import NpySource
from rerevst_torch.data.video import require_cv2

DEFAULT_MAX_BODY_MB = 64
DEFAULT_MAX_FRAMES = 2048

_NO_CV2 = "send frames to /video, /clip/* or /interpolate as .npz bodies"


def _imdecode(buf: bytes) -> np.ndarray:
    cv2 = require_cv2("the image endpoints (/style, /pass1, /stylize)",
                      _NO_CV2)
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("undecodable image payload")
    return img


def _imencode(img_bgr: np.ndarray, ext: str = ".png") -> bytes:
    cv2 = require_cv2("the image endpoints (/style, /pass1, /stylize)",
                      _NO_CV2)
    ok, buf = cv2.imencode(ext, img_bgr)
    if not ok:
        raise ValueError("encode failed")
    return buf.tobytes()


def _bucket(n: int, max_batch: int) -> int:
    """The batch size a group of `n` coalesced frames runs at: the next power
    of 2, capped at `max_batch`."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return min(bucket, max_batch)


class _MicroBatcher:
    """Dynamic request coalescing for single-frame stylize calls.

    Concurrent /stylize requests land on separate handler threads; each
    would pay a batch-1 Pass-2 call, where one batched call costs the card
    less per frame (PERF.md section 6 has its numbers).  A worker thread
    drains the queue: it waits up to `window_s` after the FIRST queued
    request for company, groups what arrived by frame shape (geometry is a
    per-clip contract), and runs ONE batched call per group.  A lone
    request under no load pays only its own latency + the window.
    """

    #: liveness-poll period while a submitter waits on its result.
    WAIT_POLL_S = 30.0

    def __init__(self, fn, window_s: float = 0.005, max_batch: int = 8):
        self.fn = fn  # (list[frame], pad_to) -> list[styled frame]
        self.window_s = window_s
        self.max_batch = max_batch
        self.q = queue.Queue()
        #: recent executed batch sizes (bounded — a long-lived server must
        #: not grow a list forever) + running totals for observability.
        self.calls = collections.deque(maxlen=4096)
        self.n_calls = 0
        self.n_frames = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="stylize-microbatch")
        self._thread.start()

    def submit(self, frame):
        item = {"frame": frame, "out": None, "err": None,
                "done": threading.Event()}
        self.q.put(item)
        # Never wait on a dead worker: a wedged handler thread pool is
        # worse than a 500 (the worker marks items done even on error,
        # so this only trips if the thread itself died).
        while not item["done"].wait(timeout=self.WAIT_POLL_S):
            if not self._thread.is_alive():
                raise RuntimeError("micro-batch worker thread died")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _worker(self):
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                groups = {}
                for it in batch:
                    groups.setdefault(it["frame"].shape, []).append(it)
                for items in groups.values():
                    self._run_group(items)
            except Exception as e:  # noqa: BLE001 — keep the worker alive
                for it in batch:
                    if not it["done"].is_set():
                        it["err"] = it["err"] if it["err"] is not None else e
                        it["done"].set()

    def _run_group(self, items):
        # Pad each coalesced batch up to a power-of-2 bucket, capped at
        # max_batch (the operator's device-memory bound).  Padding happens
        # on the PREPROCESSED array inside transfer_batch (pad rows skip
        # host prep and the fetch, and never reach the client).  On the
        # card the buckets keep the batch shapes to a bounded set: cuDNN
        # chooses its algorithms and the caching allocator sizes its blocks
        # once per shape, and warmup pays each of them at boot.
        n = len(items)
        try:
            outs = self.fn([it["frame"] for it in items],
                           _bucket(n, self.max_batch))
            for it, o in zip(items, outs):
                it["out"] = o
        except Exception as e:  # noqa: BLE001 — per-request reply
            for it in items:
                it["err"] = e
        finally:
            self.calls.append(n)
            self.n_calls += 1
            self.n_frames += n
            for it in items:
                it["done"].set()


class _DeviceThread:
    """One daemon thread that runs submitted callables in order (a daemon,
    as the JAX service's worker threads are: a server that exits mid-clip
    does not wait for it)."""

    def __init__(self):
        self.q = queue.Queue()
        threading.Thread(target=self._loop, daemon=True,
                         name="rerevst-device").start()

    def submit(self, fn) -> Future:
        fut = Future()
        self.q.put((fn, fut))
        return fut

    def _loop(self):
        while True:
            fn, fut = self.q.get()
            fut.set_running_or_notify_cancel()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — to the submitter
                fut.set_exception(e)


class StylizeService:
    """Thread-safe wrapper around one Stylization session."""

    def __init__(self, checkpoint: str, dtype: str = "bf16", mix: str = "none",
                 use_global: bool = True, batch_window_ms: float = 0.0,
                 batch_max: int = 8, pairlane: bool = False,
                 tiles: int = 1, device="cuda"):
        cfg = ModelConfig(
            dtype=dtype_from_name(dtype),
            fp32_mix=mix,
            pairlane=pairlane,
            spatial_tiles=tiles)
        self.session = Stylization(checkpoint=checkpoint, cfg=cfg,
                                   use_global=use_global, device=device)
        self.device = self.session.device
        self.lock = threading.Lock()
        #: The one thread every session call runs on (see the module
        #: docstring): cuDNN's plans, built once per shape, stay warm.
        self._device_thread = _DeviceThread()
        #: opt-in micro-batching: coalesce concurrent /stylize requests
        #: into one device call (--batch-window-ms).
        self.batcher = None
        if batch_window_ms > 0:
            self.batcher = _MicroBatcher(self._transfer_batch,
                                         batch_window_ms / 1e3, batch_max)
        #: token -> chunked clip-session state (disk spool dirs).
        self.clips = {}
        #: lazily-created multi-style session (POST /styles).
        self._checkpoint = checkpoint
        self._cfg = cfg
        self.multi = None
        #: /metrics counters (endpoint family -> requests served).
        self.started = time.time()
        self.requests = collections.Counter()

    def warmup(self, hw) -> float:
        """Pay the first request's one-time costs at BOOT: run a synthetic
        (style, 1-frame clip) of geometry `hw` through the full two-pass on
        the REAL serving session, and with micro-batching on, one call of
        each batch bucket's size, all on the device thread.  On the card
        that builds the kernels (``nvcc``) and the native host library at
        first use, builds cuDNN's plans at every batch shape the service
        will run, and grows the device and pinned-host caching allocators
        to them.  Then the session is reset.  Returns the warmup wall time
        so boot logs show what was paid."""
        t0 = time.time()
        h, w = hw
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, (h, w, 3), np.uint8)
        s = self.session

        def run():
            s.prepare_style(rng.integers(0, 255, (h, w, 3), np.uint8))
            if s.use_global:
                s.add(frame)
                s.compute()
            out = s.transfer(frame)
            assert out.shape == frame.shape
            if self.batcher is not None:
                mb = self.batcher.max_batch
                for b in sorted({_bucket(n, mb) for n in range(2, mb + 1)}):
                    s.transfer_batch([frame] * b)
            # Real clips start clean (healthz must not claim a style).
            s.clean()
            s.style = None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        self._run(run)
        return time.time() - t0

    def _run(self, fn):
        """fn() on the device thread, under the session lock."""
        with self.lock:
            return self._device_thread.submit(fn).result()

    def _device_name(self) -> str:
        if self.device.type != "cuda":
            return str(self.device)
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        return f"cuda:{index} ({torch.cuda.get_device_name(index)})"

    def healthz(self):
        return {"ok": True, "device": self._device_name(),
                "has_style": self.session.style is not None,
                "has_stats": self.session.stats is not None}

    def metrics(self) -> str:
        """Prometheus text exposition of the service counters."""
        lines = [
            "# TYPE rerevst_uptime_seconds gauge",
            f"rerevst_uptime_seconds {time.time() - self.started:.1f}",
            "# TYPE rerevst_requests_total counter",
        ]
        for ep, n in sorted(self.requests.items()):
            lines.append(f'rerevst_requests_total{{endpoint="{ep}"}} {n}')
        lines += [
            "# TYPE rerevst_open_clip_sessions gauge",
            f"rerevst_open_clip_sessions {len(self.clips)}",
            "# TYPE rerevst_session_ready gauge",
            f'rerevst_session_ready{{part="style"}} '
            f"{int(self.session.style is not None)}",
            f'rerevst_session_ready{{part="stats"}} '
            f"{int(self.session.stats is not None)}",
        ]
        if self.batcher is not None:
            lines += [
                "# TYPE rerevst_microbatch_calls_total counter",
                f"rerevst_microbatch_calls_total {self.batcher.n_calls}",
                "# TYPE rerevst_microbatch_frames_total counter",
                f"rerevst_microbatch_frames_total {self.batcher.n_frames}",
            ]
        return "\n".join(lines) + "\n"

    def set_style(self, img):
        def run():
            self.session.prepare_style(img)
            self.session.clean()

        self._run(run)

    def pass1(self, img, last: bool):
        def run():
            self.session.add(img)
            if last:
                self.session.compute()

        self._run(run)

    def stylize(self, img):
        if self.batcher is not None:
            return self.batcher.submit(img)
        return self._run(lambda: self.session.transfer(img))

    def _transfer_batch(self, frames, pad_to=0):
        return self._run(
            lambda: self.session.transfer_batch(frames, pad_to=pad_to))

    # ------------------------------------------------------------------
    # Multi-style interpolation (the reference's Multi-style variant)
    # ------------------------------------------------------------------

    def set_styles(self, imgs):
        """Prepare N styles for blended stylization (client pre-sizes them;
        the reference uses 384x384, Multi-style .../test.py:52)."""
        from rerevst_torch.multistyle import MultiStylization

        if len(imgs) < 1:
            raise ValueError("need at least one style image")

        def run():
            if self.multi is None:
                self.multi = MultiStylization(checkpoint=self._checkpoint,
                                              cfg=self._cfg,
                                              device=self.device)
            self.multi.prepare_styles(imgs)

        self._run(run)

    def interpolate(self, frames, weights, max_frames: int):
        """Stylize `frames` under a per-frame [n_frames, n_styles] weight
        schedule (None = the reference's linear sweep)."""
        if self.multi is None or not self.multi.styles:
            raise RuntimeError("set styles first (POST /styles)")
        if not frames:
            raise ValueError("empty clip")
        if len(frames) > max_frames:
            raise ValueError(
                f"clip too long: {len(frames)} frames > cap {max_frames}")
        if weights is not None:
            weights = np.asarray(weights, np.float32)
            if weights.shape != (len(frames), len(self.multi.styles)):
                raise ValueError(
                    f"weights shape {weights.shape} != "
                    f"({len(frames)}, {len(self.multi.styles)})")
            weights = weights.tolist()

        def run():
            self.multi._pad_hw = None  # new clip: geometry re-locks
            return list(self.multi.interpolate_video(frames,
                                                     weights=weights))

        return self._run(run)

    # ------------------------------------------------------------------
    # Chunked clip sessions (clips beyond the request-body cap)
    # ------------------------------------------------------------------

    #: Abandoned-session bounds: a client that opens a clip and crashes
    #: before /close would otherwise leak its spool directory and dict
    #: entry for the server's lifetime.  Idle sessions past the TTL are
    #: pruned on the next /clip/open; the cap bounds concurrent spools.
    CLIP_TTL_S = 3600.0
    MAX_OPEN_CLIPS = 32

    def _prune_clips(self) -> None:
        now = time.monotonic()
        with self.lock:
            stale = [t for t, c in self.clips.items()
                     if now - c["ts"] > self.CLIP_TTL_S
                     and c.get("status") != "running"]  # never mid-finish
            dead = [self.clips.pop(t) for t in stale]
        for clip in dead:
            shutil.rmtree(clip["dir"], ignore_errors=True)

    def clip_open(self, interval: int) -> str:
        if self.session.style is None:
            raise RuntimeError("set a style first (POST /style)")
        self._prune_clips()
        token = uuid.uuid4().hex[:16]
        with self.lock:
            if len(self.clips) >= self.MAX_OPEN_CLIPS:
                raise RuntimeError(
                    f"too many open clip sessions ({self.MAX_OPEN_CLIPS}); "
                    "close or abandon some first")
            self.clips[token] = {
                "dir": tempfile.mkdtemp(prefix=f"rerevst_clip_{token}_"),
                "interval": interval, "n": 0, "done": 0, "shape": None,
                # Per-clip lock: /clip/<t>/frames chunks may arrive on
                # concurrent handler threads; n/shape/done and the spool
                # files must mutate atomically per clip (the global
                # svc.lock stays reserved for the device session).
                "lock": threading.Lock(), "ts": time.monotonic(),
            }
        return token

    def _clip(self, token: str):
        with self.lock:
            clip = self.clips.get(token)
        if clip is None:
            raise RuntimeError(f"unknown clip token {token!r}")
        clip["ts"] = time.monotonic()
        return clip

    def clip_frames(self, token: str, frames, max_frames: int) -> int:
        """Append a chunk of frames to the clip's disk spool (one lossless
        ``.npy`` per frame — the pipeline reads them back lazily)."""
        clip = self._clip(token)
        with clip["lock"]:
            if clip["done"] or clip.get("status") == "running":
                raise RuntimeError("clip already finished or finishing")
            if clip["n"] + len(frames) > max_frames:
                raise ValueError(
                    f"clip too long: {clip['n'] + len(frames)} frames > cap "
                    f"{max_frames}")
            for f in frames:
                if f.ndim != 3 or f.shape[2] != 3 or f.dtype != np.uint8:
                    raise ValueError(
                        f"expected uint8 HxWx3 frames, got "
                        f"{f.dtype} {f.shape}")
                if clip["shape"] is None:
                    clip["shape"] = f.shape
                elif f.shape != clip["shape"]:
                    raise ValueError(
                        f"frame shape {f.shape} != first frame "
                        f"{clip['shape']} (geometry is fixed per clip)")
                np.save(os.path.join(clip["dir"],
                                     f"frame_{clip['n']:06d}.npy"), f)
                clip["n"] += 1
            return clip["n"]

    def clip_finish(self, token: str, wait: bool = True) -> int:
        """Run the two-pass pipeline over the spooled clip; results stream to
        disk next to the spool.

        ``wait=False`` (POST /clip/<t>/finish?async=1): start the pipeline
        on a background thread and return immediately — a long clip would
        otherwise hold one HTTP request open for the whole run, which
        load balancers and client timeouts routinely kill.  Poll
        GET /clip/<t>/status for progress; /result replies 409 until done."""
        clip = self._clip(token)
        with clip["lock"]:
            if clip["n"] == 0:
                raise ValueError("empty clip")
            if clip["done"]:
                return clip["n"]
            if clip.get("status") == "running":
                if wait:
                    raise RuntimeError(
                        "finish already running; poll /clip/<t>/status")
                return clip["n"]  # idempotent async re-post
            clip["status"] = "running"
            clip["progress"] = 0
            clip["error"] = None
        if wait:
            self._clip_run(clip)
            if clip.get("status") == "error":
                raise RuntimeError(clip["error"])
            return clip["n"]
        threading.Thread(target=self._clip_run, args=(clip,),
                         daemon=True, name=f"clip-finish-{token}").start()
        return clip["n"]

    def _clip_run(self, clip) -> None:
        try:
            paths = [os.path.join(clip["dir"], f"frame_{i:06d}.npy")
                     for i in range(clip["n"])]

            def run():
                self.session.infer = InferenceConfig(
                    sample_interval=clip["interval"],
                    use_global=self.session.use_global,
                    batch_size=min(clip["n"], 8))
                self.session.clean()
                for i, styled in enumerate(
                        self.session.stylize_video(NpySource(paths))):
                    np.save(os.path.join(clip["dir"], f"res_{i:06d}.npy"),
                            styled)
                    clip["progress"] = i + 1
                    clip["ts"] = time.monotonic()  # keep TTL pruning away

            self._run(run)
            with clip["lock"]:
                clip["done"] = 1
                clip["status"] = "done"
        except Exception as e:  # noqa: BLE001 — surfaced via /status
            clip["error"] = f"{type(e).__name__}: {e}"
            clip["status"] = "error"

    def clip_status(self, token: str) -> dict:
        clip = self._clip(token)
        return {"frames": clip["n"], "done": bool(clip["done"]),
                "status": clip.get("status", "open"),
                "progress": clip.get("progress", 0),
                "error": clip.get("error")}

    def clip_result(self, token: str, start: int, count: int):
        clip = self._clip(token)
        with clip["lock"]:
            if not clip["done"]:
                raise RuntimeError(
                    "clip not finished (POST /clip/<t>/finish)")
            if start < 0 or count < 1 or start >= clip["n"]:
                raise ValueError(f"bad range [{start}, {start + count}) of "
                                 f"{clip['n']} frames")
            out = []
            for i in range(start, min(start + count, clip["n"])):
                path = os.path.join(clip["dir"], f"res_{i:06d}.npy")
                if not os.path.exists(path):
                    raise RuntimeError(f"result frame {i} missing")
                out.append(np.load(path))
            return out

    def clip_close(self, token: str) -> None:
        with self.lock:
            clip = self.clips.pop(token, None)
        if clip is not None:
            with clip["lock"]:
                shutil.rmtree(clip["dir"], ignore_errors=True)

    def video(self, frames, interval: int, max_frames: int):
        if not frames:
            raise ValueError("empty clip")
        if len(frames) > max_frames:
            raise ValueError(
                f"clip too long: {len(frames)} frames > cap {max_frames}")
        shape = frames[0].shape
        for i, f in enumerate(frames):
            if f.ndim != 3 or f.shape[2] != 3 or f.dtype != np.uint8:
                raise ValueError(
                    f"frame {i}: expected uint8 HxWx3, got "
                    f"{f.dtype} {f.shape}")
            if f.shape != shape:
                raise ValueError(
                    f"frame {i}: shape {f.shape} != frame 0 {shape} "
                    f"(geometry is fixed per clip)")

        def run():
            self.session.infer = InferenceConfig(
                sample_interval=interval,
                use_global=self.session.use_global,
                batch_size=min(len(frames), 8))
            self.session.clean()
            return list(self.session.stylize_video(frames))

        return self._run(run)


def make_handler(svc: StylizeService, max_body: int = DEFAULT_MAX_BODY_MB << 20,
                 max_frames: int = DEFAULT_MAX_FRAMES):
    class Handler(BaseHTTPRequestHandler):
        # Bound stuck/trickling clients; one slow socket must not wedge the
        # (threaded) acceptor's resources forever.
        timeout = 120

        def _reply(self, code, body, ctype="application/json"):
            data = (json.dumps(body).encode() if ctype == "application/json"
                    else body)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code, exc_type: str, message: str):
            return self._reply(code, {"error": {"type": exc_type,
                                                "message": message}})

        def _body(self) -> bytes:
            try:
                n = int(self.headers.get("Content-Length", ""))
            except ValueError:
                raise _HttpError(411, "Content-Length required")
            if n < 0:
                raise _HttpError(400, "negative Content-Length")
            if n > max_body:
                # Bounded drain so the 413 reply reaches the client cleanly
                # instead of racing a connection reset mid-upload; huge
                # claimed lengths are abandoned (client sees the close).
                remaining = min(n, max_body + (8 << 20))
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                raise _HttpError(
                    413, f"body {n} bytes exceeds cap {max_body}")
            return self.rfile.read(n)

        def log_message(self, *a):  # route access logs to /dev/null, keep
            pass                    # errors (logged explicitly in do_POST)

        def do_GET(self):
            try:
                path, _, query = self.path.partition("?")
                qs = dict(kv.split("=", 1) for kv in query.split("&")
                          if "=" in kv)
                svc.requests[path.strip("/").split("/")[0] or "root"] += 1
                if path.startswith("/healthz"):
                    return self._reply(200, svc.healthz())
                if path == "/metrics":
                    return self._reply(200, svc.metrics().encode(),
                                       ctype="text/plain; version=0.0.4")
                parts = path.strip("/").split("/")
                if (len(parts) == 3 and parts[0] == "clip"
                        and parts[2] == "status"):
                    return self._reply(200, svc.clip_status(parts[1]))
                if (len(parts) == 3 and parts[0] == "clip"
                        and parts[2] == "result"):
                    outs = svc.clip_result(parts[1],
                                           int(qs.get("start", "0")),
                                           int(qs.get("count", "64")))
                    return self._npz_reply(outs)
                return self._error(404, "NotFound", path)
            except ValueError as e:
                return self._error(400, type(e).__name__, str(e))
            except RuntimeError as e:
                return self._error(409, type(e).__name__, str(e))
            except Exception as e:  # noqa: BLE001 — service boundary
                traceback.print_exc(file=sys.stderr)
                return self._error(500, type(e).__name__, str(e))

        def _npz(self):
            """Decode the request body as .npz → {name: array}, sorted."""
            try:
                with np.load(io.BytesIO(self._body())) as z:
                    return {k: z[k] for k in sorted(z.files)}
            except _HttpError:
                raise
            except Exception as e:
                raise ValueError(f"undecodable .npz body: {e}")

        def _npz_reply(self, outs):
            bio = io.BytesIO()
            np.savez_compressed(
                bio, **{f"f{i:05d}": o for i, o in enumerate(outs)})
            return self._reply(200, bio.getvalue(),
                               "application/octet-stream")

        def do_POST(self):
            try:
                path, _, query = self.path.partition("?")
                qs = dict(kv.split("=", 1) for kv in query.split("&")
                          if "=" in kv)
                svc.requests[path.strip("/").split("/")[0] or "root"] += 1
                if path == "/style":
                    svc.set_style(_imdecode(self._body()))
                    return self._reply(200, {"ok": True})
                if path == "/pass1":
                    svc.pass1(_imdecode(self._body()),
                              last=qs.get("last", "0") == "1")
                    return self._reply(200, {"ok": True})
                if path == "/stylize":
                    out = svc.stylize(_imdecode(self._body()))
                    return self._reply(200, _imencode(out), "image/png")
                if path == "/styles":
                    styles = list(self._npz().values())
                    svc.set_styles(styles)
                    return self._reply(200, {"ok": True,
                                             "styles": len(styles)})
                if path == "/interpolate":
                    arrays = self._npz()
                    weights = arrays.pop("weights", None)
                    outs = svc.interpolate(list(arrays.values()), weights,
                                           max_frames)
                    return self._npz_reply(outs)
                parts = path.strip("/").split("/")
                if parts[0] == "clip":
                    if len(parts) == 2 and parts[1] == "open":
                        token = svc.clip_open(int(qs.get("interval", "8")))
                        return self._reply(200, {"clip": token})
                    if len(parts) == 3 and parts[2] == "frames":
                        frames = list(self._npz().values())
                        n = svc.clip_frames(parts[1], frames, max_frames)
                        return self._reply(200, {"received": n})
                    if len(parts) == 3 and parts[2] == "finish":
                        if qs.get("async") in ("1", "true"):
                            n = svc.clip_finish(parts[1], wait=False)
                            return self._reply(
                                202, {"frames": n, "started": True})
                        n = svc.clip_finish(parts[1])
                        return self._reply(
                            200, {"frames": n,
                                  "pass1": svc.session.pass1_mode})
                    if len(parts) == 3 and parts[2] == "close":
                        svc.clip_close(parts[1])
                        return self._reply(200, {"ok": True})
                if path == "/video":
                    frames = list(self._npz().values())
                    outs = svc.video(frames, int(qs.get("interval", "8")),
                                     max_frames)
                    return self._npz_reply(outs)
                return self._error(404, "NotFound", path)
            except _HttpError as e:
                return self._error(e.code, "HttpError", e.message)
            except ValueError as e:
                # Bad payload (undecodable image, malformed npz, bad query).
                return self._error(400, type(e).__name__, str(e))
            except RuntimeError as e:
                # Protocol-state violation (e.g. /stylize before /style).
                return self._error(409, type(e).__name__, str(e))
            except Exception as e:  # noqa: BLE001 — service boundary
                traceback.print_exc(file=sys.stderr)
                return self._error(500, type(e).__name__, str(e))

    return Handler


class _HttpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def serve(checkpoint: str, port: int = 8787, host: str = "127.0.0.1",
          dtype: str = "bf16", mix: str = "none", use_global: bool = True,
          max_body_mb: float = DEFAULT_MAX_BODY_MB,
          max_frames: int = DEFAULT_MAX_FRAMES,
          batch_window_ms: float = 0.0,
          batch_max: int = 8, aot: str | None = None,
          warmup: str | None = None, tiles: int = 1,
          device="cuda") -> ThreadingHTTPServer:
    """A ThreadingHTTPServer over a new StylizeService (call its
    ``serve_forever``); port 0 picks a free port."""
    if aot and not use_global:
        # Validate BEFORE the expensive model load.
        raise ValueError(
            "--aot bundles export the global-mode Pass 2; with "
            "--no-global the bundle would load but never be used")
    svc = StylizeService(checkpoint, dtype, mix, use_global,
                         batch_window_ms, batch_max, tiles=tiles,
                         device=device)
    if aot:
        svc.session.use_aot(aot)
    if warmup:
        hw = ([int(v) for v in warmup.split("x")] if "x" in warmup
              else [int(warmup)] * 2)
        secs = svc.warmup(hw)
        print(f"warmup {hw[0]}x{hw[1]}: first-use costs paid at boot "
              f"({secs:.1f}s)", flush=True)
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(svc, int(max_body_mb * (1 << 20)), max_frames))
    server.daemon_threads = True
    server.service = svc
    return server


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("rerevst_torch.serve")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--dtype", default="bf16",
                    choices=["bf16", "f16", "f32"])
    ap.add_argument("--mix", default="none",
                    choices=["none", "out", "res2", "dec", "enc", "full", "body"],
                    help="fp32-storage region of a bf16/f16 session "
                         "(ModelConfig.fp32_mix).  --dtype f16 passes the "
                         "repository's 1e-3 precision bar")
    ap.add_argument("--no-global", action="store_true")
    ap.add_argument("--max-body-mb", type=float, default=DEFAULT_MAX_BODY_MB)
    ap.add_argument("--max-frames", type=int, default=DEFAULT_MAX_FRAMES)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent /stylize requests arriving "
                         "within this window into ONE batched device call "
                         "(PERF.md section 6 has the card's per-frame "
                         "times).  0 disables")
    ap.add_argument("--batch-max", type=int, default=8,
                    help="micro-batching: max frames per coalesced call")
    ap.add_argument("--aot", default=None,
                    help="AOT Pass-2 bundle (convert --export-aot, exported "
                         "on this device): serve Pass 2 from its graph "
                         "where geometry and batch match; other shapes run "
                         "eager")
    ap.add_argument("--tiles", type=int, default=1,
                    help="spatial H-tiles for the full-resolution regions "
                         "(ModelConfig.spatial_tiles): bounds their memory "
                         "at large geometries (true 1080p)")
    ap.add_argument("--warmup", default=None, metavar="HxW",
                    help="run a synthetic clip of this content geometry "
                         "through the full two-pass at BOOT, so the first "
                         "real request pays steady-state latency instead "
                         "of the kernel builds and cuDNN's first calls.  "
                         "E.g. --warmup 512 or --warmup 436x1024")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = serve(args.checkpoint, args.port, args.host, args.dtype,
                   args.mix,
                   not args.no_global, args.max_body_mb, args.max_frames,
                   args.batch_window_ms, args.batch_max, aot=args.aot,
                   warmup=args.warmup, tiles=args.tiles, device=args.device)
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
