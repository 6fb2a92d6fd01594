"""Session API: the stateful video stylization session — ``rerevst_tpu/api.py``.

The reference's ``framework.Stylization`` surface (``prepare_style`` /
``clean`` / ``add`` / ``compute`` / ``transfer``) plus the batched
``stylize_video`` path, on one device, in both inference modes: two-pass
global (``use_global=True``: Pass 1 freezes the sequence statistics, Pass 2
decodes under them) and per-frame (``use_global=False``: Pass 2 alone, the
stateless ``decode``).  Geometry is fixed by the first frame (the
reference's ReshapeTool contract); Pass-1 frames stay unpadded, Pass-2
frames are reflect-padded; each chunk is one host-to-device copy, and frames
are cropped on the device before the device-to-host copy.  Weights come from
a native ``.msgpack`` or a reference ``.pth`` checkpoint, or a parameter
tree.

Above ``STREAMING_THRESHOLD`` sampled frames (or for an unsized iterable),
Pass 1 spills the features to a host spool and freezes the statistics with
the streaming collector (``parallel/streaming.py``), in O(chunk) device
memory.  Host prep and post-processing use the native library
(``data/native.py``) where it builds, numpy otherwise.  Pass 2 of
``stylize_video`` keeps one batch in flight: a worker thread reads, preps
and uploads chunk k+1 while the card runs chunk k, and chunk k-1 is fetched
on a copy stream that does not wait for chunk k's kernels.

Not ported yet (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): a device mesh and AOT bundles.
"""

from __future__ import annotations

import itertools
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from rerevst_torch.config import InferenceConfig, ModelConfig, resolve_device
from rerevst_torch.data import native
from rerevst_torch.data.source import as_source
from rerevst_torch.data.transforms import bgr_to_model, model_to_bgr
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models.transformer import (
    SeqStats,
    StyleFeatures,
    collect_stats,
    encode_content,
    encode_style,
    stylize,
)
from rerevst_torch.ops.image import (
    crop_back,
    pad_reflect_multiple,
    padded_size,
    validate_pad_geometry,
)
from rerevst_torch.parallel.streaming import collect_stats_streaming


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


class _FeatureSpill:
    """Appendable host spool for Pass-1 features: raw float32 chunks stream
    to a temp file and come back as one memmap for the streaming collection
    (``rerevst_tpu/api.py:_FeatureSpill``)."""

    def __init__(self):
        self._f = tempfile.NamedTemporaryFile(
            prefix="rerevst_pass1_", suffix=".f32", delete=False)
        self.path = self._f.name
        self._shape = None
        self.n = 0

    def append(self, feats: np.ndarray) -> None:
        a = np.ascontiguousarray(feats, np.float32)
        if self._shape is None:
            self._shape = a.shape[1:]
        self._f.write(a.tobytes())
        self.n += a.shape[0]

    def memmap(self) -> np.memmap:
        self._f.flush()
        return np.memmap(self.path, np.float32, "r",
                         shape=(self.n,) + self._shape)

    def close(self) -> None:
        try:
            self._f.close()
            os.unlink(self.path)
        except OSError:
            pass


class Stylization:
    """Video stylization session on one device.

    Parameters
    ----------
    checkpoint:
        Path to a reference ``.pth`` checkpoint or a native ``.msgpack``
        one, or None when `params` given.
    params:
        A parameter tree as ``rerevst_tpu`` holds it (nested dicts of numpy
        arrays) or as the port holds it (tensors), kept in its stored
        dtype as the JAX package keeps it (activations run in
        ``cfg.dtype``).
    use_global:
        Sequence-level global feature sharing (two-pass) or per-frame mode.
        The global graph exists only for the default architecture: under
        either ablation switch of ``cfg`` it raises ``ValueError``.
    device:
        The card by default; pass ``"cpu"`` for the plain PyTorch path.
    """

    #: Above this many sampled frames, Pass 1 spills its features to a host
    #: spool and collects the statistics in streaming chunks (the batched
    #: collection holds every decoder activation of the whole sample batch).
    STREAMING_THRESHOLD = 64

    def __init__(self, checkpoint: Optional[str] = None, params=None,
                 cfg: Optional[ModelConfig] = None, use_global: bool = True,
                 infer: Optional[InferenceConfig] = None, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise _not_ported("a device mesh", "Queue 1 item 7")
        self.device = resolve_device(device)
        self.cfg = cfg or ModelConfig()
        if use_global and not (self.cfg.dynamic_filter
                               and self.cfg.both_sty_con):
            raise ValueError(
                f"the global (two-pass) graph exists only for the default "
                f"architecture: ModelConfig(dynamic_filter="
                f"{self.cfg.dynamic_filter}, both_sty_con="
                f"{self.cfg.both_sty_con}) has no frozen-filter decoder; "
                f"use use_global=False")
        self.infer = infer or InferenceConfig(use_global=use_global)
        self.use_global = use_global
        if params is None:
            if checkpoint is None:
                raise ValueError("need checkpoint or params")
            if checkpoint.endswith(".pth"):
                from rerevst_torch.io.torch_compat import (
                    load_reference_checkpoint,
                )

                params = load_reference_checkpoint(checkpoint, dtype=None)
            else:
                from rerevst_torch.io.checkpoint import read_msgpack

                params = read_msgpack(checkpoint)
        # Inference never needs the loss net.  The weights keep the dtype
        # they are stored in, as in the JAX package's session: every op
        # casts a weight to the activations' dtype where it uses it, and
        # the decoder's upsample convs sum their taps in the stored dtype
        # (``layers.upsample2x_conv3x3``).
        params = {k: v for k, v in params.items() if k != "vgg_loss"}
        self.params: Dict = from_jax_params(params, device=self.device)

        self.style: Optional[StyleFeatures] = None
        self.stats: Optional[SeqStats] = None
        self._patches: List[torch.Tensor] = []
        #: Host spool the add() buffer drains into above STREAMING_THRESHOLD.
        self._patch_spill: Optional[_FeatureSpill] = None
        self._pad_hw = None
        self._orig_hw = None
        #: Side streams of the card's copies (created at first use).
        self._streams: Dict[str, torch.cuda.Stream] = {}
        #: How the last Pass 1 collected its statistics: 'batched' or
        #: 'streaming-spill'.
        self.pass1_mode: Optional[str] = None
        #: Which graph the last Pass-2 call ran: 'global' or 'per-frame'.
        self.pass2_mode: Optional[str] = None

    # ------------------------------------------------------------------
    # Geometry (ReshapeTool contract: fixed after the first frame)
    # ------------------------------------------------------------------

    def _lock_geometry(self, h: int, w: int) -> None:
        if self._pad_hw is None:
            validate_pad_geometry(h, w, self.infer.pad, self.infer.granularity)
            self._pad_hw = padded_size(h, w, self.infer.pad,
                                       self.infer.granularity)
            self._orig_hw = (h, w)

    def _prep_batch_host(self, frames_bgr: Sequence[np.ndarray]) -> np.ndarray:
        """Host-side prep of a same-geometry frame batch: BGR -> normalized RGB
        + reflect-pad, one array out, ready for a single upload (one native
        call where the library loads)."""
        h, w = frames_bgr[0].shape[:2]
        self._lock_geometry(h, w)
        if native.available():
            return native.preprocess_batch(
                np.stack(frames_bgr), self._pad_hw[0], self._pad_hw[1],
                self.infer.pad)
        return pad_reflect_multiple(
            np.concatenate([bgr_to_model(f) for f in frames_bgr], 0),
            self.infer.pad, self.infer.granularity, self._pad_hw)

    def _stream(self, name: str) -> torch.cuda.Stream:
        if name not in self._streams:
            self._streams[name] = torch.cuda.Stream(self.device)
        return self._streams[name]

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """The session's single host-to-device entry point (one call, one
        copy).  On the card the copy runs from pinned memory on its own
        stream and is complete on return, so a worker thread can upload
        while the card computes; the tensor is marked as used by the compute
        stream, so the allocator keeps it until that stream is done."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        stream = self._stream("upload")
        with torch.cuda.stream(stream):
            dev = t.pin_memory().to(self.device, non_blocking=True)
        dev.record_stream(torch.cuda.default_stream(self.device))
        stream.synchronize()
        return dev

    def _fetch(self, out: torch.Tensor,
               ready: Optional[torch.cuda.Event] = None) -> np.ndarray:
        """The session's single device-to-host entry point; callers crop on
        the device first.  On the card the copy runs on its own stream into
        pinned memory, after `ready` (an event recorded once `out` was
        enqueued) or after everything queued so far, and only that copy is
        waited for: kernels queued after `ready` keep running."""
        if self.device.type != "cuda":
            return out.float().numpy()
        stream = self._stream("fetch")
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.default_stream(self.device))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host.copy_(out, non_blocking=True)
        stream.synchronize()
        return host.float().numpy()

    def _post(self, out: np.ndarray) -> np.ndarray:
        """Host post-processing of an already-cropped fetched frame
        ([1,h,w,3] normalized RGB -> BGR uint8)."""
        if native.available():
            h, w = out.shape[1:3]
            return native.postprocess(out, h, w, 0)
        return model_to_bgr(out)

    # ------------------------------------------------------------------
    # Reference-compatible surface
    # ------------------------------------------------------------------

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        return encode_content(self.params, x, self.cfg, desaturate=True)

    def prepare_style(self, style_bgr: np.ndarray) -> None:
        with torch.inference_mode():
            self.style = encode_style(self.params,
                                      self._upload(bgr_to_model(style_bgr)),
                                      self.cfg)

    def clean(self) -> None:
        self._patches = []
        if self._patch_spill is not None:
            self._patch_spill.close()
            self._patch_spill = None
        self.stats = None
        # Geometry re-locks on the next frame (a new clip may differ in size).
        self._pad_hw = None

    def add(self, frame_bgr: np.ndarray) -> None:
        """Pass 1: encode one sampled RAW frame (no reflect padding — the
        frozen statistics see only real content) and buffer its features;
        above STREAMING_THRESHOLD the buffer drains to the host spool."""
        with torch.inference_mode():
            self._patches.append(self._encode(
                self._upload(bgr_to_model(frame_bgr))))
        self._maybe_spill_patches()

    def _maybe_spill_patches(self) -> None:
        """Drain the add() buffer into the host spool once the sample count
        crosses STREAMING_THRESHOLD, so a long add() session has the memory
        profile of a long prepare_global."""
        if self._patch_spill is None:
            if sum(p.shape[0] for p in self._patches) <= \
                    self.STREAMING_THRESHOLD:
                return
            self._patch_spill = _FeatureSpill()
        for p in self._patches:
            self._patch_spill.append(self._fetch(p))
        self._patches = []

    def _collect_spilled(self, spill: _FeatureSpill) -> None:
        self.pass1_mode = "streaming-spill"
        self.stats = collect_stats_streaming(
            self.params["decoder"], spill.memmap(), self.style, self.cfg,
            chunk_size=max(1, self.infer.pass1_chunk))

    def compute(self) -> None:
        """Pass 1 finish: freeze the sequence statistics over the buffered
        frames — streamed from the host spool above STREAMING_THRESHOLD, in
        one batched collection otherwise."""
        if self.style is None:
            raise RuntimeError("prepare_style first")
        if self._patch_spill is not None:
            self._maybe_spill_patches()  # drain any tail still on the device
            try:
                self._collect_spilled(self._patch_spill)
            finally:
                self._patch_spill.close()
                self._patch_spill = None
            return
        if not self._patches:
            raise ValueError("compute() needs add()ed frames")
        with torch.inference_mode():
            feats = torch.cat(self._patches, 0)
            self.pass1_mode = "batched"
            self.stats = collect_stats(self.params["decoder"], feats,
                                       self.style, self.cfg)
        self._patches = []

    def use_aot(self, path: str) -> None:
        raise _not_ported("AOT bundles", "Queue 1 item 7")

    def _stylize(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_global and self.stats is None:
            raise RuntimeError("compute() first (or use_global=False)")
        if self.style is None:
            raise RuntimeError("prepare_style first")
        self.pass2_mode = "global" if self.use_global else "per-frame"
        with torch.inference_mode():
            return stylize(self.params, x, self.style, self.cfg,
                           self.stats if self.use_global else None)

    def transfer(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Pass 2: stylize one frame, return BGR uint8."""
        return self.transfer_batch([frame_bgr])[0]

    def transfer_batch(self, frames_bgr: Sequence[np.ndarray],
                       pad_to: int = 0) -> List[np.ndarray]:
        """Pass 2 on several same-geometry frames: one upload, one stylize
        call, one fetch.  ``pad_to`` pads the batch up to that size by
        repeating the last preprocessed row; pad rows are sliced off on the
        device."""
        if not frames_bgr:
            return []
        n = len(frames_bgr)
        h, w = frames_bgr[0].shape[:2]
        xs = self._prep_batch_host(frames_bgr)
        if pad_to > n:
            xs = np.concatenate([xs, np.repeat(xs[-1:], pad_to - n, 0)])
        out = self._fetch(crop_back(self._stylize(self._upload(xs))[:n],
                                    h, w, self.infer.pad))
        return [self._post(out[i:i + 1]) for i in range(n)]

    # ------------------------------------------------------------------
    # Batched two-pass pipeline
    # ------------------------------------------------------------------

    def prepare_global(self, frames_bgr: Iterable[np.ndarray],
                       total: Optional[int] = None) -> None:
        """Pass 1 over pre-sampled RAW frames (no padding — see ``add``),
        encoded ``infer.pass1_chunk`` at a time with one upload per chunk.
        Up to STREAMING_THRESHOLD frames the features stay on the device for
        one batched collection; above it, or when the count is unknown (an
        unsized iterable and no `total`), they spill to a host spool and the
        streaming collector freezes the statistics."""
        self.clean()
        if self.style is None:
            raise RuntimeError("prepare_style first")
        if total is None and hasattr(frames_bgr, "__len__"):
            total = len(frames_bgr)
        chunk_n = max(1, self.infer.pass1_chunk)
        on_device = total is not None and total <= self.STREAMING_THRESHOLD
        spill = None if on_device else _FeatureSpill()
        buf: List[np.ndarray] = []
        try:

            def flush():
                if not buf:
                    return
                x = self._upload(np.concatenate(
                    [bgr_to_model(f) for f in buf], axis=0))
                with torch.inference_mode():
                    enc = self._encode(x)
                if on_device:
                    self._patches.append(enc)
                else:
                    spill.append(self._fetch(enc))
                buf.clear()

            for f in frames_bgr:
                buf.append(f)
                if len(buf) == chunk_n:
                    flush()
            flush()
            if (spill.n if spill is not None else len(self._patches)) == 0:
                raise ValueError("prepare_global got no frames")
            if on_device:
                self.compute()
            else:
                self._collect_spilled(spill)
        finally:
            if spill is not None:
                spill.close()

    def stylize_video(self, frames_bgr, batch_size: Optional[int] = None
                      ) -> Iterator[np.ndarray]:
        """The full pipeline over a clip: in global mode Pass 1 on every
        ``sample_interval``-th frame plus the last, then (both modes) Pass 2
        in `batch_size`-frame chunks; yields BGR uint8 frames.

        `frames_bgr` is anything ``data.source.as_source`` accepts: a
        ``FrameSource``, a frame-glob or video-file path (read with cv2), or
        an in-memory sequence.  Pass 1 reads only the sampled frames; Pass 2
        reads the clip once, a chunk at a time, with one batch in flight
        across the yield: a one-worker thread reads, preps and uploads chunk
        k+1 (only it touches the source iterator) while the main thread
        launches chunk k and then drains chunk k-1, whose copy to the host
        waits only for chunk k-1's kernels.  The ragged last chunk is padded
        to the batch shape by repeating its last row, and the pad rows are
        dropped on the device."""
        src = as_source(frames_bgr)
        n = len(src)
        if n == 0:
            return
        bs = batch_size or self.infer.batch_size
        if self.use_global:
            interval = self.infer.sample_interval
            idx = [s * interval for s in range((n - 1) // interval)] + [n - 1]
            self.prepare_global(src.read_indices(idx), total=len(idx))
        else:
            self.clean()  # a new clip: geometry re-locks on its first frame
        frames = iter(src)

        def next_chunk():
            chunk = list(itertools.islice(frames, bs))
            if not chunk:
                return None
            xs = self._prep_batch_host(chunk)
            if xs.shape[0] < bs and n > bs:
                reps = bs - xs.shape[0]
                xs = np.concatenate([xs, np.repeat(xs[-1:], reps, 0)], 0)
            return self._upload(xs), len(chunk)

        def drain(pending):
            out, count, ready = pending
            host = self._fetch(out, ready)
            for i in range(count):
                yield model_to_bgr(host[i:i + 1])

        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(next_chunk)
            pending = None  # (cropped device result, frames in it, event)
            while True:
                got = nxt.result()
                if got is None:
                    break
                x, count = got
                nxt = ex.submit(next_chunk)
                h, w = self._orig_hw  # locked by the first Pass-2 chunk
                out = crop_back(self._stylize(x)[:count], h, w,
                                self.infer.pad)
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.default_stream(self.device))
                if pending is not None:
                    yield from drain(pending)
                pending = (out, count, ready)
            if pending is not None:
                yield from drain(pending)
