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

Not ported yet (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): a device mesh, AOT bundles, and Pass 1 above
``STREAMING_THRESHOLD`` sampled frames (the host spool).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from rerevst_torch.config import InferenceConfig, ModelConfig, resolve_device
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


class Stylization:
    """Video stylization session on one device.

    Parameters
    ----------
    checkpoint:
        Path to a reference ``.pth`` checkpoint or a native ``.msgpack``
        one, or None when `params` given.
    params:
        A parameter tree as ``rerevst_tpu`` holds it (nested dicts of numpy
        arrays) or as the port holds it (tensors); cast to ``cfg.dtype``.
    use_global:
        Sequence-level global feature sharing (two-pass) or per-frame mode.
        The global graph exists only for the default architecture: under
        either ablation switch of ``cfg`` it raises ``ValueError``.
    device:
        The card by default; pass ``"cpu"`` for the plain PyTorch path.
    """

    #: Above this many sampled frames the JAX session spills Pass-1 features
    #: to a host spool and collects statistics in streaming chunks.
    STREAMING_THRESHOLD = 64

    def __init__(self, checkpoint: Optional[str] = None, params=None,
                 cfg: Optional[ModelConfig] = None, use_global: bool = True,
                 infer: Optional[InferenceConfig] = None, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise _not_ported("a device mesh", "Queue 1 item 13")
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

                params = load_reference_checkpoint(checkpoint)
            else:
                from rerevst_torch.io.checkpoint import read_msgpack

                params = read_msgpack(checkpoint)
        # Inference never needs the loss net.
        params = {k: v for k, v in params.items() if k != "vgg_loss"}
        self.params: Dict = from_jax_params(params, dtype=self.cfg.dtype,
                                            device=self.device)

        self.style: Optional[StyleFeatures] = None
        self.stats: Optional[SeqStats] = None
        self._patches: List[torch.Tensor] = []
        self._pad_hw = None
        self._orig_hw = None
        #: How the last Pass 1 collected its statistics ('batched').
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
        + reflect-pad, one array out, ready for a single upload."""
        h, w = frames_bgr[0].shape[:2]
        self._lock_geometry(h, w)
        return pad_reflect_multiple(
            np.concatenate([bgr_to_model(f) for f in frames_bgr], 0),
            self.infer.pad, self.infer.granularity, self._pad_hw)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """The session's single host-to-device entry point (one call, one
        copy)."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """The session's single device-to-host entry point; callers crop on
        the device first."""
        return out.cpu().float().numpy()

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
        self.stats = None
        # Geometry re-locks on the next frame (a new clip may differ in size).
        self._pad_hw = None

    def add(self, frame_bgr: np.ndarray) -> None:
        """Pass 1: encode one sampled RAW frame (no reflect padding — the
        frozen statistics see only real content) and buffer its features."""
        n = sum(p.shape[0] for p in self._patches) + 1
        if n > self.STREAMING_THRESHOLD:
            raise _not_ported(
                f"Pass 1 over more than {self.STREAMING_THRESHOLD} sampled "
                f"frames (the host spool)", "Queue 1 item 8")
        with torch.inference_mode():
            self._patches.append(self._encode(
                self._upload(bgr_to_model(frame_bgr))))

    def compute(self) -> None:
        """Pass 1 finish: freeze the sequence statistics over the buffered
        frames in one batched collection."""
        if self.style is None:
            raise RuntimeError("prepare_style first")
        if not self._patches:
            raise ValueError("compute() needs add()ed frames")
        with torch.inference_mode():
            feats = torch.cat(self._patches, 0)
            self.pass1_mode = "batched"
            self.stats = collect_stats(self.params["decoder"], feats,
                                       self.style, self.cfg)
        self._patches = []

    def use_aot(self, path: str) -> None:
        raise _not_ported("AOT bundles", "Queue 1 item 13")

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
        return [model_to_bgr(out[i:i + 1]) for i in range(n)]

    # ------------------------------------------------------------------
    # Batched two-pass pipeline
    # ------------------------------------------------------------------

    def prepare_global(self, frames_bgr: Iterable[np.ndarray],
                       total: Optional[int] = None) -> None:
        """Pass 1 over pre-sampled RAW frames (no padding — see ``add``),
        encoded ``infer.pass1_chunk`` at a time with one upload per chunk."""
        self.clean()
        if total is None and hasattr(frames_bgr, "__len__"):
            total = len(frames_bgr)
        if total is None or total > self.STREAMING_THRESHOLD:
            raise _not_ported(
                f"Pass 1 over more than {self.STREAMING_THRESHOLD} (or an "
                f"unknown number of) sampled frames (the host spool)",
                "Queue 1 item 8")
        if self.style is None:
            raise RuntimeError("prepare_style first")
        chunk_n = max(1, self.infer.pass1_chunk)
        buf: List[np.ndarray] = []

        def flush():
            if buf:
                x = self._upload(np.concatenate(
                    [bgr_to_model(f) for f in buf], axis=0))
                with torch.inference_mode():
                    self._patches.append(self._encode(x))
                buf.clear()

        for f in frames_bgr:
            buf.append(f)
            if len(buf) == chunk_n:
                flush()
        flush()
        if not self._patches:
            raise ValueError("prepare_global got no frames")
        self.compute()

    def stylize_video(self, frames_bgr, batch_size: Optional[int] = None
                      ) -> Iterator[np.ndarray]:
        """The full pipeline over a clip: in global mode Pass 1 on every
        ``sample_interval``-th frame plus the last, then (both modes) Pass 2
        in `batch_size`-frame chunks; yields BGR uint8 frames.

        `frames_bgr` is anything ``data.source.as_source`` accepts: a
        ``FrameSource``, a frame-glob or video-file path (read with cv2), or
        an in-memory sequence.  Pass 1 reads only the sampled frames; Pass 2
        reads the clip once, a chunk at a time.  While the card stylizes
        chunk k, the host prepares chunk k+1; the ragged last chunk is
        padded to the batch shape by repeating its last row, and the pad
        rows are dropped on the device."""
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

        def chunks():
            frames = iter(src)
            while True:
                chunk = list(itertools.islice(frames, bs))
                if not chunk:
                    return
                xs = self._prep_batch_host(chunk)
                if xs.shape[0] < bs and n > bs:
                    reps = bs - xs.shape[0]
                    xs = np.concatenate([xs, np.repeat(xs[-1:], reps, 0)], 0)
                yield xs, len(chunk)

        it = chunks()
        nxt = next(it, None)
        h, w = self._orig_hw  # locked by the first Pass-2 frame
        while nxt is not None:
            xs, count = nxt
            out = crop_back(self._stylize(self._upload(xs))[:count], h, w,
                            self.infer.pad)
            nxt = next(it, None)  # host prep overlaps the card's work
            host = self._fetch(out)
            for i in range(count):
                yield model_to_bgr(host[i:i + 1])
