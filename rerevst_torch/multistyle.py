"""Multi-style interpolation: blend style-conditioned state across N styles —
``rerevst_tpu/multistyle.py``.

Style conditioning is two trees per style (``StyleFeatures``, ``SeqStats``)
and blending is a weighted sum of them (``blend_pytrees``), after which the
ordinary global decoder runs unchanged.  A batch in which every frame has
its own weights blends per sample (``blend_pytrees_batched``): [B,1,1,C]
statistics and [B,P,Q] filters, which the ``norm_affine_clamp`` and
``dynamic_filter_pair`` wrappers take with one launch per sample on the
card.

The quirks of the JAX package are kept: ``InferenceConfig(sample_interval=
16)`` by default; Pass-1 features come from the *padded* frames (unlike
``Stylization``); the sampling repeats the last frame; ``encode_frames``
writes a memmap cache with a ``.meta.json`` sidecar that ``load_features``
reads back; ``interpolate_video`` spills its features to a temp memmap above
``SPILL_THRESHOLD`` frames and pads the ragged tail chunk to the batch size.

With a mesh (``parallel/mesh.py``), as in the JAX session: each style's
Pass 1 is sharded over the sampled frames (``parallel/stats.py``); a decode
of fewer frames than shards shards the feature map's H rows
(``parallel/spatial.py``, where ``spatial_feats_ok`` allows it), and a
larger batch is split over the shards (``parallel/pipeline.py``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional, Sequence

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
    blend_pytrees,
    blend_pytrees_batched,
    collect_stats,
    content_dtype,
    decode_global,
    encode_content,
    encode_style,
)
from rerevst_torch.ops.image import crop_back, pad_reflect_multiple, padded_size
from rerevst_torch.parallel.pipeline import decode_blended_sharded
from rerevst_torch.parallel.spatial import (
    multistyle_decode_spatial,
    spatial_feats_ok,
)
from rerevst_torch.parallel.stats import collect_stats_sharded


class MultiStylization:
    """Session for N-style blended stylization on one device or a mesh:
    prepare the styles, encode every frame once, freeze per-style
    statistics, then decode each frame under its own blend weights."""

    #: interpolate_video spills the frame-feature cache to a temp memmap
    #: above this clip length (mirrors Stylization.STREAMING_THRESHOLD).
    SPILL_THRESHOLD = 64

    def __init__(self, checkpoint: Optional[str] = None, params=None,
                 cfg: Optional[ModelConfig] = None,
                 infer: Optional[InferenceConfig] = None, mesh=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg or ModelConfig()
        self.infer = infer or InferenceConfig(sample_interval=16)
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
        # Stored dtypes, as ``api.Stylization`` keeps them.
        self.params = from_jax_params(
            {k: v for k, v in params.items() if k != "vgg_loss"},
            device=self.device)
        self.styles: List[StyleFeatures] = []
        self.stats: List[SeqStats] = []
        self._pad_hw = None
        self._orig_hw = None

    # -- style prep --------------------------------------------------------

    def prepare_styles(self, styles_bgr: Sequence[np.ndarray]) -> None:
        with torch.inference_mode():
            self.styles = [
                encode_style(self.params, self._to_device(bgr_to_model(s)),
                             self.cfg)
                for s in styles_bgr]

    # -- content features --------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(self.device)

    def _prep(self, frame_bgr: np.ndarray) -> torch.Tensor:
        """One frame, normalized and reflect-padded on the host, uploaded."""
        h, w = frame_bgr.shape[:2]
        if self._pad_hw is None:
            self._pad_hw = padded_size(h, w, self.infer.pad,
                                       self.infer.granularity)
            self._orig_hw = (h, w)
        if native.available():
            x = native.preprocess(frame_bgr, self._pad_hw[0], self._pad_hw[1],
                                  self.infer.pad)
        else:
            x = pad_reflect_multiple(bgr_to_model(frame_bgr), self.infer.pad,
                                     self.infer.granularity, self._pad_hw)
        return self._to_device(x)

    def _encode(self, frame_bgr: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            f = encode_content(self.params, self._prep(frame_bgr), self.cfg,
                               desaturate=True)
        return f.float().cpu().numpy()

    def encode_frames(self, frames_bgr, cache_path: Optional[str] = None):
        """Encode every frame once.  `frames_bgr` is anything
        ``data.source.as_source`` accepts, read lazily, one frame at a time.
        With `cache_path` the features go to a disk-backed ``.npy`` memmap
        (fp32) with a sidecar of the geometry, and the memmap is returned;
        otherwise a device tensor in the features' dtype (lossless: the
        values came from it)."""
        src = as_source(frames_bgr)
        n = len(src)
        it = iter(src)
        first = self._encode(next(it))
        shape = (n,) + first.shape[1:]
        if cache_path is not None:
            feats = np.lib.format.open_memmap(
                cache_path, mode="w+", dtype=np.float32, shape=shape)
            # Sidecar geometry so a fresh session can decode from the cache.
            with open(cache_path + ".meta.json", "w") as f:
                json.dump({"orig_hw": list(self._orig_hw),
                           "pad_hw": list(self._pad_hw),
                           "pad": self.infer.pad}, f)
        else:
            feats = np.empty(shape, np.float32)
        feats[0] = first[0]
        for i, f in enumerate(it, start=1):
            feats[i] = self._encode(f)[0]
        if cache_path is not None:
            return feats
        return self._feats(feats)

    def load_features(self, cache_path: str) -> np.ndarray:
        """Reload a feature cache, restoring the session geometry from the
        sidecar so ``transfer`` works without re-encoding any frame."""
        meta_path = cache_path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self._orig_hw = tuple(meta["orig_hw"])
            self._pad_hw = tuple(meta["pad_hw"])
        return np.load(cache_path, mmap_mode="r")

    def _feats(self, feats) -> torch.Tensor:
        """Features on the device in the dtype ``encode_content`` gives them
        (the storage dtype, or fp32 under ``fp32_mix`` 'full' and 'body')."""
        return self._to_device(feats).to(content_dtype(self.cfg))

    def prepare_global(self, feats, interval: Optional[int] = None) -> None:
        """Freeze per-style SeqStats from sampled cached features: every
        `interval`-th frame from 0, then the last frame again (a duplicate
        when `interval` divides n-1, as in the reference)."""
        iv = interval or self.infer.sample_interval
        n = feats.shape[0]
        idx = [s * iv for s in range((n - 1) // iv + 1)] + [n - 1]
        if isinstance(feats, torch.Tensor):
            sampled = feats[torch.as_tensor(idx, device=feats.device)]
        else:  # includes disk-backed memmaps
            sampled = np.stack([feats[i] for i in idx])
        sampled = self._feats(sampled)
        with torch.inference_mode():
            if self.mesh is not None:
                self.stats = [collect_stats_sharded(
                    self.params["decoder"], sampled, sf, self.cfg, self.mesh)
                    for sf in self.styles]
            else:
                self.stats = [collect_stats(self.params["decoder"], sampled,
                                            sf, self.cfg)
                              for sf in self.styles]

    # -- per-weight decode -------------------------------------------------

    def _decode(self, feats, weights) -> np.ndarray:
        """Decode features under blended styles: `weights` [S] (one blend)
        or [B, S] (a blend per frame); cropped, on the host."""
        per_frame = np.ndim(weights) == 2
        blend = blend_pytrees_batched if per_frame else blend_pytrees
        with torch.inference_mode():
            x = self._feats(feats)
            if self.mesh is not None and spatial_feats_ok(
                    x.shape[0], x.shape[1], self.mesh):
                out = multistyle_decode_spatial(
                    self.params, x, self.styles, self.stats, weights,
                    self.cfg, self.mesh)
            elif self.mesh is not None and per_frame and x.shape[0] > 1:
                out = decode_blended_sharded(
                    self.params, x, self.styles, self.stats, weights,
                    self.cfg, self.mesh)
            else:
                out = decode_global(self.params["decoder"], x,
                                    blend(self.styles, weights),
                                    blend(self.stats, weights), self.cfg)
            h, w_ = self._orig_hw
            return crop_back(out, h, w_, self.infer.pad).float().cpu().numpy()

    def transfer(self, feats_one, weights: Sequence[float]) -> np.ndarray:
        """Decode one frame's cached features under blended styles -> BGR.
        `weights` is one float per prepared style."""
        if len(weights) != len(self.styles):
            raise ValueError(
                f"got {len(weights)} weights for {len(self.styles)} styles")
        return model_to_bgr(self._decode(feats_one, weights))

    def transfer_batch(self, feats, weight_rows) -> List[np.ndarray]:
        """Decode a [B,...] feature batch, each frame under its own blend
        weights ([B, n_styles]), in one decode: per-sample statistics and
        filters."""
        w = np.asarray(weight_rows, np.float32)
        n = feats.shape[0]
        if w.shape != (n, len(self.styles)):
            raise ValueError(f"weights shape {w.shape} != "
                             f"({n}, {len(self.styles)})")
        out = self._decode(feats, w)
        return [model_to_bgr(out[i:i + 1]) for i in range(n)]

    def interpolate_video(self, frames_bgr,
                          weights: Optional[Sequence[Sequence[float]]] = None,
                          cache_path: Optional[str] = None,
                          batch_size: int = 8):
        """Stylize a clip under a per-frame weight schedule, `batch_size`
        frames per decode.

        `frames_bgr`: any ``as_source`` input, read lazily; above
        SPILL_THRESHOLD frames the features go to a temp memmap.
        `weights`: one row of len(styles) floats per frame; by default
        ``linear_sweep_weights``."""
        src = as_source(frames_bgr)
        n = len(src)
        tmp = None
        if cache_path is None and n > self.SPILL_THRESHOLD:
            fd, tmp = tempfile.mkstemp(prefix="rerevst_msfeat_",
                                       suffix=".npy")
            os.close(fd)
            cache_path = tmp
        try:
            feats = self.encode_frames(src, cache_path=cache_path)
            self.prepare_global(feats)
            if weights is None:
                weights = linear_sweep_weights(n, len(self.styles))
            if len(weights) != n:
                raise ValueError(
                    f"weight schedule has {len(weights)} rows for {n} frames")
            bs = max(int(batch_size), 1)
            for i in range(0, n, bs):
                chunk = feats[i:i + bs]
                rows = [list(r) for r in weights[i:i + bs]]
                k = len(rows)
                if k < bs and n > bs:
                    # One batch shape: the ragged tail repeats its last row.
                    if isinstance(chunk, torch.Tensor):
                        chunk = torch.cat([chunk] + [chunk[-1:]] * (bs - k))
                    else:
                        chunk = np.concatenate([chunk] + [chunk[-1:]]
                                               * (bs - k))
                    rows += [rows[-1]] * (bs - k)
                yield from self.transfer_batch(chunk, rows)[:k]
        finally:
            if tmp is not None:
                for p in (tmp, tmp + ".meta.json"):
                    try:
                        os.remove(p)
                    except OSError:
                        pass


def linear_sweep_weights(n_frames: int, n_styles: int) -> List[List[float]]:
    """Piecewise-linear sweep visiting every style: the last style at frame
    0, the first at the last frame.  For two styles this is the reference
    demo schedule ``[i/(n-1), 1-i/(n-1)]``."""
    if n_styles < 2:
        return [[1.0]] * n_frames
    rows = []
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1)
        s = (1.0 - u) * (n_styles - 1)
        k = min(int(s), n_styles - 2)
        frac = s - k
        w = [0.0] * n_styles
        w[k] = 1.0 - frac
        w[k + 1] = frac
        rows.append(w)
    return rows
