#!/usr/bin/env python3
"""Where the bundled checkpoint's bf16 weights change the JAX package's
statistics and frames (CPU, fp32 activations).

    XLA_FLAGS=--xla_disable_hlo_passes=constant_folding \\
        JAX_PLATFORMS=cpu python scripts/probe_bf16_fold.py

``rerevst_tpu``'s ``Stylization`` keeps a ``.msgpack``'s bf16 weights as
they are; every conv casts its weight to the activations' dtype, which is
exact.  The one place a weight is computed with before that cast is
``layers.upsample2x_conv3x3``, which sums the 3x3 taps into its 4x4
parity kernel in the weight's own dtype.  This probe runs Pass 1 of a
seeded 5-sample 64x112 clip (relu4_1 features from the fp32 encoder)
three ways and prints, per statistics site, the worst excess over the
rtol = atol = 2e-4 bar against the fp32-weight batched ``collect_stats``:

* ``batched_bf16`` / ``streamed_bf16`` — the bf16 decoder weights as the
  session holds them;
* ``batched_bf16_fold32`` / ``streamed_bf16_fold32`` — the same weights,
  with the probe's own copy of ``upsample2x_conv3x3`` that casts the weight
  to fp32 before it folds (patched into this process only; the package is
  not changed);
* ``streamed_fp32`` — fp32 weights, the streamed path.

It also renders the 9-frame clip with the bf16 and the fp32 weights (the
session's frames) and prints their largest uint8 difference.  The port
casts weights to the session dtype on load, so it computes the fp32
fold.  The output is one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CKPT = ROOT / "models" / "demo_plum_4000.msgpack"
TOL = 2e-4


def _clip(n=9, h=64, w=112, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


def _style(seed=1, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 5 + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255) \
        .astype(np.uint8)


def main() -> None:
    import jax
    import jax.numpy as jnp
    from flax import serialization

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")

    from rerevst_tpu.api import Stylization
    from rerevst_tpu.config import ModelConfig
    from rerevst_tpu.data.transforms import bgr_to_model
    from rerevst_tpu.models import layers
    from rerevst_tpu.models import transformer as T
    from rerevst_tpu.parallel import streaming

    raw = serialization.msgpack_restore(CKPT.read_bytes())
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), raw)
    cfg = ModelConfig()
    style = T.encode_style(f32, jnp.asarray(bgr_to_model(_style())), cfg)
    frames = np.concatenate([bgr_to_model(f) for f in _clip(n=5)])
    feats = np.asarray(T.encode_content(f32, jnp.asarray(frames), cfg))

    def fold32(p, x, precision=None):
        # layers.upsample2x_conv3x3 with the weight cast before the fold.
        return layers.upsample2x_conv3x3(
            {k: v.astype(jnp.float32) for k, v in p.items()}, x, precision)

    def stats(dec, how):
        if how == "batched":
            return T.collect_stats(dec, jnp.asarray(feats), style, cfg)
        return streaming.collect_stats_streaming(dec, feats, style, cfg,
                                                 chunk_size=2)

    def flat(s):
        out = {f"{k}.{f}": np.asarray(getattr(v, f), np.float32)
               for k, v in s.norms.items() for f in v._fields}
        out.update({k: np.asarray(v, np.float32)
                    for k, v in s.filters.items()})
        return out

    def excess(got, want):
        return {k: float(np.max(np.abs(got[k] - want[k])
                                - (TOL + TOL * np.abs(want[k]))))
                for k in want}

    ref = flat(stats(f32["decoder"], "batched"))
    runs = {}
    for name, dec, how, patch in (
            ("batched_bf16", raw["decoder"], "batched", False),
            ("streamed_bf16", raw["decoder"], "streamed", False),
            ("batched_bf16_fold32", raw["decoder"], "batched", True),
            ("streamed_bf16_fold32", raw["decoder"], "streamed", True),
            ("streamed_fp32", f32["decoder"], "streamed", False)):
        saved = (T.upsample2x_conv3x3, streaming.upsample2x_conv3x3)
        if patch:
            T.upsample2x_conv3x3 = streaming.upsample2x_conv3x3 = fold32
        try:
            ex = excess(flat(stats(dec, how)), ref)
        finally:
            T.upsample2x_conv3x3, streaming.upsample2x_conv3x3 = saved
        over = {k: v for k, v in ex.items() if v > 0}
        runs[name] = {"sites_over_bar": sorted({k.split(".")[0]
                                                for k in over}),
                      "max_excess": max(ex.values()),
                      "first_site_over": next(
                          (k for k in ref if ex[k] > 0), None)}

    # The fold alone: the res4 conv1 kernel summed in bf16 against fp32.
    w = raw["decoder"]["res4"]["conv1"]["w"]

    def spread(wt):
        k = jnp.zeros((4, 4) + wt.shape[2:], wt.dtype)
        for t1 in (0, 1):
            for t2 in (0, 1):
                k = k.at[t1:t1 + 3, t2:t2 + 3].add(wt)
        return np.asarray(k, np.float32)

    k16, k32 = spread(jnp.asarray(w)), spread(jnp.asarray(w, jnp.float32))
    fold_rel = float(np.abs(k16 - k32).max() / np.abs(k32).max())

    clips = {}
    for name, params in (("bf16", raw), ("fp32", f32)):
        s = Stylization(params=params)
        s.prepare_style(_style())
        clips[name] = np.stack(list(s.stylize_video(_clip(), batch_size=4)))
    frames_diff = int(np.abs(clips["bf16"].astype(np.int16)
                             - clips["fp32"].astype(np.int16)).max())
    print(json.dumps({"bar": "rtol=atol=2e-4 against batched fp32 weights",
                      "runs": runs,
                      "res4_conv1_fold_max_rel_change": fold_rel,
                      "frames_bf16_vs_fp32_max_counts": frames_diff}))


if __name__ == "__main__":
    main()
