"""Long-clip Pass 1: rerevst_torch's host spool and streaming collection
against rerevst_tpu's.

Geometry: seeded 64x112 frames (relu4_1 features 8x14x512), the bundled
checkpoint upcast to fp32 in both packages.  The JAX reference runs once,
in its own process: this file run as a script (``_jax_reference`` says
why).

Tolerances: streamed statistics against the JAX package's streamed ones and
against the port's batched ``collect_stats`` at rtol = atol = 2e-4, the
JAX package's own bar for streamed against batched
(``tests/test_parallel.py``): the sums run in other orders (per-chunk
Welford merges against one pass).  Frames within 1 uint8 count, the
ROADMAP's end-to-end bar.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import api
from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig
from rerevst_torch.data.transforms import bgr_to_model
from rerevst_torch.models.transformer import collect_stats
from rerevst_torch.parallel.streaming import STAGES, collect_stats_streaming

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
# The spilled sessions of both packages: 5 samples of 9 frames, chunks of 2,
# the threshold lowered to 2, Pass 2 at batch 4.
INFER = InferenceConfig(sample_interval=2, pass1_chunk=2)
THRESHOLD, BATCH = 2, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_reference(inp: str, out: str) -> None:
    """The JAX side, in its own process:

        XLA_FLAGS=--xla_disable_hlo_passes=constant_folding \\
            python tests/test_torch_streaming.py IN.npz OUT.npz

    ``rerevst_tpu.parallel.streaming`` jits one prefix per stage with the
    decoder weights closed over as constants, and XLA's constant folding of
    the folded upsample kernels takes minutes per stage on a CPU; without
    that one pass the same programs compile in seconds.  The flag is read
    once per process, so the reference runs in a process of its own.

    IN.npz holds ``feats`` (sampled relu4_1 features), ``clip`` (BGR uint8
    frames) and ``style``; OUT.npz gets the streamed statistics of
    ``feats`` (``norms/<site>/<field>``, ``filters/<key>``) and the frames
    of a spilled ``stylize_video`` of ``clip`` (``frames``,
    ``pass1_mode``)."""
    import jax

    from rerevst_tpu.api import Stylization as JaxStylization
    from rerevst_tpu.config import InferenceConfig as JaxInferenceConfig
    from rerevst_tpu.parallel.streaming import (
        collect_stats_streaming as jax_collect_stats_streaming,
    )

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    data = np.load(inp)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          serialization.msgpack_restore(CKPT.read_bytes()))
    s = JaxStylization(params=params, infer=JaxInferenceConfig(
        sample_interval=INFER.sample_interval, pass1_chunk=INFER.pass1_chunk))
    s.prepare_style(data["style"])
    stats = jax_collect_stats_streaming(s.params["decoder"], data["feats"],
                                        s.style, s.cfg,
                                        chunk_size=INFER.pass1_chunk)
    res = {f"norms/{k}/{f}": np.asarray(getattr(v, f))
           for k, v in stats.norms.items() for f in v._fields}
    res.update({f"filters/{k}": np.asarray(v)
                for k, v in stats.filters.items()})
    JaxStylization.STREAMING_THRESHOLD = THRESHOLD
    res["frames"] = np.stack(list(s.stylize_video(list(data["clip"]),
                                                  batch_size=BATCH)))
    res["pass1_mode"] = np.asarray(s.pass1_mode)
    np.savez(out, **res)


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


def _session(params, infer=INFER, **kw):
    s = Stylization(params=params, device="cpu", infer=infer, **kw)
    s.prepare_style(_style())
    return s


@pytest.fixture(scope="module")
def params():
    tree = serialization.msgpack_restore(CKPT.read_bytes())

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        return np.asarray(t, np.float32)

    return up(tree)


@pytest.fixture(scope="module")
def feats(params):
    s = _session(params)
    with torch.inference_mode():
        return torch.cat([s._encode(s._upload(bgr_to_model(f)))
                          for f in _clip(n=5)]).numpy()


@pytest.fixture(scope="module")
def jax_ref(feats, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ref")
    np.savez(d / "in.npz", feats=feats, clip=np.stack(_clip()),
             style=_style())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=constant_folding",
               PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, __file__, str(d / "in.npz"),
                    str(d / "out.npz")], check=True, env=env, cwd=REPO,
                   timeout=600)
    return dict(np.load(d / "out.npz"))


def _leaves(stats):
    out = {f"norms/{k}/{f}": getattr(v, f).numpy()
           for k, v in stats.norms.items() for f in v._fields}
    out.update({f"filters/{k}": v.numpy() for k, v in stats.filters.items()})
    return out


def test_streaming_matches_jax_streaming(params, feats, jax_ref):
    s = _session(params)
    got = _leaves(collect_stats_streaming(s.params["decoder"], feats, s.style,
                                          s.cfg, chunk_size=2))
    want = {k: v for k, v in jax_ref.items() if "/" in k}
    assert set(got) == set(want) and len(got) == 11 * 4 + 6
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_streaming_matches_batched(params, feats, chunk):
    s = _session(params)
    streamed = collect_stats_streaming(s.params["decoder"], feats, s.style,
                                       s.cfg, chunk_size=chunk)
    with torch.inference_mode():
        batched = collect_stats(s.params["decoder"], torch.from_numpy(feats),
                                s.style, s.cfg)
    got, want = _leaves(streamed), _leaves(batched)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert len(STAGES) == 14


def test_spilled_stylize_video_matches_jax(params, jax_ref, monkeypatch):
    monkeypatch.setattr(Stylization, "STREAMING_THRESHOLD", THRESHOLD)
    s = _session(params)
    got = np.stack(list(s.stylize_video(_clip(), batch_size=BATCH)))
    assert s.pass1_mode == "streaming-spill" == str(jax_ref["pass1_mode"])
    assert got.shape == jax_ref["frames"].shape == (9, 64, 112, 3)
    d = np.abs(got.astype(np.int16) - jax_ref["frames"].astype(np.int16))
    assert d.max() <= 1
    assert got.std() > 1.0


def test_65_sample_add_session(params):
    """65 add()s cross STREAMING_THRESHOLD: the 65th drains the device
    buffer into the spool, compute() streams, and the statistics match a
    prepare_global over the same 65 frames (which spills too).  Chunks of
    32 samples (3 a stream): ``test_streaming_matches_batched`` covers the
    small chunks."""
    frames = _clip(n=65, seed=3)
    s = _session(params, infer=InferenceConfig(sample_interval=2,
                                               pass1_chunk=32))
    for f in frames[:64]:
        s.add(f)
    assert s._patch_spill is None and len(s._patches) == 64
    s.add(frames[64])
    assert s._patch_spill is not None and s._patch_spill.n == 65
    assert not s._patches
    s.compute()
    assert s.pass1_mode == "streaming-spill" and s._patch_spill is None
    added = _leaves(s.stats)
    s.prepare_global(frames)
    assert s.pass1_mode == "streaming-spill"
    for k, v in _leaves(s.stats).items():
        np.testing.assert_allclose(added[k], v, err_msg=k, **TOL)


def test_unsized_generator_spills(params, monkeypatch):
    """An iterable without a length, even a short one, takes the spool; it
    gives what a sized list that spills gives, bit for bit."""
    frames = _clip(n=5)
    s = _session(params)
    s.prepare_global(f for f in frames)
    assert s.pass1_mode == "streaming-spill"
    from_gen = _leaves(s.stats)
    monkeypatch.setattr(Stylization, "STREAMING_THRESHOLD", 0)
    s.prepare_global(frames)
    assert s.pass1_mode == "streaming-spill"
    for k, v in _leaves(s.stats).items():
        np.testing.assert_array_equal(from_gen[k], v, err_msg=k)
    with pytest.raises(ValueError, match="no frames"):
        s.prepare_global(f for f in [])


def test_spool_removed_after_compute_and_clean(params, monkeypatch):
    made = []
    real = api._FeatureSpill

    class Recording(real):
        def __init__(self):
            super().__init__()
            made.append(self.path)

    monkeypatch.setattr(api, "_FeatureSpill", Recording)
    monkeypatch.setattr(Stylization, "STREAMING_THRESHOLD", 2)
    frames = _clip(n=3)
    s = _session(params)
    for f in frames:
        s.add(f)
    assert len(made) == 1 and os.path.exists(made[0])
    s.compute()
    assert not os.path.exists(made[0])
    for f in frames:
        s.add(f)
    assert len(made) == 2 and os.path.exists(made[1])
    s.clean()
    assert not os.path.exists(made[1]) and s._patch_spill is None
    s.prepare_global(frames)
    assert len(made) == 3 and not os.path.exists(made[2])


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
