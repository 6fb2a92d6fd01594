"""rerevst_torch.multistyle and rerevst_torch.interpolate against the JAX
package's multi-style interpolation.

Geometry: a seeded 9-frame 64x112 clip (reflect-padded to 192x256, since
multi-style Pass 1 encodes padded frames), three seeded 64x64 styles, the
bundled checkpoint in fp32 sessions of both packages.  Tolerances: blended
trees to 1e-6 relative (the same fp32 products; the batched blend sums in
another order); frames within 1 uint8 count (the fp32 pipelines differ by
about 1e-6 of the pixel scale, which flips an occasional rounding).
"""

import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import interpolate
from rerevst_torch.config import InferenceConfig, ModelConfig
from rerevst_torch.models.transformer import (
    NormStats,
    SeqStats,
    StyleFeatures,
    blend_pytrees,
    blend_pytrees_batched,
)
from rerevst_torch.multistyle import MultiStylization, linear_sweep_weights
from rerevst_torch.parallel import frame_mesh
from rerevst_tpu import interpolate as jax_interpolate
from rerevst_tpu.models import transformer as jtr
from rerevst_tpu.multistyle import MultiStylization as JaxMultiStylization
from rerevst_tpu.multistyle import linear_sweep_weights as jax_sweep

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
INFER = InferenceConfig(sample_interval=4)
ROWS2 = [[0.3, 0.7]]
ROWS3 = [[0.2, 0.5, 0.3]]


def _clip(n=9, h=64, w=112, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


def _styles(k=3, size=64):
    out = []
    for seed in range(k):
        rng = np.random.default_rng(10 + seed)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        img = np.stack([128 + 90 * np.sin(xx / (4 + seed + c) + c)
                        * np.cos(yy / (6 + 2 * seed) - c)
                        for c in range(3)], -1)
        img += rng.normal(0, 10, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _close(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype == np.uint8
        d = np.abs(x.astype(np.int16) - y.astype(np.int16)).max()
        assert d <= 1, f"{what} frame {i} off by {d}"


@pytest.fixture(scope="module")
def params():
    return serialization.msgpack_restore(CKPT.read_bytes())


def _run(cls, params, k, **kw):
    """Both packages' sessions drive the same calls: interpolate_video with
    the linear sweep at batch 4 (the ragged tail padded), then transfer and
    transfer_batch on features from encode_frames."""
    ms = cls(params=params, infer=INFER, **kw)
    ms.prepare_styles(_styles(k))
    clip = _clip()
    video = list(ms.interpolate_video(clip, batch_size=4))
    ms._pad_hw = None
    feats = ms.encode_frames(clip)
    ms.prepare_global(feats)
    rows = ROWS2 if k == 2 else ROWS3
    one = ms.transfer(feats[2:3], rows[0])
    batch = ms.transfer_batch(feats[:3], rows * 3)
    return {"video": video, "transfer": [one], "transfer_batch": batch}


@pytest.fixture(scope="module", params=[2, 3], ids=["2styles", "3styles"])
def both(request, params):
    k = request.param
    return k, _run(JaxMultiStylization, params, k), \
        _run(MultiStylization, params, k, device="cpu")


@pytest.mark.parametrize("n,k", [(1, 2), (5, 2), (9, 3), (17, 4), (4, 1)])
def test_linear_sweep_weights_matches_jax(n, k):
    assert linear_sweep_weights(n, k) == jax_sweep(n, k)


def _trees(rng, k):
    """k StyleFeatures and k SeqStats with random fp32 leaves, as numpy."""
    out = []
    for _ in range(k):
        sf = StyleFeatures(rng.standard_normal((1, 4, 4, 8)),
                           tuple(rng.standard_normal((1, 1, 1, c))
                                 for c in (2, 4, 6, 8)),
                           tuple(rng.random((1, 1, 1, c)) for c in (2, 4, 6, 8)))
        st = SeqStats({s: NormStats(*(rng.standard_normal((1, 1, 1, 8))
                                      for _ in range(4)))
                       for s in ("pre", "ada4")},
                      {f: rng.standard_normal((1, 4, 4)) for f in ("f1a", "f1b")})
        out.append((sf, st))
    return out


def _as(tree, conv, cls_sf, cls_ns, cls_st):
    sf, st = tree
    return (cls_sf(conv(sf.map), tuple(map(conv, sf.means)),
                   tuple(map(conv, sf.stds))),
            cls_st({k: cls_ns(*map(conv, v)) for k, v in st.norms.items()},
                   {k: conv(v) for k, v in st.filters.items()}))


@pytest.mark.parametrize("k", [2, 3])
def test_blend_pytrees_matches_jax(k):
    rng = np.random.default_rng(k)
    raw = [tuple(_as(t, lambda a: a.astype(np.float32), StyleFeatures,
                     NormStats, SeqStats)) for t in _trees(rng, k)]
    ours = [_as(t, torch.from_numpy, StyleFeatures, NormStats, SeqStats)
            for t in raw]
    theirs = [_as(t, jnp.asarray, jtr.StyleFeatures, jtr.NormStats,
                  jtr.SeqStats) for t in raw]
    w = rng.random(k).astype(np.float32)
    rows = rng.random((5, k)).astype(np.float32)
    for i in (0, 1):  # StyleFeatures, then SeqStats
        got = blend_pytrees([t[i] for t in ours], list(w))
        want = jtr.blend_pytrees([t[i] for t in theirs],
                                 [jnp.asarray(v) for v in w])
        gotb = blend_pytrees_batched([t[i] for t in ours], rows)
        wantb = jtr.blend_pytrees_batched([t[i] for t in theirs], rows)
        for g, wv in ((got, want), (gotb, wantb)):
            gl, wl = _leaves(g), _leaves(wv)
            assert len(gl) == len(wl) > 0
            for a, b in zip(gl, wl):
                assert a.dtype == torch.float32 and a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
    st = blend_pytrees_batched([t[1] for t in ours], rows)
    assert st.norms["pre"].mean.shape == (5, 1, 1, 8)
    assert st.filters["f1a"].shape == (5, 4, 4)


def _leaves(tree):
    if hasattr(tree, "shape"):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


@pytest.mark.parametrize("what", ["video", "transfer", "transfer_batch"])
def test_matches_jax_multistylization(both, what):
    k, jax_out, ours = both
    _close(ours[what], jax_out[what], f"{k} styles {what}")
    assert np.stack(ours[what]).std() > 1.0


def test_batched_equals_unbatched(params):
    """interpolate_video at batch 4 (per-sample route, tail padded) gives
    the frames of batch 1, and transfer_batch those of per-frame transfer
    (the shared route)."""
    ms = MultiStylization(params=params, infer=INFER, device="cpu")
    ms.prepare_styles(_styles(2))
    clip = _clip(n=5)
    a = list(ms.interpolate_video(clip, batch_size=1))
    ms._pad_hw = None
    b = list(ms.interpolate_video(clip, batch_size=4))
    _close(a, b, "interpolate_video")
    feats = ms.encode_frames(clip)
    rows = [[1.0, 0.0], [0.4, 0.6], [0.0, 1.0]]
    _close(ms.transfer_batch(feats[:3], rows),
           [ms.transfer(feats[i:i + 1], rows[i]) for i in range(3)],
           "transfer_batch")


def test_feature_cache_roundtrip(params, tmp_path):
    ms = MultiStylization(params=params, infer=INFER, device="cpu")
    ms.prepare_styles(_styles(2))
    clip = _clip(n=3)
    path = str(tmp_path / "feats.npy")
    cached = ms.encode_frames(clip, cache_path=path)
    meta = json.load(open(path + ".meta.json"))
    assert meta == {"orig_hw": [64, 112], "pad_hw": [192, 256], "pad": 64}
    fresh = MultiStylization(params=params, infer=INFER, device="cpu")
    fresh.styles = ms.styles
    feats = fresh.load_features(path)
    np.testing.assert_array_equal(feats, cached)
    assert fresh._orig_hw == (64, 112) and fresh._pad_hw == (192, 256)
    fresh.prepare_global(feats)
    assert fresh.transfer(feats[0:1], [0.5, 0.5]).shape == (64, 112, 3)


def test_mesh_and_bad_weights_raise(params):
    """A mesh session (two logical CPU shards: per-style Pass 1 sharded, a
    one-frame decode H-sharded, a batch decode batch-sharded) gives the
    unmeshed session's frames; bad weights raise."""
    mesh = frame_mesh(2, devices=["cpu", "cpu"])
    got = []
    for m in (mesh, None):
        ms = MultiStylization(params=params, infer=INFER, mesh=m,
                              device="cpu")
        ms.prepare_styles(_styles(2))
        feats = ms.encode_frames(_clip(n=3))
        ms.prepare_global(feats)
        got.append([ms.transfer(feats[2:3], ROWS2[0])]
                   + ms.transfer_batch(feats[:2], ROWS2 * 2))
    mesh.close()
    _close(got[0], got[1], "mesh session")
    ms = MultiStylization(params=params, infer=INFER, device="cpu")
    ms.prepare_styles(_styles(2))
    with pytest.raises(ValueError, match="rows"):
        list(ms.interpolate_video(_clip(n=3), weights=[[1.0, 0.0]]))
    with pytest.raises(ValueError, match="weights"):
        ms.transfer(torch.zeros(1, 24, 32, 512), [1.0])


@pytest.fixture(scope="module")
def png_inputs(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("interp_in")
    for i, f in enumerate(_clip(n=5)):
        cv2.imwrite(str(d / f"f{i + 1:03d}.png"), f)
    styles = []
    for i, s in enumerate(_styles(2)):
        styles.append(str(d / f"style{i}.png"))
        cv2.imwrite(styles[-1], s)
    return str(d / "f*.png"), styles


def test_interpolate_cli_matches_jax(png_inputs, tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    frames, styles = png_inputs
    args = ["--styles", *styles, "--frames", frames, "--checkpoint",
            str(CKPT), "--interval", "2", "--style-size", "64"]
    reports, outs = {}, {}
    for name, main, extra in (("jax", jax_interpolate.main, []),
                              ("torch", interpolate.main,
                               ["--device", "cpu"])):
        out = str(tmp_path / name)
        main(args + ["-o", out] + extra)
        reports[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        outs[name] = sorted(glob.glob(os.path.join(out, "*.png")))
    assert reports["torch"]["frames"] == reports["jax"]["frames"] == 5
    assert [os.path.basename(p) for p in outs["torch"]] == \
        [os.path.basename(p) for p in outs["jax"]]
    _close([cv2.imread(p) for p in outs["torch"]],
           [cv2.imread(p) for p in outs["jax"]], "CLI")


def test_interpolate_cli_unported_options_raise(png_inputs, tmp_path):
    """``--devices 2`` (two logical CPU shards) gives the frames of one
    device; ``--dtype f16 --mix out`` gives the frames of the same
    interpolation through a direct session with ``fp32_mix='out'``."""
    cv2 = pytest.importorskip("cv2")
    frames, styles = png_inputs
    base = ["--styles", *styles, "--frames", frames, "--checkpoint",
            str(CKPT), "--interval", "2", "--style-size", "64", "--device",
            "cpu"]
    outs = []
    for name, extra in (("one", []), ("mesh", ["--devices", "2"])):
        interpolate.main(base + ["-o", str(tmp_path / name)] + extra)
        outs.append([cv2.imread(p) for p in sorted(
            glob.glob(str(tmp_path / name / "*.png")))])
    assert len(outs[0]) == 5
    _close(outs[1], outs[0], "--devices 2")
    interpolate.main(base + ["-o", str(tmp_path / "mix"), "--dtype", "f16",
                             "--mix", "out"])
    got = [cv2.imread(p) for p in sorted(
        glob.glob(str(tmp_path / "mix" / "*.png")))]
    ms = MultiStylization(checkpoint=str(CKPT), device="cpu",
                          cfg=ModelConfig(dtype=torch.float16,
                                          fp32_mix="out"),
                          infer=InferenceConfig(sample_interval=2))
    ms.prepare_styles([cv2.resize(cv2.imread(s), (64, 64)) for s in styles])
    want = list(ms.interpolate_video(frames))
    _close(got, want, "--mix out")
