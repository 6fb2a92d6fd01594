"""rerevst_torch.models.transformer vs rerevst_tpu: style encoder, Pass-1
statistics (11 NormStats + 6 filters) and the global decoder, at full width
on a small geometry, fp32, with the bundled trained checkpoint (a random
0.02-gain decoder would amplify fp noise through rsqrt).

Inputs are smooth seeded images (natural-image-like statistics).  Each stage
is fed the SAME inputs on both sides, so a tolerance covers one stage's
reassociation only: fp32 convs sum in other orders in XLA and PyTorch; the
largest difference measured over the decoder's ~20 convs and 11
normalizations is 5e-6 of a tensor's scale, so each check allows rtol 1e-4
with an atol of 2e-5 of the tensor's scale.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from rerevst_torch import kernels
from rerevst_torch.config import ModelConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import transformer as T
from rerevst_tpu.config import ModelConfig as JaxModelConfig
from rerevst_tpu.models import transformer as jT

REPO = Path(__file__).resolve().parent.parent
CFG, JCFG = ModelConfig(), JaxModelConfig()
NORM_KEYS = ["pre", "ada4", "ada3", "ada2", "ada1", "res4a", "res4b",
             "res3a", "res3b", "res2a", "res2b"]


def _close(got, want, rtol=1e-4, scale_atol=2e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _smooth_images(rng, n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.03, 0.2, (3, 2))
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([0.5 + 0.4 * np.sin(xx * f[c, 0] + yy * f[c, 1] + ph[c])
                        for c in range(3)], -1)
        out.append((img - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225])
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    tree = serialization.msgpack_restore(
        (REPO / "models" / "demo_plum_4000.msgpack").read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def style_pair(models):
    jp, tp = models
    s = _smooth_images(np.random.default_rng(1), 1, 64, 64)
    return (jT.encode_style(jp, jnp.asarray(s), JCFG),
            T.encode_style(tp, torch.from_numpy(s), CFG))


def _to_port_style(js):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.StyleFeatures(t(js.map), tuple(map(t, js.means)),
                           tuple(map(t, js.stds)))


def _to_port_stats(jst):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.SeqStats({k: T.NormStats(*map(t, v)) for k, v in jst.norms.items()},
                      {k: t(v) for k, v in jst.filters.items()})


def test_encode_style(style_pair):
    js, ts = style_pair
    _close(ts.map, js.map, 1e-4, 1e-5)
    for a, b in zip(ts.means + ts.stds, js.means + js.stds):
        assert tuple(a.shape) == b.shape
        _close(a, b, 1e-4, 1e-5)


def test_encode_content(models):
    jp, tp = models
    x = _smooth_images(np.random.default_rng(2), 2, 48, 64)
    _close(T.encode_content(tp, torch.from_numpy(x), CFG),
           jT.encode_content(jp, jnp.asarray(x), JCFG), 1e-4, 1e-5)


@pytest.fixture(scope="module")
def pass1(models, style_pair):
    jp, tp = models
    js, _ = style_pair
    x = _smooth_images(np.random.default_rng(3), 3, 64, 80)
    feats = np.array(jT.encode_content(jp, jnp.asarray(x), JCFG))
    jst = jT.collect_stats(jp["decoder"], jnp.asarray(feats), js, JCFG)
    tst = T.collect_stats(tp["decoder"], torch.from_numpy(feats),
                          _to_port_style(js), CFG)
    return feats, jst, tst


@pytest.mark.parametrize("key", NORM_KEYS)
def test_collect_stats_norms(pass1, key):
    _, jst, tst = pass1
    assert sorted(tst.norms) == sorted(NORM_KEYS) == sorted(jst.norms)
    for got, want in zip(tst.norms[key], jst.norms[key]):
        assert got.dtype == torch.float32
        _close(got, want)


def test_collect_stats_filters(pass1):
    _, jst, tst = pass1
    assert sorted(tst.filters) == sorted(jst.filters)
    assert len(tst.filters) == 6
    for k, want in jst.filters.items():
        got = tst.filters[k]
        assert tuple(got.shape) == (1, 32, 32) and got.dtype == torch.float32
        _close(got, want)


def test_decode_global(models, style_pair, pass1):
    jp, tp = models
    js, _ = style_pair
    feats, jst, _ = pass1
    x = feats[:2]
    want = jT.decode_global(jp["decoder"], jnp.asarray(x), js, jst, JCFG)
    kernels.reset_launches()
    got = T.decode_global(tp["decoder"], torch.from_numpy(x),
                          _to_port_style(js), _to_port_stats(jst), CFG)
    assert tuple(got.shape) == (2, 64, 80, 3)
    _close(got, want)
    # The CPU path computes the kernels' plain versions: nothing launched.
    assert kernels.launch_counts() == {"norm_affine_clamp": 0,
                                       "dynamic_filter_pair": 0}


def test_decode_global_f16_runs_plain_chain(models, style_pair, pass1):
    """f16 storage on the CPU: the frozen stats and filters stay fp32, the
    output is finite and close to the fp32 decode."""
    _, tp = models
    js, _ = style_pair
    feats, jst, _ = pass1
    p16 = from_jax_params(tp, dtype=torch.float16, device="cpu")
    st = _to_port_style(js)
    st16 = T.StyleFeatures(st.map.half(), tuple(v.half() for v in st.means),
                           tuple(v.half() for v in st.stds))
    cfg16 = CFG.with_dtype(torch.float16)
    x = torch.from_numpy(feats[:1])
    got = T.decode_global(p16["decoder"], x.half(), st16,
                          _to_port_stats(jst), cfg16)
    ref = T.decode_global(tp["decoder"], x, st, _to_port_stats(jst), CFG)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert (got.float() - ref).abs().mean() < 2e-2 * ref.abs().mean()
