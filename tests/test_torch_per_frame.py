"""rerevst_torch's per-frame graph vs rerevst_tpu: instance norms, filter
predictors, both KernelFilter branches, residual blocks, ``decode`` and its
two ablations, and ``Stylization(use_global=False)``.

fp32 on the CPU.  The default architecture runs the bundled trained
checkpoint; the ablations (no ablation checkpoint exists) run the JAX
package's decoder init for the ablated config scaled x5, on the trained
encoders' features.  Each stage gets the SAME inputs on both sides, so a
tolerance covers one stage's reassociation only: rtol 1e-4 with an atol of
2e-5 of the tensor's scale, as in tests/test_torch_model.py (measured: about
5e-6 of the scale through the whole decoder).  End to end, uint8 frames
within 1 count.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from rerevst_torch import kernels
from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig, ModelConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import layers as L
from rerevst_torch.models import transformer as T
from rerevst_tpu.api import Stylization as JaxStylization
from rerevst_tpu.config import InferenceConfig as JaxInferenceConfig
from rerevst_tpu.config import ModelConfig as JaxModelConfig
from rerevst_tpu.models import layers as jL
from rerevst_tpu.models import transformer as jT

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
ABLATIONS = {"no_filter": {"dynamic_filter": False},
             "style_only": {"both_sty_con": False}}


def _close(got, want, rtol=1e-4, scale_atol=2e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


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
def demo():
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def feats(demo):
    """(content features [2,6,8,512], JAX StyleFeatures, port StyleFeatures)
    from the trained encoders."""
    jp, _ = demo
    rng = np.random.default_rng(1)
    js = jT.encode_style(jp, jnp.asarray(_smooth_images(rng, 1, 64, 64)),
                         JaxModelConfig())
    x = np.array(jT.encode_content(
        jp, jnp.asarray(_smooth_images(rng, 2, 48, 64)), JaxModelConfig()))
    ts = T.StyleFeatures(_t(js.map), tuple(map(_t, js.means)),
                         tuple(map(_t, js.stds)))
    return x, js, ts


@pytest.fixture(scope="module")
def ablated():
    """{name: (JAX cfg, port cfg, numpy decoder params)}: the JAX init of the
    ablated decoder, x5."""
    out = {}
    for name, kw in ABLATIONS.items():
        jcfg = JaxModelConfig(**kw)
        dec = jT.init_decoder_params(jax.random.PRNGKey(0), jcfg)
        dec = jax.tree.map(lambda a: np.asarray(a, np.float32) * 5.0, dec)
        out[name] = (jcfg, ModelConfig(**kw), dec)
    return out


def test_instance_norm(feats):
    x = feats[0]
    _close(T._instance_norm(_t(x), 1e-8), jT._instance_norm(jnp.asarray(x),
                                                             1e-8))


@pytest.mark.parametrize("batch", [1, 2])
def test_predict_filter(demo, feats, batch):
    """One [P,Q] filter per content sample; at batch 1 the [1,P,Q] filter
    is per sample, not a broadcast one."""
    jp, tp = demo
    x, js, ts = feats
    ns_j = (js.map - js.means[3]) / js.stds[3]
    ns_t = (ts.map - ts.means[3]) / ts.stds[3]
    p = ("filter1", "p1")
    got = T._predict_filter(tp["decoder"][p[0]][p[1]], _t(x[:batch]), ns_t,
                            ModelConfig())
    want = jT._predict_filter(jp["decoder"][p[0]][p[1]], jnp.asarray(x[:batch]),
                              ns_j, JaxModelConfig())
    assert tuple(got.shape) == (batch, 32, 32)
    _close(got, want)


def test_predict_filter_s(feats, ablated):
    _, js, ts = feats
    jcfg, cfg, dec = ablated["style_only"]
    p = dec["filter2"]["p2"]
    got = T._predict_filter_s(from_jax_params(p, device="cpu"), ts.map, cfg)
    want = jT._predict_filter_s(p, js.map, jcfg)
    assert tuple(got.shape) == (1, 32, 32, 3, 3)
    _close(got, want)


@pytest.mark.parametrize("arch", ["default", "style_only"])
def test_kernel_filter(demo, feats, ablated, arch):
    x, js, ts = feats
    if arch == "default":
        jdec, cfg, jcfg = demo[0]["decoder"], ModelConfig(), JaxModelConfig()
    else:
        jcfg, cfg, jdec = ablated[arch]
    nc = np.array(jT._instance_norm(jnp.asarray(x), 1e-8))
    ns_j = (js.map - js.means[3]) / js.stds[3]
    got = T._kernel_filter(from_jax_params(jdec["filter1"], device="cpu"),
                           _t(nc), (ts.map - ts.means[3]) / ts.stds[3], cfg)
    want = jT._kernel_filter(jdec["filter1"], jnp.asarray(nc), ns_j, jcfg)
    _close(got, want)


def test_resblock(demo, feats):
    jp, tp = demo
    x = feats[0]
    got = T._resblock(tp["decoder"]["res4"], _t(x), ModelConfig())
    want = jT._resblock(jp["decoder"]["res4"], jnp.asarray(x), JaxModelConfig())
    assert tuple(got.shape) == (2, 12, 16, 256)
    _close(got, want)


@pytest.mark.parametrize("fbatch,xbatch", [(1, 1), (1, 3), (3, 3)])
def test_apply_dynamic_filter_3x3(rng, fbatch, xbatch):
    x = rng.standard_normal((xbatch, 5, 7, 8)).astype(np.float32)
    f = rng.standard_normal((fbatch, 6, 8, 3, 3)).astype(np.float32)
    got = L.apply_dynamic_filter_3x3(_t(x), _t(f))
    want = jL.apply_dynamic_filter_3x3(jnp.asarray(x), jnp.asarray(f))
    assert tuple(got.shape) == (xbatch, 5, 7, 6)
    _close(got, want)
    # f16 storage: fp32 math, the output rounded once.
    got16 = L.apply_dynamic_filter_3x3(_t(x).half(), _t(f) * 1e3)
    assert got16.dtype == torch.float16
    ref = L.apply_dynamic_filter_3x3(_t(x).half().float(), _t(f) * 1e3)
    np.testing.assert_array_equal(got16.numpy(), ref.half().numpy())


@pytest.mark.parametrize("batch", [1, 2])
def test_apply_dynamic_filter_per_sample(rng, batch):
    """[B,P,Q] filters, one per sample, at B = 1 and B > 1."""
    x = rng.standard_normal((batch, 4, 5, 32)).astype(np.float32)
    f = rng.standard_normal((batch, 32, 32)).astype(np.float32)
    _close(L.apply_dynamic_filter(_t(x), _t(f)),
           jL.apply_dynamic_filter(jnp.asarray(x), jnp.asarray(f)))


def test_decode(demo, feats):
    jp, tp = demo
    x, js, ts = feats
    kernels.reset_launches()
    got = T.decode(tp["decoder"], _t(x), ts, ModelConfig())
    want = jT.decode(jp["decoder"], jnp.asarray(x), js, JaxModelConfig())
    assert tuple(got.shape) == (2, 48, 64, 3)
    _close(got, want)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch", sorted(ABLATIONS))
def test_decode_ablation(feats, ablated, arch):
    x, js, ts = feats
    jcfg, cfg, dec = ablated[arch]
    assert ("filter1" in dec) == cfg.dynamic_filter
    got = T.decode(from_jax_params(dec, device="cpu"), _t(x), ts, cfg)
    want = jT.decode(dec, jnp.asarray(x), js, jcfg)
    _close(got, want)


def _clip(n=5, h=64, w=112, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255).astype(np.uint8)
            for i in range(n)]


def _style(seed=1, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 5 + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1) + rng.normal(0, 10, (size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_stylization_per_frame_matches_jax():
    params = serialization.msgpack_restore(CKPT.read_bytes())
    js = JaxStylization(params=params, use_global=False,
                        infer=JaxInferenceConfig(use_global=False))
    js.prepare_style(_style())
    want = list(js.stylize_video(_clip(), batch_size=4))
    s = Stylization(params=params, use_global=False, device="cpu")
    s.prepare_style(_style())
    ups = []
    up = s._upload
    s._upload = lambda x: ups.append(x.shape) or up(x)
    got = list(s.stylize_video(_clip(), batch_size=4))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape == (64, 112, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
    assert np.stack(got).std() > 1.0
    # No Pass 1: only the two padded Pass-2 batches go up (the ragged tail
    # padded to the batch shape); nothing is frozen.
    assert ups == [(4, 192, 256, 3)] * 2
    assert s.stats is None and s.pass1_mode is None
    assert s.pass2_mode == js.pass2_mode == "per-frame"
    # transfer() needs no compute() in per-frame mode.
    one = s.transfer(_clip(n=1)[0])
    assert np.abs(one.astype(np.int16) - got[0].astype(np.int16)).max() <= 1


@pytest.mark.parametrize("arch", sorted(ABLATIONS))
def test_global_mode_rejects_ablations(arch):
    with pytest.raises(ValueError, match="use_global=False"):
        Stylization(params={"decoder": {}}, cfg=ModelConfig(**ABLATIONS[arch]),
                    device="cpu")
    s = Stylization(params={"decoder": {}}, cfg=ModelConfig(**ABLATIONS[arch]),
                    use_global=False, device="cpu")
    assert not s.use_global
