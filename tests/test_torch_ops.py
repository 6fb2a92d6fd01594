"""rerevst_torch ops, layers and VGG encoder vs their rerevst_tpu counterparts.

Inputs come from a seeded numpy generator and go to both packages; the port
runs on the CPU in fp32 (conftest pins JAX to fp32 products).  Tolerances:
elementwise ops agree to fp32 rounding (rtol 1e-6); convolutions and matmuls
sum in other orders in XLA and in PyTorch's CPU kernels, so they agree to
rtol 1e-5 with an atol of 1e-5 times the output's scale.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.data import transforms as T
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import layers as L
from rerevst_torch.models import vgg as V
from rerevst_torch.ops import image as I
from rerevst_torch.ops import resize as R
from rerevst_torch.ops import stats as S
from rerevst_tpu.data import transforms as jT
from rerevst_tpu.models import layers as jL
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.ops import image as jI
from rerevst_tpu.ops import resize as jR
from rerevst_tpu.ops import stats as jS

REPO = Path(__file__).resolve().parent.parent
HIGHEST = lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def ckpt():
    """The bundled checkpoint, upcast to fp32, for both packages."""
    tree = serialization.msgpack_restore(
        (REPO / "models" / "demo_plum_4000.msgpack").read_bytes())
    jax_p = {k: {n: {kk: np.asarray(vv, np.float32) for kk, vv in c.items()}
                 for n, c in v.items()}
             for k, v in tree.items() if k.startswith("encoder")}
    return jax_p, from_jax_params(jax_p, device="cpu")


class TestImage:
    def test_normalize_roundtrip(self, rng):
        img = rng.random((2, 5, 7, 3)).astype(np.float32)
        _close(I.normalize(_t(img)), jI.normalize(jnp.asarray(img)), 1e-6)
        x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
        _close(I.denormalize(_t(x)), jI.denormalize(jnp.asarray(x)), 1e-6)
        u8 = (rng.random((1, 3, 4, 3)) * 255).astype(np.uint8)
        assert I.normalize(_t(u8)).dtype == torch.float32
        _close(I.normalize(_t(u8)), jI.normalize(jnp.asarray(u8)), 1e-6)

    def test_luma_reversed(self, rng):
        x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
        got = I.rgb_to_luma_reversed(_t(x))
        _close(got, jI.rgb_to_luma_reversed(jnp.asarray(x)), 1e-6, 1e-6)
        d = I.denormalize(got)
        assert torch.allclose(d[..., 0], d[..., 2], atol=1e-6)

    @pytest.mark.parametrize("hw", [(436, 1024), (512, 512), (64, 112),
                                    (100, 37)])
    def test_padded_size(self, hw):
        for pad, gran in ((64, 64), (16, 32)):
            assert I.padded_size(*hw, pad, gran) == \
                jI.padded_size(*hw, pad, gran)

    @pytest.mark.parametrize("hw", [(64, 112), (64, 80), (30, 200)])
    def test_validate_pad_geometry(self, hw):
        try:
            jI.validate_pad_geometry(*hw)
            want = None
        except ValueError as e:
            want = e
        if want is None:
            I.validate_pad_geometry(*hw)
        else:
            with pytest.raises(ValueError, match="too small"):
                I.validate_pad_geometry(*hw)

    def test_pad_reflect_crop(self, rng):
        x = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
        want = np.asarray(jI.pad_reflect_multiple(x, 8, 16))
        got = I.pad_reflect_multiple(x, 8, 16)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            I.pad_reflect_multiple(x, 8, 16, (32, 48)),
            np.asarray(jI.pad_reflect_multiple(x, 8, 16, (32, 48))))
        np.testing.assert_array_equal(I.crop_back(got, 9, 13, 8), x)

    def test_to_uint8(self, rng):
        x = (rng.standard_normal((1, 8, 8, 3)) * 2).astype(np.float32)
        np.testing.assert_array_equal(I.to_uint8(_t(x)).numpy(),
                                      np.asarray(jI.to_uint8(jnp.asarray(x))))

    def test_transforms(self, rng):
        bgr = (rng.random((7, 9, 3)) * 255).astype(np.uint8)
        np.testing.assert_array_equal(T.bgr_to_model(bgr),
                                      jT.bgr_to_model(bgr))
        x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
        np.testing.assert_array_equal(T.model_to_bgr(x), jT.model_to_bgr(x))


class TestStats:
    @pytest.mark.parametrize("axes", [(1, 2), (0, 1, 2)])
    def test_instance_moments(self, rng, axes):
        x = (rng.standard_normal((3, 6, 5, 8)) * 3 + 2).astype(np.float32)
        m, r = S.instance_moments(_t(x), axes, 1e-8)
        jm, jr = jS.instance_moments(jnp.asarray(x), axes, 1e-8)
        _close(m, jm, 1e-6, 1e-6)
        _close(r, jr, 1e-5)

    @pytest.mark.parametrize("dtype", [np.float32, np.float16])
    def test_mean_std_unbiased(self, rng, dtype):
        x = rng.standard_normal((2, 5, 4, 6)).astype(dtype)
        m, s = S.mean_std(_t(x), 1e-5)
        jm, js = jS.mean_std(jnp.asarray(x), 1e-5)
        assert m.dtype == s.dtype == _t(x).dtype
        tol = 1e-6 if dtype == np.float32 else 1e-3
        _close(m.float(), np.asarray(jm, np.float32), tol, tol)
        _close(s.float(), np.asarray(js, np.float32), tol, tol)
        # unbiased: matches torch.var's default
        want = torch.sqrt(_t(x).float().reshape(2, 20, 6).var(1) + 1e-5)
        _close(s.float().reshape(2, 6), want.numpy(), 1e-3 if tol > 1e-6
               else 1e-6)

    def test_channel_minmax(self, rng):
        x = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
        for got, want in zip(S.channel_minmax(_t(x)),
                             jS.channel_minmax(jnp.asarray(x))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_upsample_nearest(self, rng):
        x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
        got = R.upsample_nearest_2x(_t(x))
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jR.upsample_nearest_2x(jnp.asarray(x))))


def _conv_params(rng, kh, cin, cout, bias=True):
    p = {"w": (rng.standard_normal((kh, kh, cin, cout)) * 0.2)
         .astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(cout).astype(np.float32)
    return p


class TestLayers:
    @pytest.mark.parametrize("kh,pad,bias", [(3, 1, True), (1, 0, False),
                                             (3, 0, True)])
    def test_conv2d(self, rng, kh, pad, bias):
        p = _conv_params(rng, kh, 6, 5, bias)
        x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
        got = L.conv2d({k: _t(v) for k, v in p.items()}, _t(x), padding=pad)
        assert got.is_contiguous()
        _close(got, jL.conv2d(p, jnp.asarray(x), padding=pad,
                              precision=HIGHEST))

    def test_linear_leaky_pool(self, rng):
        p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32)}
        x = rng.standard_normal((3, 6)).astype(np.float32)
        _close(L.linear({k: _t(v) for k, v in p.items()}, _t(x)),
               jL.linear(p, jnp.asarray(x), precision=HIGHEST))
        y = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
        np.testing.assert_array_equal(L.leaky_relu(_t(y)).numpy(),
                                      np.asarray(jL.leaky_relu(jnp.asarray(y))))
        np.testing.assert_array_equal(
            L.max_pool_2x2(_t(y)).numpy(),
            np.asarray(jL.max_pool_2x2(jnp.asarray(y))))

    @pytest.mark.parametrize("bias", [True, False])
    def test_upsample2x_convs(self, rng, bias):
        x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
        p3 = _conv_params(rng, 3, 8, 4, bias)
        _close(L.upsample2x_conv3x3({k: _t(v) for k, v in p3.items()}, _t(x)),
               jL.upsample2x_conv3x3(p3, jnp.asarray(x), precision=HIGHEST))
        p1 = _conv_params(rng, 1, 8, 4, bias)
        _close(L.upsample2x_conv1x1({k: _t(v) for k, v in p1.items()}, _t(x)),
               jL.upsample2x_conv1x1(p1, jnp.asarray(x), precision=HIGHEST))

    @pytest.mark.parametrize("batch_filter", [1, 2])
    def test_apply_dynamic_filter(self, rng, batch_filter):
        x = rng.standard_normal((2, 4, 5, 32)).astype(np.float32)
        f = (rng.standard_normal((batch_filter, 32, 32)) * 0.3) \
            .astype(np.float32)
        _close(L.apply_dynamic_filter(_t(x), _t(f)),
               jL.apply_dynamic_filter(jnp.asarray(x), jnp.asarray(f),
                                       precision=HIGHEST))

    def test_apply_dynamic_filter_f16_guard(self, rng):
        """Filters beyond f16's range (1e5 > 65504) stay fp32: only the
        output is rounded to f16."""
        x = rng.standard_normal((1, 3, 4, 32)).astype(np.float16)
        f = (rng.standard_normal((1, 32, 32)) * 1e5).astype(np.float32)
        f[0, 0, 0] = 2e5
        x8 = x * np.float16(1e-3)
        got = L.apply_dynamic_filter(_t(x8), _t(f))
        assert got.dtype == torch.float16 and torch.isfinite(got).all()
        want = np.asarray(jL.apply_dynamic_filter(
            jnp.asarray(x8), jnp.asarray(f), precision=HIGHEST), np.float32)
        _close(got.float(), want, 2e-3, 2e-3)


class TestVgg:
    def test_features_and_encode(self, ckpt, rng):
        jax_p, port = ckpt
        x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
        want = jV.vgg_features(jax_p["encoder_style"], jnp.asarray(x),
                               "relu4_1", precision=HIGHEST)
        got = V.vgg_features(port["encoder_style"], _t(x), "relu4_1")
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-5)
        enc = V.encode(port["encoder"], _t(x))
        _close(enc, jV.encode(jax_p["encoder"], jnp.asarray(x),
                              precision=HIGHEST), 1e-4, 1e-5)

    def test_partial_taps(self, ckpt, rng):
        _, port = ckpt
        x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
        got = V.vgg_features(port["encoder"], _t(x), "relu2_1")
        assert got.relu3_1 is None and got.relu4_1 is None
        assert tuple(got.relu2_1.shape) == (1, 8, 8, 128)
        assert V.VGG_CONVS == jV.VGG_CONVS
