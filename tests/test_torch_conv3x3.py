"""rerevst_torch 3x3 convs and the pair-lane model path against rerevst_tpu.

* The plain versions of ``conv3x3_implicit_gemm`` and ``conv3x3_pairlane``
  against the JAX package's Pallas kernels in interpret mode (as
  tests/test_kernels.py runs them), fp32: both sum 9 C products per output
  in other orders, atol 2e-5 on O(1) data, the JAX kernel tests' tolerance.
* The wrappers' contracts on the CPU (each kernel against its plain version
  on the card: tests/test_torch_cuda.py).
* ``ModelConfig(pairlane=True)`` with the bundled checkpoint: the pair-lane
  encoder head, ``decode_global`` and ``Stylization.stylize_video`` in bf16
  and f16 against the JAX fp32 graph.  The bar is tests/test_pairlane.py's:
  a low-precision pair-lane output's mean error against fp32 stays within
  max(3 x the JAX plain path's error in the same dtype, 1.5 x the JAX plain
  bf16 path's error).  f16 is held to the same cap, although the port keeps
  the region in f16 where the JAX package ran it in bf16.
* fp32 sessions never take the pair-lane route (bit-identical to the
  default path), and geometry outside the JAX gate takes the plain path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import kernels
from rerevst_torch.api import Stylization
from rerevst_torch.config import ModelConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.kernels import (
    conv3x3_implicit_gemm,
    conv3x3_implicit_gemm_plain,
    conv3x3_pairlane,
    conv3x3_pairlane_plain,
)
from rerevst_torch.models import transformer as T
from rerevst_torch.models import vgg
from rerevst_tpu.api import Stylization as JaxStylization
from rerevst_tpu.config import ModelConfig as JaxModelConfig
from rerevst_tpu.kernels import conv3x3 as jconv
from rerevst_tpu.models import transformer as jT

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
LOW = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]


def _conv_inputs(rng, shape, o, bias=True):
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], o)) * 0.1).astype(np.float32)
    b = rng.standard_normal(o).astype(np.float32) if bias else None
    return x, w, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,o,bias", [
    ((2, 16, 24, 64), 64, True), ((1, 8, 16, 64), 3, True),   # test_kernels
    ((1, 8, 16, 3), 64, True),                                 # VGG conv1_1
    # The narrow design's other widths (C <= 7).
    ((1, 8, 16, 1), 64, True), ((1, 8, 12, 4), 5, True),
    ((2, 8, 16, 7), 128, False),
    ((1, 8, 16, 64), 128, True), ((1, 8, 12, 32), 16, False),
    # The wide design's widths (C % 64 = 0, C >= 128).
    ((1, 8, 16, 128), 128, True), ((1, 8, 8, 256), 64, False),
    # The sliced design's widths (other C >= 8): C = 8, 96 and 100.
    ((1, 8, 16, 8), 64, True), ((2, 8, 8, 96), 32, True),
    ((1, 8, 12, 100), 5, False),
])
def test_implicit_gemm_plain_matches_pallas(rng, shape, o, bias):
    x, w, b = _conv_inputs(rng, shape, o, bias)
    got = conv3x3_implicit_gemm_plain(_t(x), _t(w), _t(b))
    want = jconv.conv3x3_implicit_gemm(_j(x), _j(w), _j(b), tile_h=8,
                                       interpret=True)
    assert tuple(got.shape) == shape[:3] + (o,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("shape,o", [
    ((2, 16, 24, 64), 64), ((1, 8, 16, 64), 3), ((1, 8, 32, 64), 32),
])
def test_pairlane_plain_matches_pallas(rng, shape, o):
    x, w, b = _conv_inputs(rng, shape, o)
    got = conv3x3_pairlane_plain(_t(x), _t(w), _t(b))
    want = jconv.conv3x3_pairlane(_j(x), _j(w), _j(b), tile_h=8,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_rounds_once(rng):
    """16-bit storage: fp32 conv and bias, one rounding at the end."""
    x, w, b = _conv_inputs(rng, (2, 5, 7, 64), 8)
    for dt in (torch.float16, torch.bfloat16):
        xs, ws, bs = (torch.from_numpy(a).to(dt) for a in (x, w, b))
        got = conv3x3_pairlane_plain(xs, ws, bs)
        want = conv3x3_implicit_gemm_plain(xs.float(), ws.float(),
                                           bs.float()).to(dt)
        assert got.dtype == dt and torch.equal(got, want)


# ---------------------------------------------------------------------------
# Wrapper contracts
# ---------------------------------------------------------------------------

def test_cpu_tensors_launch_nothing(rng):
    kernels.reset_launches()
    x, w, b = _conv_inputs(rng, (2, 5, 6, 64), 3)
    args = (_t(x), _t(w), _t(b))
    assert torch.equal(conv3x3_pairlane(*args), conv3x3_pairlane_plain(*args))
    assert torch.equal(conv3x3_implicit_gemm(*args),
                       conv3x3_implicit_gemm_plain(*args))
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert set(kernels.launch_counts()) == {
        "norm_affine_clamp", "dynamic_filter_pair", "conv3x3_implicit_gemm",
        "conv3x3_pairlane", "conv3x3_wgrad"}


def test_pairlane_rejects(rng):
    x, w, b = (_t(a) for a in _conv_inputs(rng, (1, 4, 6, 64), 64))
    with pytest.raises(ValueError, match="C=64"):
        conv3x3_pairlane(x[..., :32].contiguous(), w[:, :, :32].contiguous())
    w65 = torch.zeros(3, 3, 64, 65)
    with pytest.raises(ValueError, match="O<=64"):
        conv3x3_pairlane(x, w65)
    with pytest.raises(TypeError):
        conv3x3_pairlane(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_pairlane(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_pairlane(x, w.half())
    with pytest.raises(ValueError, match="shape"):
        conv3x3_pairlane(x, w, b[:3])
    with pytest.raises(ValueError, match="HWIO"):
        conv3x3_pairlane(x, w.reshape(9, 64, 64))


def test_implicit_gemm_rejects(rng):
    x, w, _ = (_t(a) for a in _conv_inputs(rng, (1, 4, 6, 5), 7, False))
    with pytest.raises(ValueError, match="HWIO"):
        conv3x3_implicit_gemm(x, torch.zeros(3, 3, 4, 7))
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_implicit_gemm(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        conv3x3_implicit_gemm(x.to(torch.int32), w)
    with pytest.raises(ValueError, match="NHWC"):
        conv3x3_implicit_gemm(x[0], w)
    # Any C and O go through: C=5, O=7.
    assert tuple(conv3x3_implicit_gemm(x, w).shape) == (1, 4, 6, 7)


# ---------------------------------------------------------------------------
# The pair-lane model path vs the JAX package
# ---------------------------------------------------------------------------

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
def tree():
    return serialization.msgpack_restore(CKPT.read_bytes())


@pytest.fixture(scope="module")
def models(tree):
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = {dt: from_jax_params(jp, dtype=dt, device="cpu")
            for dt in (torch.float32, torch.float16, torch.bfloat16)}
    return jp, port


def _cap(errs_plain, jdt):
    """tests/test_pairlane.py's bar, from the JAX plain path's errors."""
    return max(3.0 * errs_plain[jdt], 1.5 * errs_plain[jnp.bfloat16])


def _count_calls(monkeypatch, *modules):
    """Record the input shape of every ``conv3x3_pairlane`` call that the
    model modules make."""
    calls = []

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return conv3x3_pairlane(*a, **k)

    for module in modules:
        monkeypatch.setattr(module, "conv3x3_pairlane", counted)
    return calls


@pytest.fixture(scope="module")
def frames():
    return _smooth_images(np.random.default_rng(2), 2, 64, 64)


@pytest.fixture(scope="module")
def encoder_ref(models, frames):
    """JAX fp32 encoder output, and the JAX plain path's mean error in
    each low precision."""
    jp, _ = models
    ref = np.asarray(jT.encode_content(jp, jnp.asarray(frames),
                                       JaxModelConfig()), np.float32)
    errs = {jdt: np.abs(np.asarray(jT.encode_content(
        jp, jnp.asarray(frames), JaxModelConfig(dtype=jdt)), np.float32)
        - ref).mean() for _, jdt in LOW}
    return ref, errs


@pytest.mark.parametrize("dt,jdt", LOW)
def test_encode_pairlane_head_matches_jax(models, frames, encoder_ref,
                                          monkeypatch, dt, jdt):
    _, port = models
    ref, errs = encoder_ref
    calls = _count_calls(monkeypatch, vgg)
    kernels.reset_launches()
    got = T.encode_content(port[dt], torch.from_numpy(frames),
                           ModelConfig(dtype=dt, pairlane=True))
    assert calls == [(2, 64, 64, 64)]  # conv1_2, full resolution
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert got.dtype == dt and tuple(got.shape) == ref.shape
    g = got.float().numpy()
    assert np.isfinite(g).all()
    assert np.abs(g - ref).mean() <= _cap(errs, jdt), \
        (np.abs(g - ref).mean(), errs)


@pytest.fixture(scope="module")
def decoder_case(models):
    """Pass-1 state from the JAX fp32 graph, the JAX fp32 decode, and the
    JAX plain decode's mean error in each low precision (the same inputs
    cast to the storage dtype)."""
    jp, _ = models
    rng = np.random.default_rng(3)
    x = _smooth_images(rng, 2, 64, 80)
    js = jT.encode_style(jp, jnp.asarray(_smooth_images(rng, 1, 64, 64)),
                         JaxModelConfig())
    feats = np.array(jT.encode_content(jp, jnp.asarray(x), JaxModelConfig()))
    jst = jT.collect_stats(jp["decoder"], jnp.asarray(feats), js,
                           JaxModelConfig())
    ref = np.asarray(jT.decode_global(jp["decoder"], jnp.asarray(feats), js,
                                      jst, JaxModelConfig()), np.float32)
    errs = {}
    for _, jdt in LOW:
        jsd = jT.StyleFeatures(js.map.astype(jdt),
                               tuple(v.astype(jdt) for v in js.means),
                               tuple(v.astype(jdt) for v in js.stds))
        out = jT.decode_global(jp["decoder"], jnp.asarray(feats, jdt), jsd,
                               jst, JaxModelConfig(dtype=jdt))
        errs[jdt] = np.abs(np.asarray(out, np.float32) - ref).mean()
    return feats, js, jst, ref, errs


@pytest.mark.parametrize("dt,jdt", LOW)
def test_decode_global_pairlane_matches_jax(models, decoder_case,
                                            monkeypatch, dt, jdt):
    _, port = models
    feats, js, jst, ref, errs = decoder_case
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dt)  # noqa
    style = T.StyleFeatures(t(js.map), tuple(map(t, js.means)),
                            tuple(map(t, js.stds)))
    f32 = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    stats = T.SeqStats(
        {k: T.NormStats(*map(f32, v)) for k, v in jst.norms.items()},
        {k: f32(v) for k, v in jst.filters.items()})
    calls = _count_calls(monkeypatch, T)
    got = T.decode_global(port[dt]["decoder"], t(feats), style, stats,
                          ModelConfig(dtype=dt, pairlane=True))
    # res2.conv2 (64->64) and the out conv (64->3), both at 64x80.
    assert calls == [(2, 64, 80, 64)] * 2
    assert got.dtype == dt and tuple(got.shape) == ref.shape
    g = got.float().numpy()
    assert np.isfinite(g).all()
    assert np.abs(g - ref).mean() <= _cap(errs, jdt), \
        (np.abs(g - ref).mean(), errs)


def test_pairlane_fp32_is_inert(models, frames, decoder_case, monkeypatch):
    """fp32 never takes the pair-lane route: bit-identical to the default
    path, and the kernel wrapper is never called."""
    _, port = models
    feats, js, jst, _, _ = decoder_case
    calls = _count_calls(monkeypatch, vgg, T)
    on = ModelConfig(pairlane=True)
    x = torch.from_numpy(frames)
    assert torch.equal(T.encode_content(port[torch.float32], x, on),
                       T.encode_content(port[torch.float32], x, ModelConfig()))
    f32 = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    style = T.StyleFeatures(f32(js.map), tuple(map(f32, js.means)),
                            tuple(map(f32, js.stds)))
    stats = T.SeqStats(
        {k: T.NormStats(*map(f32, v)) for k, v in jst.norms.items()},
        {k: f32(v) for k, v in jst.filters.items()})
    dec = port[torch.float32]["decoder"]
    assert torch.equal(T.decode_global(dec, f32(feats), style, stats, on),
                       T.decode_global(dec, f32(feats), style, stats,
                                       ModelConfig()))
    assert calls == []


def test_pairlane_odd_geometry_takes_plain_path(models, monkeypatch):
    """Geometry outside the JAX gate (H % 8, odd W) runs the plain encoder:
    no kernel call, no error, the plain path's exact output."""
    _, port = models
    calls = _count_calls(monkeypatch, vgg)
    x = torch.from_numpy(_smooth_images(np.random.default_rng(4), 1, 63, 66))
    p = port[torch.bfloat16]
    f = T.encode_content(p, x, ModelConfig(dtype=torch.bfloat16,
                                           pairlane=True))
    assert tuple(f.shape[1:]) == (63 // 8, 66 // 8, 512)
    assert calls == []
    assert torch.equal(f, T.encode_content(
        p, x, ModelConfig(dtype=torch.bfloat16)))
    assert not vgg.encode_pairlane_ok(torch.zeros(1, 64, 65, 3))
    assert vgg.encode_pairlane_ok(torch.zeros(1, 64, 66, 3))


# ---------------------------------------------------------------------------
# Stylization.stylize_video, the 9-frame 64x112 clip of test_torch_api.py
# ---------------------------------------------------------------------------

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
    img += rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _frame_err(a, b):
    """Mean |delta| per pixel of two uint8 clips, [0,1] units."""
    return float(np.mean([np.abs(x.astype(np.int16) - y.astype(np.int16))
                          .mean() for x, y in zip(a, b)]) / 255.0)


@pytest.fixture(scope="module")
def jax_video(tree):
    """JAX frames in fp32, and the JAX plain path's error in each low
    precision."""
    outs = {}
    for jdt in (jnp.float32, jnp.bfloat16, jnp.float16):
        s = JaxStylization(params=tree, cfg=JaxModelConfig(dtype=jdt))
        s.prepare_style(_style())
        outs[jdt] = list(s.stylize_video(_clip(), batch_size=4))
    ref = outs[jnp.float32]
    return ref, {jdt: _frame_err(outs[jdt], ref) for _, jdt in LOW}


@pytest.mark.parametrize("dt,jdt", LOW)
def test_stylize_video_pairlane_matches_jax(tree, jax_video, monkeypatch,
                                            dt, jdt):
    ref, errs = jax_video
    calls = _count_calls(monkeypatch, vgg, T)
    s = Stylization(params=tree, cfg=ModelConfig(dtype=dt, pairlane=True),
                    device="cpu")
    s.prepare_style(_style())
    kernels.reset_launches()
    got = list(s.stylize_video(_clip(), batch_size=4))
    # Pass 1: one encoder chunk (frames 0 and 8); Pass 2: three batches of
    # conv1_2, res2.conv2 and the out conv.  The CPU launches nothing.
    assert len(calls) == 1 + 3 * 3
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert len(got) == 9
    assert all(f.shape == (64, 112, 3) and f.dtype == np.uint8 for f in got)
    err = _frame_err(got, ref)
    assert err <= _cap(errs, jdt), (err, errs)
