"""rerevst_torch's training losses vs rerevst_tpu: the perceptual losses,
the Compound Regularization fake motion, and the relaxed style loss.

fp32 on the CPU.  The loss network is the JAX package's
``init_vgg_params(PRNGKey(0), scheme='he_relu')`` carried across with
``from_jax_params`` (the bundled checkpoint strips its loss net).
Tolerances: the perceptual losses agree to 1e-5 relative; the fake flow
built from the JAX package's own draws (its coarse noise and shift) to 1e-5
of its scale.  The port's own draws come from a torch.Generator and cannot
match the JAX PRNG value for value, so they are checked by their
statistics.  The relaxed loss at 64x64 with ``flow_iter`` 16: ``ori`` to
1e-4 relative, the first inner losses to 1e-3, the final loss to 5e-2 (the
bar ``tests/test_losses.py`` sets for 16 chained steps against the
reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rerevst_torch.config import LossConfig, ModelConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.losses import perceptual as P
from rerevst_torch.losses import relaxed as RL
from rerevst_torch.losses import temporal as TL
from rerevst_torch.models import vgg as V
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import ModelConfig as JModelConfig
from rerevst_tpu.losses import perceptual as jP
from rerevst_tpu.losses import relaxed as jRL
from rerevst_tpu.losses import temporal as jTL
from rerevst_tpu.models import vgg as jV


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The test workers share the machine's cores: two torch threads each,
    or the workers' thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



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


def _rel(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.fixture(scope="module")
def loss_net():
    jp = jax.tree.map(np.asarray, jV.init_vgg_params(jax.random.PRNGKey(0),
                                                     scheme="he_relu"))
    return jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return _smooth_images(rng, 2, 64, 64), _smooth_images(rng, 2, 64, 64)


def test_perceptual_losses(loss_net, images):
    jp, tp = loss_net
    a, b = images
    ja, jb = (jV.vgg_features(jp, jnp.asarray(x), "relu4_1") for x in (a, b))
    ta = V.VggFeatures(*(torch.from_numpy(np.array(f)) for f in ja))
    tb = V.VggFeatures(*(torch.from_numpy(np.array(f)) for f in jb))
    assert _rel(P.style_loss(ta, tb), jP.style_loss(ja, jb)) < 1e-5
    assert _rel(P.content_loss(ta, tb), jP.content_loss(ja, jb)) < 1e-5
    assert _rel(P.tv_loss(torch.from_numpy(a)),
                jP.tv_loss(jnp.asarray(a))) < 1e-5
    # The features of the port's VGG on the same weights.
    tf = V.vgg_features(tp, torch.from_numpy(a), "relu4_1")
    assert _rel(P.style_loss(tf, tb), jP.style_loss(ja, jb)) < 1e-4


@pytest.mark.parametrize("hw", [(64, 64), (200, 130), (32, 48)])
def test_fake_flow_from_jax_draws(hw):
    """generate_fake_flow's deterministic part, fed the JAX package's own
    coarse noise and shift (drawn as its ``generate_fake_flow`` draws
    them)."""
    h, w = hw
    key = jax.random.PRNGKey(11)
    want = jTL.generate_fake_flow(key, h, w, 8.0, 10)
    k1, k2 = jax.random.split(key)
    coarse = jax.random.normal(k1, (1, max(h // 100, 1), max(w // 100, 1),
                                    2)) * 8.0
    shift = jax.random.randint(k2, (2,), -10, 11)
    got = TL.fake_flow_from_noise(torch.from_numpy(np.asarray(coarse)),
                                  torch.from_numpy(np.asarray(shift)), h, w)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_fake_flow_statistics():
    """The port's own draws (torch.Generator): a smooth field dominated by
    the global shift, as tests/test_losses.py checks the JAX one; the shift
    is inclusive at both ends; generators of the same seed agree."""
    g = torch.Generator().manual_seed(0)
    flow = TL.generate_fake_flow(g, 200, 200).numpy()
    assert flow.shape == (200, 200, 2)
    assert np.abs(np.diff(flow, axis=0)).max() < 1.0
    assert np.abs(flow).max() < 25.0
    again = TL.generate_fake_flow(torch.Generator().manual_seed(0), 200, 200)
    np.testing.assert_array_equal(again.numpy(), flow)
    g = torch.Generator().manual_seed(1)
    shifts = {int(v) for _ in range(200)
              for v in TL.generate_fake_flow(g, 4, 4, 0.0, 10)[0, 0]}
    assert shifts == set(range(-10, 11))


def test_fake_data_modes():
    first = torch.ones((2, 64, 64, 3))
    g = torch.Generator().manual_seed(1)
    second, flow = TL.generate_fake_data(g, first, LossConfig())
    assert second.shape == first.shape and flow.shape == (2, 64, 64, 2)
    # The warp of a constant image is constant: only the pixel noise,
    # std = 0.001 (1 + U[0, 1)), remains.
    noise = (second - 1.0).numpy()
    assert 0.0009 < noise.std() < 0.0021 and np.abs(noise).max() < 0.05
    second2, flow2 = TL.generate_fake_data(
        g, first, LossConfig(data_sigma=False, data_w=False))
    assert torch.equal(second2, first) and not flow2.any()


def test_temporal_loss(rng):
    a = rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
    b = rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 16, 20, 2)) * 2).astype(np.float32)
    got, gw = TL.temporal_loss(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(flow))
    want, jw = jTL.temporal_loss(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(flow))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("scale", [1, 2])
def test_smooth_flow(rng, scale):
    flow = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    got = RL.smooth_flow(torch.from_numpy(flow), 64, 64, 20.0, scale)
    want = np.asarray(jRL.smooth_flow(jnp.asarray(flow), 64, 64, 20.0, scale))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def _jax_inner_losses(jp, style, target, n, lcfg):
    """The JAX package's inner loop for `n` iterations, step for step (its
    scan keeps no per-iteration loss)."""
    def inner(flow):
        bounded = jRL.smooth_flow(flow, 64, 64, lcfg.flow_max)
        warped = jW.flow_warp(style, bounded, mode="bilinear")
        feats = jV.vgg_features(jp, warped, "relu4_1")
        return jP.style_loss(target, feats, 1e-5)

    from rerevst_tpu.ops import warp as jW

    grad_fn = jax.jit(jax.value_and_grad(inner))
    flow = jnp.zeros((style.shape[0], 8, 8, 2), jnp.float32)
    mom = jnp.zeros_like(flow)
    out = []
    for _ in range(n):
        loss, g = grad_fn(flow)
        out.append(float(loss))
        mom = lcfg.flow_momentum * mom + g
        flow = flow - lcfg.flow_lr * mom
    return out


def test_relaxed_style_loss(loss_net, images):
    jp, tp = loss_net
    styled, style = images
    jf = jV.vgg_features(jp, jnp.asarray(styled), "relu4_1")
    want, want_ori, _ = jRL.relaxed_style_loss(
        jp, jnp.asarray(style), jf, JLossConfig(), JModelConfig())
    record = {}
    tf = V.vgg_features(tp, torch.from_numpy(styled), "relu4_1")
    got, got_ori, robust = RL.relaxed_style_loss(
        tp, torch.from_numpy(style), tf, LossConfig(), ModelConfig(),
        record=record)
    assert robust.shape == style.shape
    assert len(record["inner_losses"]) == 16
    want_inner = _jax_inner_losses(jp, jnp.asarray(style), jf, 4,
                                   JLossConfig())
    got_inner = [float(v) for v in record["inner_losses"][:4]]
    print(f"relaxed: ori {float(got_ori):.6g} / {float(want_ori):.6g}, "
          f"final {float(got):.6g} / {float(want):.6g}, first inner "
          f"{got_inner} / {want_inner}, port best iterate "
          f"{int(record['best_iter'])}")
    assert _rel(got_ori, want_ori) < 1e-4
    for g_, w_ in zip(got_inner, want_inner):
        assert _rel(g_, w_) < 1e-3
    assert _rel(got, want) < 5e-2


def test_relaxed_style_loss_gradient_path(loss_net, images):
    """Only the final loss reaches the stylized features: the inner loop
    leaves no gradient on the (frozen) loss network, and the bf16 inner
    loop keeps ``ori`` bit-equal and the final loss within a few percent."""
    _, tp = loss_net
    styled, style = images
    x = torch.from_numpy(styled).requires_grad_(True)
    feats = V.vgg_features(tp, x, "relu4_1")
    lcfg = LossConfig(flow_iter=3)
    final, ori, _ = RL.relaxed_style_loss(tp, torch.from_numpy(style),
                                          feats, lcfg, ModelConfig())
    (gx,) = torch.autograd.grad(final, x)
    assert torch.isfinite(gx).all() and gx.abs().max() > 0
    assert all(t.grad is None for p in tp.values() for t in p.values())
    f16, ori16, _ = RL.relaxed_style_loss(
        tp, torch.from_numpy(style), feats,
        LossConfig(flow_iter=3, relaxed_inner_dtype="bf16"), ModelConfig())
    assert torch.equal(ori16, ori)
    assert _rel(f16, final) < 5e-2
