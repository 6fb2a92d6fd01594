"""rerevst_torch's training ops vs rerevst_tpu: ``resize_bilinear``, the
Gaussian and box blurs, ``grid_sample``/``flow_warp`` in both modes with
their gradients, and ``flow_warp_const_src``.

fp32 on the CPU, the same numpy inputs on both sides.  Tolerances: the
resize and the blurs agree to 1e-5 of the output's scale (the blurs sum
101 or 100 taps in other orders); the bilinear warp to 1e-6 of the scale;
the nearest warp exactly, except at pixels whose sampling coordinate lies
within 1e-5 px of a .5 tie, where the two sides' last-bit rounding may pick
the other neighbour (counted and reported); gradients to 1e-5 of their
scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rerevst_torch.ops import blur as B
from rerevst_torch.ops import resize as R
from rerevst_torch.ops import warp as W
from rerevst_tpu.ops import blur as jB
from rerevst_tpu.ops import resize as jR
from rerevst_tpu.ops import warp as jW


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The test workers share the machine's cores: two torch threads each,
    or the workers' thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _close(got, want, scale_atol=1e-5, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("src,dst", [((8, 8), (64, 64)), ((3, 5), (37, 70)),
                                     ((64, 64), (32, 24)), ((1, 1), (9, 9))])
def test_resize_bilinear(rng, src, dst):
    x = rng.standard_normal((2,) + src + (2,)).astype(np.float32)
    _close(R.resize_bilinear(torch.from_numpy(x), *dst),
           jR.resize_bilinear(jnp.asarray(x), *dst))


@pytest.mark.parametrize("hw", [(64, 64), (32, 32), (40, 72), (7, 5)])
def test_gaussian_blur_101(rng, hw):
    """The relaxed loss's 101-tap blur, a side under 51 px included (pads
    that reflect more than once)."""
    x = rng.standard_normal((2,) + hw + (2,)).astype(np.float32)
    _close(B.gaussian_blur(torch.from_numpy(x)),
           jB.gaussian_blur(jnp.asarray(x)))


def test_gaussian_blur_scaled_kernel(rng):
    """The 1/N blur of ``relaxed_blur_scale`` = 4 (ksize 25, sigma
    12.625) on a 16x16 field."""
    x = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
    _close(B.gaussian_blur(torch.from_numpy(x), 25, 50.5 / 4),
           jB.gaussian_blur(jnp.asarray(x), 25, 50.5 / 4))


@pytest.mark.parametrize("hw", [(128, 100), (64, 64), (32, 32)])
def test_box_blur_100(rng, hw):
    """cv2.blur(100)'s asymmetric anchor (pads 50/49)."""
    x = rng.standard_normal((1,) + hw + (2,)).astype(np.float32)
    _close(B.box_blur(torch.from_numpy(x)), jB.box_blur(jnp.asarray(x)))


def test_reflect_index_matches_numpy():
    for n in (1, 2, 3, 7, 32):
        for lo, hi in ((0, 0), (3, 5), (50, 49), (130, 7), (7, 130)):
            a = np.arange(n)
            want = np.pad(a, (lo, hi), mode="reflect")
            got = B.reflect_index(np.arange(-lo, n + hi), n)
            np.testing.assert_array_equal(got, want)


def _warp_inputs(rng, n=2, h=24, w=40, c=3, scale=3.0):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * scale).astype(np.float32)
    return x, flow


def _near_ties(flow, h, w, tol=1e-5):
    """Pixels whose nearest-mode sampling coordinate lies within `tol` px of
    a .5 tie (either axis), from the reference's coordinate map."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    gx = (xs - flow[..., 0]) * w / max(w - 1, 1) - 0.5
    gy = (ys - flow[..., 1]) * h / max(h - 1, 1) - 0.5
    gx, gy = np.clip(gx, 0, w - 1), np.clip(gy, 0, h - 1)
    tie = lambda g: np.abs(g - np.floor(g) - 0.5) < tol  # noqa: E731
    return tie(gx) | tie(gy)


def test_flow_warp_nearest(rng):
    x, flow = _warp_inputs(rng)
    got = W.flow_warp(torch.from_numpy(x), torch.from_numpy(flow),
                      "nearest").numpy()
    want = np.asarray(jW.flow_warp(jnp.asarray(x), jnp.asarray(flow),
                                   "nearest"))
    ties = _near_ties(flow, 24, 40)
    diff = (got != want).any(-1)
    print(f"nearest warp: {int(ties.sum())} pixels near a .5 tie, "
          f"{int((diff & ties).sum())} of them differ")
    assert not (diff & ~ties).any()


def test_flow_warp_bilinear(rng):
    x, flow = _warp_inputs(rng)
    _close(W.flow_warp(torch.from_numpy(x), torch.from_numpy(flow)),
           jW.flow_warp(jnp.asarray(x), jnp.asarray(flow)), 1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(rng, mode):
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 7, 11, 2)).astype(np.float32)
    got = W.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode)
    want = jW.grid_sample(jnp.asarray(x), jnp.asarray(grid), mode)
    if mode == "bilinear":
        _close(got, want, 1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp_gradients(rng, mode):
    """d/dx and (bilinear) d/dflow of <flow_warp(x, flow), cot> against
    ``jax.grad``."""
    x, flow = _warp_inputs(rng)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x_, f_):
        return jnp.sum(jW.flow_warp(x_, f_, mode) * cot)

    jgx, jgf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(flow))
    tx = torch.from_numpy(x).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    (W.flow_warp(tx, tf, mode) * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jgx)
    if mode == "bilinear":
        _close(tf.grad, jgf)
    else:
        assert not np.asarray(jgf).any()
        assert tf.grad is None or not tf.grad.any()


def test_resize_and_blur_gradients(rng):
    """The relaxed loss's flow chain (resize, tanh, 101-tap blur) backward
    against ``jax.grad``."""
    from rerevst_torch.losses.relaxed import smooth_flow
    from rerevst_tpu.losses.relaxed import smooth_flow as jsmooth

    flow = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    cot = rng.standard_normal((1, 32, 32, 2)).astype(np.float32)
    jg = jax.grad(lambda f: jnp.sum(jsmooth(f, 32, 32) * cot))(
        jnp.asarray(flow))
    tf = torch.from_numpy(flow).requires_grad_(True)
    (smooth_flow(tf, 32, 32) * torch.from_numpy(cot)).sum().backward()
    _close(tf.grad, jg)


@pytest.mark.parametrize("scale", [3.0, 0.0])
def test_flow_warp_const_src(rng, scale):
    """Forward bit-equal to ``flow_warp``; the analytic flow gradient equal
    to autograd's through ``flow_warp`` (and to the JAX custom VJP) — at a
    random flow and at flow = 0, where every border pixel is an exact clip
    tie."""
    x, flow = _warp_inputs(rng, scale=scale)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    tx = torch.from_numpy(x)
    f1 = torch.from_numpy(flow).requires_grad_(True)
    f2 = torch.from_numpy(flow).requires_grad_(True)
    out_c = W.flow_warp_const_src(tx, f1)
    out_a = W.flow_warp(tx, f2)
    assert torch.equal(out_c, out_a)
    (out_c * torch.from_numpy(cot)).sum().backward()
    (out_a * torch.from_numpy(cot)).sum().backward()
    _close(f1.grad, f2.grad.numpy(), 1e-6)
    jg = jax.grad(lambda f: jnp.sum(
        jW.flow_warp_const_src(jnp.asarray(x), f) * cot))(jnp.asarray(flow))
    _close(f1.grad, jg, 1e-6)
