"""rerevst_torch kernels: the plain PyTorch versions against the JAX package
on the CPU, and the wrappers' contracts.  Each kernel against its plain
version on the card: tests/test_torch_cuda.py.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does, and the inline ``_norm_apply`` of the global
decoder.  Tolerances: fp32 elementwise chains agree to 1e-6 relative (one
fp32 rounding per step; XLA may contract a multiply-add where PyTorch rounds
twice); the filter pair sums 32 products in other orders, 2e-5 absolute on
O(1) data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import kernels
from rerevst_torch.kernels import (
    dynamic_filter_pair,
    dynamic_filter_pair_plain,
    norm_affine_clamp,
    norm_affine_clamp_plain,
)
from rerevst_torch.models.transformer import NormStats
from rerevst_tpu.kernels import dynamic_filter_pair as jax_filter_pair
from rerevst_tpu.kernels import dynamic_filter_pair_xla
from rerevst_tpu.kernels import norm_affine_clamp as jax_norm_affine
from rerevst_tpu.models import layers as jL
from rerevst_tpu.models import transformer as jT


def _stats(rng, c, rstd_big=False):
    mean = rng.standard_normal((1, 1, 1, c)).astype(np.float32)
    rstd = (0.5 + rng.random((1, 1, 1, c))).astype(np.float32)
    if rstd_big:
        rstd[..., 0] = 1e6
        mean[..., 0] = 0.3
    xmin = (-2 - rng.random((1, 1, 1, c))).astype(np.float32)
    xmax = (2 + rng.random((1, 1, 1, c))).astype(np.float32)
    return (mean, rstd, xmin, xmax)


def _port_st(st):
    return NormStats(*(torch.from_numpy(v) for v in st))


def _jax_st(st):
    return jT.NormStats(*(jnp.asarray(v) for v in st))


VARIANTS = ["identity", "affine", "leaky"]
SHAPES = [(2, 6, 7, 64), (1, 3, 5, 32), (3, 7, 5, 128)]  # ragged rows


def _inputs(rng, shape, variant, rstd_big=False):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    st = _stats(rng, c, rstd_big)
    if variant == "affine":
        s = (1 + rng.random((1, 1, 1, c))).astype(np.float32)
        m = rng.standard_normal((1, 1, 1, c)).astype(np.float32)
    else:
        s = m = None
    return x, st, s, m


class TestNormAffinePlain:
    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_pallas_interpret(self, rng, shape, variant):
        x, st, s, m = _inputs(rng, shape, variant)
        c = shape[-1]
        leaky = variant == "leaky"
        got = norm_affine_clamp_plain(
            torch.from_numpy(x), _port_st(st),
            None if s is None else torch.from_numpy(s),
            None if m is None else torch.from_numpy(m), leaky=leaky)
        jx = jL.leaky_relu(jnp.asarray(x)) if leaky else jnp.asarray(x)
        js = jnp.ones((1, 1, 1, c)) if s is None else jnp.asarray(s)
        jm = jnp.zeros((1, 1, 1, c)) if m is None else jnp.asarray(m)
        want = jax_norm_affine(jx, _jax_st(st), js, jm, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=2e-5)

    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize("rstd_big", [False, True])
    def test_matches_norm_apply(self, rng, variant, rstd_big):
        """Held against the decoder's inline _norm_apply (then * s + m) —
        including a degenerate channel with rstd = 1e6 and a non-zero mean,
        where the Pallas kernel's folded x*rstd - mean*rstd loses precision
        and only the subtract-then-scale form agrees."""
        x, st, s, m = _inputs(rng, (2, 5, 6, 64), variant, rstd_big)
        if rstd_big:
            x[..., 0] = 0.3 + rng.standard_normal(x.shape[:-1]) * 1e-6
        leaky = variant == "leaky"
        got = norm_affine_clamp_plain(
            torch.from_numpy(x), _port_st(st),
            None if s is None else torch.from_numpy(s),
            None if m is None else torch.from_numpy(m), leaky=leaky)
        jx = jL.leaky_relu(jnp.asarray(x)) if leaky else jnp.asarray(x)
        want = jT._norm_apply(_jax_st(st), jx)
        if s is not None:
            want = want * jnp.asarray(s) + jnp.asarray(m)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_f16_computes_in_fp32(self, rng):
        """Under f16 storage the chain runs in fp32 and rounds once: an
        rstd of 1e6 does not overflow, and the result equals the fp32 chain
        rounded to f16."""
        x, st, _, _ = _inputs(rng, (1, 4, 4, 64), "identity", True)
        x16 = torch.from_numpy(x).half()
        got = norm_affine_clamp_plain(x16, _port_st(st))
        want = norm_affine_clamp_plain(x16.float(), _port_st(st)).half()
        assert got.dtype == torch.float16
        assert torch.equal(got, want) and torch.isfinite(got).all()


class TestFilterPairPlain:
    @pytest.mark.parametrize("shape", [(1, 8, 8, 32), (2, 10, 12, 32),
                                       (1, 3, 5, 32)])
    def test_matches_pallas_interpret(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        f1 = (rng.standard_normal((1, 32, 32)) * 0.2).astype(np.float32)
        f2 = (rng.standard_normal((1, 32, 32)) * 0.2).astype(np.float32)
        got = dynamic_filter_pair_plain(torch.from_numpy(x),
                                        torch.from_numpy(f1),
                                        torch.from_numpy(f2))
        want = jax_filter_pair(jnp.asarray(x), jnp.asarray(f1),
                               jnp.asarray(f2), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        ref = dynamic_filter_pair_xla(jnp.asarray(x), jnp.asarray(f1),
                                      jnp.asarray(f2),
                                      precision=lax.Precision.HIGHEST)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    def test_f16_keeps_filters_fp32(self, rng):
        """Filters of 1e5 (beyond f16's 65504) with an f16 input: the plain
        version stays finite and equals the fp32 chain rounded once."""
        x = torch.from_numpy(rng.standard_normal((2, 3, 4, 32))).half()
        f1 = torch.from_numpy(rng.standard_normal((1, 32, 32)) * 1e5).float()
        f2 = torch.from_numpy(rng.standard_normal((1, 32, 32)) * 1e-6).float()
        got = dynamic_filter_pair_plain(x, f1, f2)
        assert got.dtype == torch.float16 and torch.isfinite(got).all()
        want = dynamic_filter_pair_plain(x.float(), f1, f2).half()
        assert torch.equal(got, want)


class TestWrappers:
    def test_cpu_path_is_plain_and_counts_nothing(self, rng):
        kernels.reset_launches()
        x, st, s, m = _inputs(rng, (2, 3, 4, 64), "affine")
        args = (torch.from_numpy(x), _port_st(st), torch.from_numpy(s),
                torch.from_numpy(m))
        assert torch.equal(norm_affine_clamp(*args),
                           norm_affine_clamp_plain(*args))
        xf = torch.from_numpy(rng.standard_normal((2, 3, 4, 32))).float()
        f = torch.from_numpy(rng.standard_normal((1, 32, 32))).float()
        assert torch.equal(dynamic_filter_pair(xf, f, f),
                           dynamic_filter_pair_plain(xf, f, f))
        assert kernels.launch_counts() == {"norm_affine_clamp": 0,
                                           "dynamic_filter_pair": 0,
                                           "conv3x3_implicit_gemm": 0,
                                           "conv3x3_pairlane": 0,

                                           "conv3x3_wgrad": 0}

    def test_norm_affine_rejects(self, rng):
        x, st, s, m = _inputs(rng, (2, 3, 4, 64), "affine")
        xt, pst = torch.from_numpy(x), _port_st(st)
        # Per-sample conditioning must have x's batch (2) as its leading dim.
        per_sample = torch.ones(3, 1, 1, 64)
        with pytest.raises(ValueError, match="shared"):
            norm_affine_clamp(xt, pst, per_sample, per_sample)
        with pytest.raises(ValueError, match="channels"):
            norm_affine_clamp(xt[..., :32].contiguous(), pst)
        with pytest.raises(ValueError, match="contiguous"):
            norm_affine_clamp(xt.transpose(1, 2), pst)
        with pytest.raises(ValueError, match="both"):
            norm_affine_clamp(xt, pst, torch.from_numpy(s), None)
        with pytest.raises(TypeError):
            norm_affine_clamp(xt.double(), pst)
        with pytest.raises(ValueError, match="fp32"):
            norm_affine_clamp(xt, NormStats(*(v.half() for v in pst)))

    def test_filter_pair_rejects(self, rng):
        x = torch.zeros(2, 3, 4, 32)
        with pytest.raises(ValueError, match="per-sample"):
            dynamic_filter_pair(x, torch.zeros(3, 32, 32),
                                torch.zeros(3, 32, 32))
        with pytest.raises(ValueError, match="contiguous"):
            dynamic_filter_pair(x.transpose(1, 2), torch.zeros(1, 32, 32),
                                torch.zeros(1, 32, 32))
