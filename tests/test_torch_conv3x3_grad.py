"""The backward of the hand-written fp32 3x3 conv (``Conv3x3Fn``) and the
weight-gradient kernel's plan, split and tile walk, against rerevst_tpu.

* ``layers.conv2d(..., precision='high' | 'default')`` under autograd: dx,
  dw and db against ``jax.vjp`` of ``rerevst_tpu.models.layers.conv2d`` at
  HIGH on the same inputs (made with numpy from a seed), at C in {3, 8, 64},
  O in {3, 64}, odd and even H and W, batch 1 and 2.  On the CPU both sides
  compute exact fp32 (the port's ops take their plain versions, XLA's CPU
  conv ignores the precision), so they differ only by the order of the
  same fp32 sums: within 1e-5 of each gradient's max-abs.
* ``conv3x3_wgrad_plain`` against JAX's weight cotangent, the same bar.
* The Function under ``torch.utils.checkpoint``; under ``inference_mode``
  and ``no_grad`` the wrapper calls the op and not the Function; a gradient
  the caller does not ask for is not computed.
* ``csrc/conv3x3_wgrad.cu``'s work split (``wgrad_plan``: every K tile in
  one split, every output channel pair in one tile), its hi/lo split on bit
  patterns, and a numpy emulation of its walk (halo'd K tiles, zero fill,
  the nine tap windows, the partials summed in split order) with its TF32
  products at three and one passes against float64, under the bar
  ``chip_smoke.py`` holds the card to.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp
from jax import lax

from rerevst_torch.kernels import conv3x3 as K
from rerevst_torch.models import layers as L
from rerevst_tpu.models import layers as jL

SRC = Path(K.__file__).resolve().parent.parent / "csrc" / "conv3x3_wgrad.cu"
MASK = np.uint32(0xFFFFE000)

#: (B, H, W, C), O: C in {3, 8, 64} x O in {3, 64}, odd and even H and W,
#: batch 1 and 2.
SHAPES = [((1, 7, 9, 3), 64), ((2, 8, 6, 3), 3), ((2, 5, 10, 8), 64),
          ((1, 6, 11, 8), 3), ((1, 9, 8, 64), 64), ((2, 4, 7, 64), 3)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The test workers share the machine's cores: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(shape, o, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], o)) * 0.2).astype(np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (o,)).astype(np.float32)
    return x, w, b, g


def _jax_grads(x, w, b, g):
    def f(xx, ww, bb):
        return jL.conv2d({"w": ww, "b": bb}, xx, padding=1,
                         precision=lax.Precision.HIGH)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return np.asarray(y), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _close(got, want, what):
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= 1e-5, (what, err)


class _CountOps(TorchDispatchMode):
    """Counts the ``rerevst::conv3x3_implicit_gemm`` calls by ``passes``
    and the ``rerevst::conv3x3_wgrad`` calls."""

    def __init__(self):
        super().__init__()
        self.conv, self.wgrad = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for op, seen, i in (
                (torch.ops.rerevst.conv3x3_implicit_gemm.default, self.conv,
                 3),
                (torch.ops.rerevst.conv3x3_wgrad.default, self.wgrad, 2)):
            if func is op:
                p = args[i] if len(args) > i else kwargs.get("passes", 3)
                seen[p] = seen.get(p, 0) + 1
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# The Function against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,passes", [("high", 3), ("default", 1)])
@pytest.mark.parametrize("shape,o", SHAPES)
def test_conv3x3_fn_grads_match_jax(shape, o, precision, passes):
    """dx, dw and db of the kernel route against ``jax.vjp`` at HIGH; the
    backward reaches the conv op (dx) and the wgrad op (dw) once each, at
    the forward's pass count."""
    x, w, b, g = _inputs(shape, o, seed=sum(shape) + o)
    y_want, (dx_w, dw_w, db_w) = _jax_grads(x, w, b, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    p = {"w": torch.from_numpy(w).requires_grad_(True),
         "b": torch.from_numpy(b).requires_grad_(True)}
    with _CountOps() as n:
        y = L.conv2d(p, xt, padding=1, precision=precision)
        assert isinstance(y.grad_fn, K.Conv3x3Fn._backward_cls)
        dx, dw, db = torch.autograd.grad(y, (xt, p["w"], p["b"]),
                                         torch.from_numpy(g))
    assert n.conv == {passes: 2} and n.wgrad == {passes: 1}
    _close(y.detach(), y_want, "y")
    for got, want, what in ((dx, dx_w, "dx"), (dw, dw_w, "dw"),
                            (db, db_w, "db")):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want, what)


@pytest.mark.parametrize("shape,o", SHAPES[::2])
def test_wgrad_plain_matches_jax_weight_cotangent(shape, o):
    x, w, b, g = _inputs(shape, o, seed=7 + o)
    _, (_, dw_want, _) = _jax_grads(x, w, b, g)
    for passes in (3, 1):
        got = K.conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    passes)
        _close(got, dw_want, f"dw at {passes} passes")
        assert torch.equal(got, K.conv3x3_wgrad(torch.from_numpy(x),
                                                torch.from_numpy(g), passes))


def test_conv3x3_fn_under_checkpoint():
    """Recomputed in the backward by ``checkpoint(use_reentrant=False)``:
    the same gradients as without it, the forward op run twice."""
    x, w, b, g = _inputs((2, 6, 9, 8), 64, seed=3)

    def run(remat):
        xt = torch.from_numpy(x).requires_grad_(True)
        p = {"w": torch.from_numpy(w).requires_grad_(True),
             "b": torch.from_numpy(b).requires_grad_(True)}

        def f(xx):
            return torch.relu(L.conv2d(p, xx, padding=1, precision="high"))

        with _CountOps() as n:
            y = checkpoint(f, xt, use_reentrant=False) if remat else f(xt)
            grads = torch.autograd.grad(y, (xt, p["w"], p["b"]),
                                        torch.from_numpy(g))
        return grads, n

    plain, n0 = run(False)
    remat, n1 = run(True)
    assert n0.conv == {3: 2} and n1.conv == {3: 3}
    assert n0.wgrad == n1.wgrad == {3: 1}
    for a, c in zip(plain, remat):
        assert torch.equal(a, c)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_no_autograd_calls_the_op_directly(mode, monkeypatch):
    """Without autograd the wrapper calls the op: no Function, no grad_fn,
    one op call."""
    calls = []
    monkeypatch.setattr(K.Conv3x3Fn, "apply",
                        lambda *a: calls.append(a) or None)
    x, w, b, _ = _inputs((1, 5, 6, 8), 3, seed=4)
    p = {"w": torch.from_numpy(w).requires_grad_(True),
         "b": torch.from_numpy(b)}
    ctx = torch.inference_mode() if mode == "inference_mode" \
        else torch.no_grad()
    with ctx, _CountOps() as n:
        y = L.conv2d(p, torch.from_numpy(x).requires_grad_(mode == "no_grad"),
                     padding=1, precision="high")
    assert not calls and y.grad_fn is None and n.conv == {3: 1}
    torch.testing.assert_close(y, L.conv2d(p, torch.from_numpy(x), padding=1),
                               rtol=1e-5, atol=1e-5)


def test_only_the_asked_gradients_are_computed():
    """Frozen weights: dx alone (no wgrad op); a constant input: dw and db
    alone (no dgrad conv)."""
    x, w, b, g = _inputs((1, 6, 7, 8), 64, seed=5)
    xt = torch.from_numpy(x).requires_grad_(True)
    frozen = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    with _CountOps() as n:
        y = L.conv2d(frozen, xt, padding=1, precision="default")
        torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert n.conv == {1: 2} and not n.wgrad
    p = {"w": torch.from_numpy(w).requires_grad_(True),
         "b": torch.from_numpy(b).requires_grad_(True)}
    with _CountOps() as n:
        y = L.conv2d(p, torch.from_numpy(x), padding=1, precision="default")
        torch.autograd.grad(y, (p["w"], p["b"]), torch.from_numpy(g))
    assert n.conv == {1: 1} and n.wgrad == {1: 1}


def test_sixteen_bit_route_refuses_autograd():
    """The weight-gradient kernel takes fp32: a 16-bit call of the conv
    wrapper that needs a gradient raises (no model path makes one: 16-bit
    convs are the library's)."""
    x = torch.randn(1, 4, 5, 8, dtype=torch.float16, requires_grad=True)
    w = torch.randn(3, 3, 8, 4, dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32"):
        K.conv3x3_implicit_gemm(x, w)
    with pytest.raises(ValueError, match="fp32"):
        K.conv3x3_wgrad(x.detach(), torch.zeros(1, 4, 5, 4,
                                                dtype=torch.float16))


# ---------------------------------------------------------------------------
# The kernel's plan, split and walk
# ---------------------------------------------------------------------------

def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def test_plan_constants_match_the_source():
    """kernels/conv3x3.py's K tile and dispatch are the kernel's."""
    src = SRC.read_text()
    assert _source_int("kTW") == K.WGRAD_TW
    assert "if (O <= 8) return launch<4, 1, 1, P>" in src   # 64 x 8
    assert "  return launch<1, 8, 2, P>" in src               # 16 x 64
    assert [K.wgrad_tile(c, o) for c, o in ((512, 3), (3, 64), (16, 512),
                                            (17, 9), (64, 64))] == \
        [(64, 8), (16, 64), (16, 64), (16, 64), (16, 64)]


@pytest.mark.parametrize("batch,height,width,c,o", [
    (4, 256, 256, 64, 64), (4, 32, 32, 512, 32), (4, 256, 256, 3, 64),
    (4, 256, 256, 64, 3), (1, 5, 70, 13, 200), (2, 1, 1, 1, 1)])
def test_wgrad_plan_covers_every_k_tile_once(batch, height, width, c, o):
    """Each K tile lies in exactly one split, no split is empty, every
    pixel lies in one K tile, and the grid's tiles cover C x O."""
    plan = K.wgrad_plan(batch, height, width, c, o, 132)
    seen = np.zeros(plan.strips, np.int64)
    for s in range(plan.splits):
        r = plan.split_tiles(s)
        assert len(r) >= 1 and len(r) * K.WGRAD_TW <= plan.k_split
        seen[r.start:r.stop] += 1
    assert (seen == 1).all()
    cover = np.zeros((batch, height, width), np.int64)
    for q in range(plan.strips):
        n, h, w0 = plan.tile(q)
        cover[n, h, w0:w0 + K.WGRAD_TW] += 1
    assert (cover == 1).all()
    assert plan.tiles * plan.bm * plan.bn >= c * o
    assert plan.splits <= max(1, plan.strips // K.WGRAD_MIN_TILES)
    assert plan.tiles * plan.splits <= max(
        K.WGRAD_BLOCKS_PER_SM * 132 + plan.tiles, plan.tiles)


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


def _floats(u):
    return np.asarray(u, np.uint32).view(np.float32)


def tf32_split(v):
    """csrc/conv3x3_wgrad.cu tf32_split, as floats: hi truncated, lo the
    rest rounded to nearest (ties away), hi 2^-30 where that is 0 for a
    non-zero v; inf and NaN split into two copies."""
    b = _bits(v)
    a = b & np.uint32(0x7FFFFFFF)
    special = np.where(a > 0x7F800000, np.uint32(0x7FFFE000), b)
    hi = _floats(b & MASK)
    with np.errstate(invalid="ignore", over="ignore"):
        lo = (_bits(np.asarray(v, np.float32) - hi) + np.uint32(0x1000)) \
            & MASK
        tiny = _bits(hi * np.float32(2.0 ** -30))
    lo = np.where((lo == 0) & (a != 0), tiny, lo)
    inf_nan = a >= 0x7F800000
    return (_floats(np.where(inf_nan, special, _bits(hi))),
            _floats(np.where(inf_nan, special, lo)))


def tf32_round(v):
    """csrc/conv3x3_wgrad.cu tf32_round: rna, truncated where that would
    overflow, a canonical NaN for NaN."""
    b = _bits(v)
    a = b & np.uint32(0x7FFFFFFF)
    r = np.where(a >= 0x7F7FF000, b & MASK, (b + np.uint32(0x1000)) & MASK)
    return _floats(np.where(a > 0x7F800000, np.uint32(0x7FFFE000), r))


def test_wgrad_split_bits():
    """hi + lo holds v to 2^-21 of |v|, lo is never 0 and never of hi's
    opposite sign for a non-zero finite v, both are TF32 values; one pass
    is within 2^-11; an infinity meets each non-zero partner as an
    infinity of the product's sign, 0 as NaN, as one fp32 product does."""
    rng = np.random.default_rng(11)
    v = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
         ).astype(np.float32)
    hi, lo = tf32_split(v)
    assert ((_bits(hi) | _bits(lo)) & ~MASK == 0).all()
    assert ((lo != 0) & (np.sign(lo) == np.sign(hi))).all()
    assert (np.abs(v.astype(np.float64) - hi - lo)
            <= 2.0 ** -21 * np.abs(v)).all()
    r = tf32_round(v)
    assert (np.abs(r.astype(np.float64) - v) <= 2.0 ** -11 * np.abs(v)).all()
    assert (tf32_split(np.zeros(1, np.float32))[1] == 0).all()
    partner = np.array([0.5, 0.1, -0.1, -3.0, 0.0, np.inf, -np.inf],
                       np.float32)
    ph, pl = tf32_split(partner)
    for x in (np.inf, -np.inf):
        xh, xl = tf32_split(np.array([x], np.float32))
        with np.errstate(invalid="ignore"):
            got = xh * ph + xh * pl + xl * ph
            want = np.float32(x) * partner
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert (got[~np.isnan(want)] == want[~np.isnan(want)]).all()


def _emulate(x, g, passes, sms=132):
    """The kernel's walk in numpy: for each output tile and split, the K
    tiles of its run staged as zero-filled halo'd x and g tiles, the nine
    tap windows' products at `passes` (float64 sums of the TF32 operands'
    exact products: the accumulation order is not what is emulated), the
    partials summed in split order."""
    bb, h, wd, c = x.shape
    o = g.shape[-1]
    plan = K.wgrad_plan(bb, h, wd, c, o, sms)
    tw = K.WGRAD_TW
    if passes == 3:
        (xh, xl), (gh, gl) = tf32_split(x), tf32_split(g)
        terms = [(xh, gh), (xh, gl), (xl, gh)]
    else:
        terms = [(tf32_round(x), tf32_round(g))]
    parts = np.zeros((plan.splits, 3, 3, c, o))
    for s in range(plan.splits):
        for q in plan.split_tiles(s):
            n, hh, w0 = plan.tile(q)
            for xa, ga in terms:
                xs = np.zeros((3, tw + 2, plan.tiles * plan.bm))
                gs = np.zeros((tw, plan.tiles * plan.bn))
                for row in range(3):
                    r = hh - 1 + row
                    if 0 <= r < h:
                        lo, hi = max(w0 - 1, 0), min(w0 + tw + 1, wd)
                        xs[row, lo - (w0 - 1):hi - (w0 - 1), :c] = \
                            xa[n, r, lo:hi]
                gs[:min(tw, wd - w0), :o] = ga[n, hh, w0:w0 + tw]
                for ky in range(3):
                    for kx in range(3):
                        parts[s, ky, kx] += (xs[ky, kx:kx + tw, :c].T
                                             @ gs[:, :o])
    return parts.sum(0), plan


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("shape,o", [((2, 5, 37, 3), 64), ((1, 9, 33, 40), 3),
                                     ((3, 4, 20, 17), 9)])
def test_wgrad_walk_matches_float64(shape, o, passes):
    """The emulated walk (ragged K tiles, the halo at every image edge,
    several splits) against the float64 weight gradient, within the bar
    chip_smoke.py holds the card's kernel to: (2^-19 at three passes,
    2^-10 + 2^-22 at one, + (K_split + splits) 2^-22) sum |x||g|."""
    rng = np.random.default_rng(sum(shape) + o + passes)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (o,)).astype(np.float32)
    got, plan = _emulate(x, g, passes, sms=4)
    assert plan.splits > 1
    x64, g64 = torch.from_numpy(x).double(), torch.from_numpy(g).double()

    def wgrad64(a, b):
        return torch.nn.grad.conv2d_weight(
            a.permute(0, 3, 1, 2), (o, shape[-1], 3, 3),
            b.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0).numpy()

    want, mag = wgrad64(x64, g64), wgrad64(x64.abs(), g64.abs())
    per = 2.0 ** -19 if passes == 3 else 2.0 ** -10 + 2.0 ** -22
    bar = (per + (plan.k_split + plan.splits) * 2.0 ** -22) * mag
    assert (np.abs(got - want) <= bar).all()
    # and the products are TF32's, not fp32's: one pass is visibly coarser
    if passes == 1:
        assert np.abs(got - want).max() > 2.0 ** -16 * mag.max()


@pytest.mark.parametrize("passes", [3, 1])
def test_opcheck_wgrad_op(passes):
    """``rerevst::conv3x3_wgrad``'s schema, CPU implementation and fake
    (shape, dtype and strides) agree, as ``torch.library.opcheck`` checks
    them."""
    x, _, _, g = _inputs((2, 5, 7, 3), 4, seed=9)
    torch.library.opcheck(torch.ops.rerevst.conv3x3_wgrad.default,
                          (torch.from_numpy(x), torch.from_numpy(g), passes))
