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

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.kernels import conv3x3 as K
from rerevst_torch.models import layers as L
from rerevst_tpu.models import layers as jL

SRC = Path(K.__file__).resolve().parent.parent / "csrc" / "conv3x3_wgrad.cu"
MASK = np.uint32(0xFFFFE000)

#: (B, H, W, C), O: C in {3, 8, 64} x O in {3, 64}, odd and even H and W,
#: batch 1 and 2.
SHAPES = [((1, 7, 9, 3), 64), ((2, 8, 6, 3), 3), ((2, 5, 10, 8), 64),
          ((1, 6, 11, 8), 3), ((1, 9, 8, 64), 64), ((2, 4, 7, 64), 3)]


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
    """kernels/conv3x3.py's K tile, route and units are the kernel's: the
    launcher's route predicate, the wgmma route's 64 x 32 unit, the
    mma.sync route's dispatch."""
    src = SRC.read_text()
    assert _source_int("kTW") == K.WGRAD_TW
    assert (_source_int("kTcM"), _source_int("kTcN")) == K.WGRAD_TC_TILE
    assert "return C >= 8 && O >= 8 && C % 4 == 0 && O % 4 == 0 &&" in src
    assert "  if (tc_route(x, g, C, O))" in src
    assert "if (O <= 8) return launch_mma<4, 1, 1, P>" in src   # 64 x 8
    assert "  return launch_mma<1, 8, 2, P>" in src             # 16 x 64
    cases = [((512, 3), "mma", (64, 8)), ((3, 64), "mma", (16, 64)),
             ((16, 512), "wgmma", (64, 32)), ((17, 9), "mma", (16, 64)),
             ((64, 64), "wgmma", (64, 32)), ((8, 8), "wgmma", (64, 32)),
             ((64, 6), "mma", (64, 8)), ((200, 192), "wgmma", (64, 32))]
    for (c, o), route, tile in cases:
        assert K.wgrad_route(c, o) == route and K.wgrad_tile(c, o) == tile
    assert K.wgrad_route(64, 64, aligned=False) == "mma"


def test_wgrad_probe_edits_match_the_kernel_source():
    """scripts/probe_wgrad.py builds edited copies of the kernel by string
    replacement: each of its edits matches the source exactly once."""
    import importlib.util

    path = SRC.parents[2] / "scripts" / "probe_wgrad.py"
    spec = importlib.util.spec_from_file_location("probe_wgrad", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = SRC.read_text()
    assert probe.VARIANTS["as_is"] == []
    for name, edits in probe.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


@pytest.mark.parametrize("batch,height,width,c,o", [
    (4, 256, 256, 64, 64), (4, 32, 32, 512, 32), (4, 256, 256, 3, 64),
    (4, 256, 256, 64, 3), (1, 5, 70, 13, 200), (2, 1, 1, 1, 1),
    (4, 32, 32, 256, 512), (1, 3, 45, 200, 192)])
def test_wgrad_plan_covers_every_k_tile_once(batch, height, width, c, o):
    """Each K tile lies in exactly one split, no split is empty, every
    pixel lies in one K tile, and the grid's tiles cover C x O.  The
    wgmma route takes as many splits as keep its items within the SMs
    (one persistent block an SM) and no more than there are K tiles; the
    mma.sync route aims at WGRAD_BLOCKS_PER_SM blocks an SM; a workspace
    holds the partials wherever there are several splits."""
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
    assert plan.workspace_bytes == (
        plan.splits * 9 * c * o * 4 if plan.splits > 1 else 0)
    if plan.route == "wgmma":
        assert plan.splits == max(1, min(132 // plan.tiles, plan.strips))
        assert plan.splits == 1 or plan.tiles * plan.splits <= 132
    else:
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


def _terms(passes, x, g):
    """The TF32 products of x g at `passes`: [(x-side, g-side), ...]."""
    if passes == 3:
        (xh, xl), (gh, gl) = tf32_split(x), tf32_split(g)
        return [(xh, gh), (xh, gl), (xl, gh)]
    return [(tf32_round(x), tf32_round(g))]


def _emulate_mma(x, g, passes, plan):
    """The mma.sync route's walk in numpy: for each output tile and split,
    the K tiles of its run staged as zero-filled halo'd x and g tiles, the
    nine tap windows' products at `passes` (float64 sums of the TF32
    operands' exact products: the accumulation order is not what is
    emulated), the partials summed in split order."""
    bb, h, wd, c = x.shape
    o = g.shape[-1]
    tw = K.WGRAD_TW
    terms = _terms(passes, x, g)
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
    return parts.sum(0)


def _x_index(row, p, cc):
    """csrc/conv3x3_wgrad.cu x_offset in floats: channel cc (0 .. 31) of
    pixel p of row `row` in a landed box of x {32 channels, 32 pixels, 3
    rows}, TMA's 128-byte swizzle (16-byte chunk j of a pixel at j ^ (p %
    8))."""
    return row * 1024 + p * 32 + (((cc >> 2) ^ (p & 7)) << 2) + (cc & 3)


def _a_lanes():
    """The consumer lanes' A fragment elements, as aoff and load_a compute
    them: for warp w, lane (gq, t), k8 step s4 and element e (flattened),
    the box of x, the pixel and channel in it, and the element's M row and
    K index in wgmma's m64k8 A (a0, a1: K t; a2, a3: K t + 4; a1, a3: row
    + 8)."""
    w, gq, t, s4, e = (a.ravel() for a in np.meshgrid(
        *map(np.arange, (4, 8, 4, 4, 4)), indexing="ij"))
    return dict(w=w, t=t, s4=s4, box=w >> 1, p=8 * s4 + 2 * t + (e >> 1),
                cc=16 * (w & 1) + gq + 8 * (e & 1),
                m=16 * w + gq + 8 * (e & 1), k=t + 4 * (e >> 1))


def _b_copies(gl, passes, nan0=None, nan2=None):
    """The splitter warps' B copies from the landed box of g gl [34 px,
    32 channels] (columns w0 - 1 .. w0 + 32): [tap kx][plane][32 rows x 32
    K values], wgmma's K-major B with the 128-byte swizzle, as the kernel's
    task loop writes them (task: channel n at k8 step s4, its ten columns
    split once, six 16-byte chunks); the hi (or one-pass) plane's first K
    value of tap 0's (tap 2's) channel n NaN where nan0[n] (nan2[n])."""
    out = np.zeros((3, 2 if passes == 3 else 1, 32 * 32), np.float32)
    for i in range(4 * 32):
        n, s4 = i % 32, i // 32
        v = gl[8 * s4:8 * s4 + 10, n]
        planes = tf32_split(v) if passes == 3 else (tf32_round(v),)
        for kx in range(3):
            for hf in range(2):
                j0 = hf - kx + 2
                at = n * 32 + (((2 * s4 + hf) ^ (n & 7)) << 2)
                for pl, val in enumerate(planes):
                    out[kx, pl, at:at + 4] = val[j0:j0 + 8:2]
                nan = {0: nan0, 2: nan2}.get(kx)
                if s4 == 0 and hf == 0 and nan is not None and nan[n]:
                    out[kx, 0, at] = np.nan
    return out


def _b_read(copy):
    """One B copy as wgmma reads it through desc_k128 + 32 s4 bytes:
    [k8 step][K index j][n], element (j, n) at byte n 128 + 32 s4 + 4 j
    before the swizzle."""
    s4, j, n = np.meshgrid(np.arange(4), np.arange(8), np.arange(32),
                           indexing="ij")
    return copy[n * 32 + (((2 * s4 + j // 4) ^ (n & 7)) << 2) + j % 4]


def _tc_tile(x, g, plan, n, hh, w0, c0, o0):
    """A wgmma-route K tile's landed boxes: x's two {32, 32, 3} boxes at
    (c0 + 32 b, w0, hh - 1) in their swizzled layout, g's {32, 34} box at
    (o0, w0 - 1, hh), zero past every edge."""
    _, h, wd, c = x.shape
    o = g.shape[-1]
    tw = K.WGRAD_TW
    xland = np.zeros((2, 3 * 1024), np.float32)
    row, p, cc = (a.ravel() for a in np.meshgrid(
        np.arange(3), np.arange(32), np.arange(32), indexing="ij"))
    for b in range(2):
        box = np.zeros((3, 32, 32), np.float32)
        for rr in range(3):
            r = hh - 1 + rr
            if 0 <= r < h:
                seg = x[n, r, w0:w0 + tw, c0 + 32 * b:c0 + 32 * b + 32]
                box[rr, :seg.shape[0], :seg.shape[1]] = seg
        xland[b, _x_index(row, p, cc)] = box.ravel()
    gl = np.zeros((34, 32), np.float32)
    lo, hi = max(w0 - 1, 0), min(w0 + tw + 1, wd)
    seg = g[n, hh, lo:hi, o0:o0 + 32]
    gl[lo - (w0 - 1):hi - (w0 - 1), :seg.shape[1]] = seg
    return xland, gl


def _emulate_tc(x, g, passes, plan):
    """The wgmma route's walk in numpy, through the kernel's index math:
    per unit (64 input x 32 output channels) and split, each K tile's
    landed boxes, the splitter warps' flags and B copies (g shifted by kx
    - 1 per tap, transposed K-major and swizzled), each consumer
    warpgroup's A fragments of its row loaded from the swizzled box and
    split lane by lane, the column a tap takes no product at zeroed where
    the flags say so, and the products of the nine taps (float64 sums of
    the TF32 operands' exact products; NaN in B for taps kx = 0 and 2 of
    the output channels whose g is non-finite at the image's first or last
    column), the partials summed in split order."""
    _, _, wd, c = x.shape
    o = g.shape[-1]
    a = _a_lanes()
    cb = -(-c // 64)
    parts = np.zeros((plan.splits, 3, 3, c, o))
    for unit in range(plan.tiles):
        c0, o0 = (unit % cb) * 64, (unit // cb) * 32
        mc, nc = min(64, c - c0), min(32, o - o0)
        for s in range(plan.splits):
            for q in plan.split_tiles(s):
                n, hh, w0 = plan.tile(q)
                xland, gl = _tc_tile(x, g, plan, n, hh, w0, c0, o0)
                pl = wd - 1 - w0
                bq = _b_copies(gl, passes, (w0 == 0) & ~np.isfinite(gl[1]),
                               (pl < 32) & ~np.isfinite(gl[min(pl, 31) + 1]))
                boxes = xland.reshape(2, 3, 32, 32)  # rows of the layout
                f = 0
                for rr in range(3):
                    for b in range(2):
                        at = lambda px: _x_index(rr, px, np.arange(32))
                        if pl < 32 and not np.isfinite(
                                xland[b, at(pl)]).all():
                            f |= 1
                        if w0 == 0 and not np.isfinite(
                                xland[b, at(0)]).all():
                            f |= 2
                del boxes
                for ky in range(3):
                    raw = xland[a["box"], _x_index(ky, a["p"], a["cc"])]
                    for kx in range(3):
                        skip = pl if kx == 0 and f & 1 else \
                            0 if kx == 2 and f & 2 else -1
                        v = np.where(a["p"] == skip, np.float32(0), raw)
                        planes = tf32_split(v) if passes == 3 \
                            else (tf32_round(v),)
                        mats = []
                        for val in planes:
                            m = np.zeros((4, 64, 8))
                            m[a["s4"], a["m"], a["k"]] = val
                            mats.append(m)
                        bs = [_b_read(bq[kx, i]) for i in range(len(planes))]
                        pairs = [(0, 0), (0, 1), (1, 0)] if passes == 3 \
                            else [(0, 0)]
                        with np.errstate(invalid="ignore"):
                            d = sum(np.einsum("smk,skn->mn", mats[i], bs[j])
                                    for i, j in pairs)
                        parts[s, ky, kx, c0:c0 + mc, o0:o0 + nc] += \
                            d[:mc, :nc]
    return parts.sum(0)


def _emulate(x, g, passes, sms=132):
    """The kernel's walk on the route ``wgrad_plan`` picks."""
    bb, h, wd, c = x.shape
    plan = K.wgrad_plan(bb, h, wd, c, g.shape[-1], sms)
    walk = _emulate_tc if plan.route == "wgmma" else _emulate_mma
    return walk(x, g, passes, plan), plan


def _wgrad64(x, g):
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(g).double()
    return torch.nn.grad.conv2d_weight(
        xt.permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        gt.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0).numpy()


#: ([B, H, W, C], O, SMs of the plan): the mma.sync route (C = 3, O = 3,
#: C = 17 off a multiple of 4) and the wgmma route (C and O off 64 and 32,
#: ragged K tiles, two C blocks, O in two units), each with several splits.
WALKS = [((2, 5, 37, 3), 64, 4), ((1, 9, 33, 40), 3, 4),
         ((3, 4, 20, 17), 9, 4), ((2, 5, 37, 8), 12, 4),
         ((1, 20, 45, 68), 36, 16), ((2, 6, 70, 24), 40, 8)]


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("shape,o,sms", WALKS)
def test_wgrad_walk_matches_float64(shape, o, sms, passes):
    """The emulated walk (ragged K tiles, the halo at every image edge,
    several splits) against the float64 weight gradient, within the bar
    chip_smoke.py holds the card's kernel to: (2^-19 at three passes,
    2^-10 + 2^-22 at one, + (K_split + splits) 2^-22) sum |x||g|."""
    rng = np.random.default_rng(sum(shape) + o + passes)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (o,)).astype(np.float32)
    got, plan = _emulate(x, g, passes, sms=sms)
    assert plan.splits > 1
    want, mag = _wgrad64(x, g), _wgrad64(np.abs(x), np.abs(g))
    per = 2.0 ** -19 if passes == 3 else 2.0 ** -10 + 2.0 ** -22
    bar = (per + (plan.k_split + plan.splits) * 2.0 ** -22) * mag
    assert (np.abs(got - want) <= bar).all()
    # and the products are TF32's, not fp32's: one pass is visibly coarser
    if passes == 1:
        assert np.abs(got - want).max() > 2.0 ** -16 * mag.max()


def test_wgrad_tc_layouts():
    """The wgmma route's index math on its own: the lanes' A fragments
    read from the swizzled box are x's row window in wgmma's A order (M =
    channel, K index t = pixel 2 t, t + 4 = pixel 2 t + 1 of the k8 step),
    32 lanes' loads of one element hit 32 banks, each A element is loaded
    once; the B copies read as wgmma reads them are g shifted by kx - 1
    (zero past the box) in that K order; the swizzled stores of a chunk
    loop's 8 consecutive channels hit 8 bank groups."""
    a = _a_lanes()
    # A: every (box, pixel, channel) of a row once
    assert len({(b, p, c) for b, p, c in zip(a["box"], a["p"], a["cc"])}) \
        == 2 * 32 * 32
    idx = _x_index(0, a["p"], a["cc"])
    for key in np.unique(np.stack([a["w"], a["s4"], a["m"] // 8 % 2,
                                   a["k"] // 4]), axis=1).T:
        sel = ((a["w"] == key[0]) & (a["s4"] == key[1])
               & (a["m"] // 8 % 2 == key[2]) & (a["k"] // 4 == key[3]))
        assert sel.sum() == 32 and len(set(idx[sel] % 32)) == 32
    assert (a["m"] == 32 * a["box"] + a["cc"]).all()
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    assert (a["p"] == 8 * a["s4"] + perm[a["k"]]).all()
    # B: the shifted, transposed g in the same K order
    rng = np.random.default_rng(3)
    gl = rng.standard_normal((34, 32)).astype(np.float32)
    for passes in (3, 1):
        bq = _b_copies(gl, passes)
        planes = tf32_split(gl) if passes == 3 else (tf32_round(gl),)
        for kx in range(3):
            for i, want in enumerate(planes):
                got = _b_read(bq[kx, i])          # [s4, j, n]
                s4, j = np.meshgrid(np.arange(4), np.arange(8),
                                    indexing="ij")
                px = 8 * s4 + perm[j] - kx + 2   # the box column
                assert np.array_equal(got, want[px])
    n = np.arange(8)
    for chunk in range(8):
        at = n * 32 + ((chunk ^ (n & 7)) << 2)   # floats, 16-byte chunks
        assert len(set((at // 4) % 8)) == 8


@pytest.mark.parametrize("passes", [3, 1])
def test_wgrad_tc_nonfinite_x_at_the_edge_columns(passes):
    """inf, -inf and NaN in x at the image's last and first columns (where
    taps kx = 0 and kx = 2 take no product: B holds the zero fill) and
    inside: the emulated wgmma walk gives NaN and inf exactly where the
    plain version does, of its sign, and the finite values within the
    bar."""
    shape, o = (2, 6, 40, 12), 8
    rng = np.random.default_rng(23 + passes)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (o,)).astype(np.float32)
    for idx, v in [((0, 2, 39, 3), np.inf), ((1, 4, 0, 5), -np.inf),
                   ((0, 3, 17, 1), np.nan), ((1, 0, 39, 11), -np.inf)]:
        x[idx] = v
    got, plan = _emulate(x, g, passes, sms=8)
    assert plan.route == "wgmma"
    want = K.conv3x3_wgrad_plain(torch.from_numpy(x),
                                 torch.from_numpy(g)).numpy()
    fin = np.isfinite(want)
    assert not fin.all() and fin.any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    assert np.array_equal(np.sign(got[inf]), np.sign(want[inf]))
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    per = 2.0 ** -19 if passes == 3 else 2.0 ** -10 + 2.0 ** -22
    bar = (per + (plan.k_split + plan.splits) * 2.0 ** -22) \
        * _wgrad64(np.abs(xz), np.abs(g))
    assert (np.abs(got - _wgrad64(xz, g))[fin] <= bar[fin]).all()


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("width", [40, 64])
def test_wgrad_tc_nonfinite_g_at_the_edge_columns(width, passes):
    """inf, -inf and NaN in g at the image's first and last columns, where
    the true sum takes them times the padding column of x (taps kx = 0 and
    2: no K tile holds that product where W is a multiple of 32), and
    inside: the emulated wgmma walk gives NaN and inf exactly where JAX's
    weight cotangent does, of its sign, and the finite values within the
    bar.  (The plain version on the CPU is no oracle here: oneDNN's weight
    gradient forms no products with the padding.)"""
    shape, o = (2, 6, width, 12), 40
    x, w, b, g = _inputs(shape, o, seed=29 + passes + width)
    for idx, v in [((0, 2, 0, 3), np.inf), ((1, 4, width - 1, 5), -np.inf),
                   ((0, 3, 17, 1), np.nan), ((1, 0, width - 1, 35), np.nan),
                   ((1, 5, 0, 39), -np.inf)]:
        g[idx] = v
    got, plan = _emulate(x, g, passes, sms=8)
    assert plan.route == "wgmma" and plan.splits > 1
    want = _jax_grads(x, w, b, g)[1][1]
    fin = np.isfinite(want)
    assert not fin.all() and fin.any()
    assert np.isnan(want[:, 0, :, 3]).all()
    assert np.isnan(want[:, 2, :, 5]).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    assert np.array_equal(np.sign(got[inf]), np.sign(want[inf]))
    gz = np.where(np.isfinite(g), g, 0).astype(np.float32)
    per = 2.0 ** -19 if passes == 3 else 2.0 ** -10 + 2.0 ** -22
    bar = (per + (plan.k_split + plan.splits) * 2.0 ** -22) \
        * _wgrad64(np.abs(x), np.abs(gz))
    assert (np.abs(got - _wgrad64(x, gz))[fin] <= bar[fin]).all()


@pytest.mark.parametrize("passes", [3, 1])
def test_opcheck_wgrad_op(passes):
    """``rerevst::conv3x3_wgrad``'s schema, CPU implementation and fake
    (shape, dtype and strides) agree, as ``torch.library.opcheck`` checks
    them."""
    x, _, _, g = _inputs((2, 5, 7, 3), 4, seed=9)
    torch.library.opcheck(torch.ops.rerevst.conv3x3_wgrad.default,
                          (torch.from_numpy(x), torch.from_numpy(g), passes))
