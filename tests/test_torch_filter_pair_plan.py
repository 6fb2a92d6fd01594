"""The filter-pair kernel's index and split arithmetic, on the CPU (no card).

``csrc/filter_chain.cu`` splits the rows into 16-row tiles over a persistent
grid (the wrapper's ``rerevst_torch.kernels.filter_chain.row_plan``), runs
both products as mma.sync m16n8k8 TF32 with the first product's C fragment
reused as the second's A fragment under a k permutation, and makes the
products fp32-accurate by a hi/lo TF32 split.  These tests hold each of
those to the plain version:

* the plan: every row read and written exactly once, block shares within
  one tile of each other, the ragged tail masked;
* a numpy emulation of the m16n8k8 fragment maps (PTX ISA, "Matrix
  Fragments for mma.m16n8k8", .tf32) and of the kernel's channel
  numbering: in fp64 it equals the plain chain to rounding;
* an emulation of the split (cvt.rna.tf32: round to nearest, ties away,
  at bit 13): the dropped terms are at most 3 x 2^-22 of sum|a||b| per
  product, so the chain stays within 2^-19 (|x| |f1|^T) |f2|^T of the exact
  result, and within the card checks' tolerance of
  ``dynamic_filter_pair_plain`` (1e-5 of the output's scale in fp32, one
  storage ulp plus that in f16/bf16).
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.kernels.filter_chain import (
    TILE_ROWS,
    WARPS,
    RowPlan,
    dynamic_filter_pair_plain,
    row_plan,
)

H100_SMS = 132
C = 32


# ---------------------------------------------------------------------------
# (a) the row plan
# ---------------------------------------------------------------------------

def kernel_warp_tiles(plan: RowPlan, bx: int, warp: int) -> range:
    """The kernel's own integer arithmetic for a warp's tiles."""
    tiles = -(-plan.rows // TILE_ROWS)
    end = (bx + 1) * tiles // plan.grid
    first = bx * tiles // plan.grid + warp
    n = -(-(end - first) // WARPS) if first < end else 0
    return range(first, first + n * WARPS, WARPS)


def kernel_rows(plan: RowPlan, tile: int):
    """The rows a tile's lanes copy in and store (lane g, half h: row
    16 tile + g + 8 h, masked at the end)."""
    rows = [TILE_ROWS * tile + g + 8 * h for h in range(2) for g in range(8)]
    return [r for r in rows if r < plan.rows]


@pytest.mark.parametrize("rows", [102400, 1, 15, 16, 17, 231, 4099, 10007])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_plan_covers_every_row_once(rows, sms):
    plan = row_plan(rows, sms)
    assert plan.tiles == -(-rows // TILE_ROWS)
    assert 1 <= plan.grid == min(plan.tiles, sms)
    shares = [plan.block_tiles(bx) for bx in range(plan.grid)]
    # Contiguous shares, in order, of whole tiles, within one tile.
    assert [t for s in shares for t in s] == list(range(plan.tiles))
    sizes = [len(s) for s in shares]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    read = np.zeros(rows, np.int32)
    for bx in range(plan.grid):
        per_warp = [plan.warp_tiles(bx, w) for w in range(WARPS)]
        assert per_warp == [kernel_warp_tiles(plan, bx, w)
                            for w in range(WARPS)]
        counts = [len(p) for p in per_warp]
        assert max(counts) - min(counts) <= 1
        assert sorted(t for p in per_warp for t in p) == list(shares[bx])
        for p in per_warp:
            for tile in p:
                got = kernel_rows(plan, tile)
                assert got == sorted(plan.tile_rows(tile))
                read[got] += 1
    assert (read == 1).all()
    # The ragged tail: the last tile holds the rows left over, no more.
    assert len(plan.tile_rows(plan.tiles - 1)) == rows - TILE_ROWS * (
        plan.tiles - 1)


def test_plan_of_the_main_path():
    """16 frames of 640^2 at 1/8 scale: 102,400 rows, 6,400 tiles over the
    H100's 132 SMs, 48 or 49 tiles a block and 6 or 7 a warp."""
    plan = row_plan(16 * 80 * 80, H100_SMS)
    assert (plan.tiles, plan.grid) == (6400, H100_SMS)
    assert {len(plan.block_tiles(bx)) for bx in range(plan.grid)} == {48, 49}
    assert {len(plan.warp_tiles(bx, w)) for bx in range(plan.grid)
            for w in range(WARPS)} == {6, 7}


# ---------------------------------------------------------------------------
# (b) the fragment maps and the C -> A reuse
# ---------------------------------------------------------------------------

def a_pos(lane, i):
    """(row, k) of register a_i of a 16 x 8 TF32 A fragment."""
    g, t = divmod(lane, 4)
    return g + 8 * (i % 2), t + 4 * (i // 2)


def b_pos(lane, i):
    """(k, n) of register b_i of an 8 x 8 TF32 B fragment."""
    g, t = divmod(lane, 4)
    return t + 4 * i, g


def c_pos(lane, i):
    """(row, n) of register c_i of a 16 x 8 fp32 C fragment."""
    g, t = divmod(lane, 4)
    return g + 8 * (i // 2), 2 * t + i % 2


def mma(d, a, b):
    """d[lane] += the warp's A @ B, each assembled from its lanes'
    registers (every element from exactly one lane)."""
    am = np.full((16, 8), np.nan)
    bm = np.full((8, 8), np.nan)
    for lane in range(32):
        for i in range(4):
            am[a_pos(lane, i)] = a[lane][i]
        for i in range(2):
            bm[b_pos(lane, i)] = b[lane][i]
    assert not np.isnan(am).any() and not np.isnan(bm).any()
    dm = am @ bm
    for lane in range(32):
        for i in range(4):
            d[lane][i] += dm[c_pos(lane, i)]


def leaky(v):
    return np.where(v >= 0, v, v * 0.2)


def ch(v, t, m):
    """The channel of lane t's value m of a row: chunk k = m // v of the
    lane holds channels v (4k + t) .. + v - 1 (v channels per 16-byte
    chunk: 8 in 16-bit storage, 4 in fp32)."""
    return v * (4 * (m // v) + t) + m % v


def emulate_tile(x16, f1, f2, v):
    """One warp's tile as csrc/filter_chain.cu computes it, in fp64 and
    without the split: 16 rows of x in, 16 rows out."""
    lanes = [divmod(lane, 4) for lane in range(32)]
    # The lane's 8 values of rows g and g + 8.
    e = [[x16[g + 8 * h, [ch(v, t, m) for m in range(8)]] for h in range(2)]
         for g, t in lanes]
    acc = [[np.zeros(4) for _ in range(32)] for _ in range(4)]
    for kb in range(4):
        a = [[e[lane][0][2 * kb], e[lane][1][2 * kb], e[lane][0][2 * kb + 1],
              e[lane][1][2 * kb + 1]] for lane in range(32)]
        for nb in range(4):
            b = [[f1[8 * nb + g, ch(v, t, 2 * kb + j)] for j in range(2)]
                 for g, t in lanes]
            mma(acc[nb], a, b)
    out = [[np.zeros(4) for _ in range(32)] for _ in range(4)]
    for kb in range(4):
        a = [leaky(acc[kb][lane][[0, 2, 1, 3]]) for lane in range(32)]
        for nb in range(4):
            b = [[f2[ch(v, g // 2, 2 * nb + g % 2), 8 * kb + 2 * t + j]
                  for j in range(2)] for g, t in lanes]
            mma(out[nb], a, b)
    y = np.full((16, C), np.nan)
    for lane, (g, t) in enumerate(lanes):
        for h in range(2):
            for nb in range(4):
                for j in range(2):
                    y[g + 8 * h, ch(v, t, 2 * nb + j)] = \
                        out[nb][lane][2 * h + j]
    return y


@pytest.mark.parametrize("v", [8, 4])
def test_channel_maps_are_bijections(v):
    """The kernel's numbering of the first product's k (x channels: k = t
    is value 2 kb, k = t + 4 value 2 kb + 1) and of the second's n (output
    channels: column 2t + j is value 2 nb + j), block by block, covers 0..31
    once; and each copy or store instruction (chunk k of lanes t = 0..3)
    covers whole 32-byte sectors: 4 v consecutive channels from 4 v k."""
    x_ch = [ch(v, t, 2 * kb + j) for kb in range(4) for j in range(2)
            for t in range(4)]
    out_ch = [ch(v, c // 2, 2 * nb + c % 2) for nb in range(4)
              for c in range(8)]
    assert sorted(x_ch) == list(range(C)) == sorted(out_ch)
    for k in range(8 // v):
        cover = sorted(ch(v, t, k * v + m) for t in range(4) for m in range(v))
        assert cover == list(range(4 * v * k, 4 * v * (k + 1)))


@pytest.mark.parametrize("v", [8, 4])
@pytest.mark.parametrize("rows,sms", [(16, 1), (5, 1), (37, 2), (90, 3)])
def test_fragment_chain_matches_plain(rows, sms, v):
    """The whole kernel in fp64 — plan, zero-filled tail, fragment maps, the
    C -> A reuse (a = c0, c2, c1, c3), stores — against the plain chain, in
    the channel numbering of 16-bit (v = 8) and fp32 (v = 4) storage."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, C))
    f1 = rng.standard_normal((C, C)) * 0.3
    f2 = rng.standard_normal((C, C)) * 0.3
    plan = row_plan(rows, sms)
    y = np.full((rows, C), np.nan)
    for bx in range(plan.grid):
        for w in range(WARPS):
            for tile in plan.warp_tiles(bx, w):
                r = plan.tile_rows(tile)
                x16 = np.zeros((16, C))
                x16[:len(r)] = x[r.start:r.stop]
                y[r.start:r.stop] = emulate_tile(x16, f1, f2, v)[:len(r)]
    want = leaky(x @ f1.T) @ f2.T
    assert not np.isnan(y).any()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-12 * np.abs(want).max())


# ---------------------------------------------------------------------------
# (c) the TF32 split
# ---------------------------------------------------------------------------

def tf32_rna(v):
    """cvt.rna.tf32.f32 with the low 13 bits cleared: add half of bit 13 to
    the magnitude bits (a carry rounds up the exponent) and truncate."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    v = np.asarray(v, np.float32)
    hi = tf32_rna(v)
    with np.errstate(invalid="ignore"):
        lo = tf32_rna(v - hi)
    return hi, lo


def emulate_split(x, f1, f2):
    """The kernel's arithmetic on [rows, 32] storage-dtype x: products of
    TF32 values (exact), summed without error (fp64) into fp32 accumulators,
    leaky in fp32, the output rounded once to x's dtype."""
    xf = x.float().numpy()
    f1h, f1l = (p.astype(np.float64) for p in split(f1))
    f2h, f2l = (p.astype(np.float64) for p in split(f2))
    with np.errstate(invalid="ignore", over="ignore"):
        if x.dtype == torch.float32:
            xh, xl = (p.astype(np.float64) for p in split(xf))
            h = xl @ f1h.T + xh @ f1l.T + xh @ f1h.T
        else:  # 16-bit values are exact in TF32: no split of x
            xh = xf.astype(np.float64)
            h = xh @ f1l.T + xh @ f1h.T
        hv = leaky(h.astype(np.float32))
        hh, hl = (p.astype(np.float64) for p in split(hv))
        out = (hl @ f2h.T + hh @ f2l.T + hh @ f2h.T).astype(np.float32)
    return torch.from_numpy(out).to(x.dtype)


def within_tolerance(got, want):
    """chip_smoke.py's rule: the same non-finite places; 1e-5 of the scale
    in fp32, one storage ulp plus that in f16/bf16."""
    g, w = got.float(), want.float()
    if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
        return False
    fin = torch.isfinite(w)
    g, w = g[fin], w[fin]
    slack = 1e-5 * w.abs().max().clamp_min(1e-30)
    if got.dtype == torch.float32:
        return bool((g - w).abs().max() <= slack)
    mant = {torch.float16: 10, torch.bfloat16: 7}[got.dtype]
    tiny = {torch.float16: 2.0 ** -24, torch.bfloat16: 2.0 ** -133}[got.dtype]
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                     - mant).clamp_min(tiny)
    return bool(((g - w).abs() <= ulp + slack).all())


def test_split_rounding():
    """hi is TF32 (low 13 bits clear) within 2^-11 of v, hi + lo within
    2^-22; ties go away from zero; inf splits into inf and NaN."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))
         ).astype(np.float32)
    hi, lo = split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    v64 = v.astype(np.float64)
    assert (np.abs(v64 - hi) <= 2.0 ** -11 * np.abs(v64)).all()
    assert (np.abs(v64 - hi - lo) <= 2.0 ** -22 * np.abs(v64)).all()
    tie = np.float32(1 + 2.0 ** -11)  # halfway between TF32 neighbours
    assert tf32_rna(tie) == np.float32(1 + 2.0 ** -10)
    assert tf32_rna(-tie) == -np.float32(1 + 2.0 ** -10)
    assert tf32_rna(np.float32(1 + 2.0 ** -12)) == np.float32(1)
    hi, lo = split(np.array([np.inf, -np.inf], np.float32))
    assert np.isinf(hi).all() and np.isnan(lo).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("scales", [(1e3, 1e-3), (1e5, 1e-6), (0.2, 0.2)])
def test_split_chain_within_tolerance(dtype, scales):
    """Filters far outside f16's range, in every storage dtype: the split
    chain stays within its bound of the exact chain and within the card
    checks' tolerance of the plain version."""
    rng = np.random.default_rng(1)
    rows = 2 * 13 * 11
    x = torch.from_numpy(rng.standard_normal((rows, C)).astype(np.float32)) \
        .to(dtype)
    f1 = (rng.standard_normal((C, C)) * scales[0]).astype(np.float32)
    f2 = (rng.standard_normal((C, C)) * scales[1]).astype(np.float32)
    got = emulate_split(x, f1, f2)
    want = dynamic_filter_pair_plain(x, torch.from_numpy(f1),
                                     torch.from_numpy(f2))
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert within_tolerance(got, want)
    if dtype == torch.float32:
        xd = x.double().numpy()
        exact = leaky(xd @ f1.astype(np.float64).T) @ f2.astype(np.float64).T
        bound = (np.abs(xd) @ np.abs(f1.astype(np.float64)).T) \
            @ np.abs(f2.astype(np.float64)).T
        assert (np.abs(got.double().numpy() - exact) <= 2.0 ** -19 * bound).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_split_chain_nonfinite_rows(dtype):
    """A row with an inf or NaN input comes out non-finite where the plain
    version's does (inf splits into inf and NaN); the other rows agree."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((37, C)).astype(np.float32)) \
        .to(dtype)
    x[3, 5] = float("inf")
    x[17, 0] = float("-inf")
    x[36, 31] = float("nan")
    f1 = (rng.standard_normal((C, C)) * 1e3).astype(np.float32)
    f2 = (rng.standard_normal((C, C)) * 1e-3).astype(np.float32)
    got = emulate_split(x, f1, f2)
    want = dynamic_filter_pair_plain(x, torch.from_numpy(f1),
                                     torch.from_numpy(f2))
    bad = ~torch.isfinite(want)
    assert bad.any(dim=1).tolist() == [r in (3, 17, 36) for r in range(37)]
    assert within_tolerance(got, want)
