"""The streamed C = 64 conv kernel's index math, on the CPU (no card).

``csrc/conv3x3.cu``'s streamed design splits a conv into work units (image x
a strip of 128 output columns x a band of R output rows) that persistent
blocks take in turn, streams each unit's R + 2 input rows through three
rolling accumulators, and reads TMA rows stored with the 128-byte swizzle.
These tests hold that index math, as the wrapper's plan
(``rerevst_torch.kernels.conv3x3.conv_plan``) and a numpy emulation of the
kernel's row order state it, to the plain conv.

Tolerance of the emulation: it and the plain version sum K = 9 C fp32
products in other orders, each within K 2^-24 sum|x||w| of the exact sum,
so they agree to K 2^-22 sum|x||w| (+ |b|), the card tests' conv bound.
"""

import numpy as np
import pytest
import torch

from rerevst_torch.kernels.conv3x3 import (
    TW,
    ConvPlan,
    conv3x3_implicit_gemm_plain,
    conv_plan,
    out_tile,
)

H100_SMS = 132


def swizzle_chunk(p, j):
    """Where TMA's 128-byte swizzle puts 16-byte chunk ``j`` (8 channels) of
    box pixel ``p`` in the pixel's 128-byte row of a 1024-byte-aligned slot,
    and where the kernel's ldmatrix addresses read it."""
    return j ^ (p & 7)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 2, 37, 640])
@pytest.mark.parametrize("width", [1, 7, 130, 640])
def test_plan_covers_every_pixel_once(batch, height, width):
    """Every output pixel of every output-channel tile belongs to exactly one
    unit, the blocks take every unit once, and the grid (one block per SM in
    all) never exceeds the units."""
    for o in (3, 5, 64, 128):
        for sms in (H100_SMS, 7):
            plan = conv_plan(batch, height, width, o, sms)
            assert plan.n_tiles == -(-o // out_tile(o))
            assert 1 <= plan.grid <= plan.units
            assert plan.grid * plan.n_tiles <= max(sms, plan.n_tiles)
            assert 1 <= plan.rows <= height
            taken = sorted(u for bx in range(plan.grid)
                           for u in plan.block_units(bx))
            assert taken == list(range(plan.units))
            cover = np.zeros((batch, height, width), np.int32)
            for u in range(plan.units):
                b, y0, x0, rows = plan.unit(u)
                assert 0 <= b < batch and 0 <= y0 < height and 0 <= x0 < width
                assert rows == min(plan.rows, height - y0) >= 1
                cover[b, y0:y0 + rows, x0:x0 + TW] += 1
            assert (cover == 1).all(), (o, sms)


def test_plan_balances_the_benchmark_shape():
    """16 frames of 640^2 on 132 SMs: the busiest block streams at most 8%
    more input rows than the mean, and the halo rows cost at most 8%."""
    plan = conv_plan(16, 640, 640, 64, H100_SMS)
    rows = [sum(plan.unit(u)[3] + 2 for u in plan.block_units(bx))
            for bx in range(plan.grid)]
    assert max(rows) <= 1.08 * np.mean(rows)
    assert sum(rows) <= 1.08 * 16 * 640 * plan.strips
    assert plan.grid == H100_SMS
    # O = 128 splits the SMs over two 64-wide tiles of output channels.
    assert conv_plan(16, 640, 640, 128, H100_SMS).grid == H100_SMS // 2


def _emulate(x, w, b, plan):
    """The kernel's order of work in numpy (fp32): each unit's input rows
    r = y0 - 1 .. y0 + rows as TMA delivers them (130-pixel boxes, zero
    outside the image), tap dy of row r added into output row r + 1 - dy
    through three rolling accumulators (tap 0 starts one afresh), output row
    r - 1 stored after row r.  Accumulators start as NaN: a product that
    leaked into a stored row without a fresh start would show."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    y = np.full((bsz, h, wd, o), np.nan, np.float32)
    for bx in range(plan.grid):
        for u in plan.block_units(bx):
            bi, y0, x0, rows = plan.unit(u)
            acc = np.full((3, TW, o), np.nan, np.float32)
            for t in range(rows + 2):
                r = y0 - 1 + t
                box = np.zeros((TW + 2, c), np.float32)
                if 0 <= r < h:
                    lo, hi = max(x0 - 1, 0), min(x0 + TW + 1, wd)
                    box[lo - (x0 - 1):hi - (x0 - 1)] = x[bi, r, lo:hi]
                for dy in range(3):
                    prod = sum(box[dx:dx + TW] @ w[dy, dx] for dx in range(3))
                    k = (t - dy) % 3
                    acc[k] = prod if dy == 0 else acc[k] + prod
                if t >= 2:
                    n = min(TW, wd - x0)
                    y[bi, y0 + t - 2, x0:x0 + n] = acc[(t - 2) % 3][:n] + b
    return y


@pytest.mark.parametrize("plan_of", ["wrapper", "bands_of_4", "one_band"])
def test_rolling_accumulators_match_plain(plan_of):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 8)) / 24).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    if plan_of == "wrapper":
        plan = conv_plan(2, 9, 11, 8, H100_SMS)
    elif plan_of == "bands_of_4":
        plan = ConvPlan(2, 9, 11, rows=4, grid=2, n_tiles=1)
    else:
        plan = ConvPlan(2, 9, 11, rows=9, grid=1, n_tiles=1)
    got = _emulate(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * 64 * 2.0 ** -22 * scale).all()


def test_swizzle_spreads_ldmatrix_rows_over_banks():
    """Each box pixel's eight 16-byte chunks land on eight distinct places
    of its 128-byte row, and for every dx shift and chunk, the 8 consecutive
    pixels one ldmatrix phase reads fall on 8 distinct 16-byte bank groups
    (a pixel row is 128 bytes, one full turn of the 32 banks)."""
    for p in range(TW + 2):
        assert sorted(swizzle_chunk(p, j) for j in range(8)) == list(range(8))
    for dx in range(3):
        for j in range(8):
            for q0 in range(0, TW, 8):
                groups = {swizzle_chunk(q0 + i + dx, j) for i in range(8)}
                assert len(groups) == 8
