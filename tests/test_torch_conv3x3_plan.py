"""The TMA conv kernels' index math, on the CPU (no card).

``csrc/conv3x3.cu``'s streamed design (C = 64) splits a conv into work units
(image x a strip of 128 output columns x a band of R output rows) that
persistent blocks take in turn, streams each unit's R + 2 input rows
through three rolling accumulators, and reads TMA rows stored with the
128-byte swizzle.  Its wide design (C % 64 = 0, C >= 128) splits the output
into tiles of rows x cols pixels x N channels, and runs a K loop of tap-
shifted TMA boxes of 64 channels against 64-row weight slices that wgmma
reads N-contiguous through the same swizzle.  Its narrow design (C <= 7)
stages each 8 x 32 tile's zero-filled halo once and multiplies K = 9 C,
padded to a multiple of 16 with zeros, in one pass.  Its sliced design
(other C >= 8) walks the wide design's tiles over K slices of 16 or 32
channels, one halo'd TMA box per slice and dx feeding the three taps dy
through K-major descriptors with the 32- or 64-byte swizzle, and stages
its output in swizzled boxes for TMA stores; it also takes C % 64 = 0 with
O <= 64.  Its split-TF32 design (fp32, three passes, O > 32) walks the
sliced design's tiles over K slices of 16 fp32 channels and takes each
product as three TF32 passes, x_hi w_hi + x_hi w_lo + x_lo w_hi.  Its
one-pass design (fp32, one TF32 pass, O > 32) swaps the operands: the
weights are wgmma's A, 64 output channels a block, over 128 or 256 pixels
of the box of x as N; each consumer warpgroup rounds the box pixels its
own taps read, and the [channel][pixel] sums go out through a staging
buffer.
``csrc/conv3x3_rows.cu``'s rows design (fp32, O <= 32, both pass counts)
takes pixels as wgmma's A from registers, each fragment of a slice's one
box fed to the three taps dy through rolling accumulator rows.  These tests
hold that index math and that split, as the wrapper's plans (``conv_plan``,
``wide_plan``, ``narrow_plan``, ``sliced_plan``, ``tf32x3_plan``,
``tf32x1_plan``, ``tf32_rows_plan`` in
``rerevst_torch.kernels.conv3x3``) and numpy emulations of the kernels'
order of work state it, to the plain conv.  Beside them, the text edits
of ``scripts/probe_tf32_conv.py``'s and ``scripts/probe_rows_conv.py``'s
variants must each match the kernel source once.

Tolerance of the emulations: each and the plain version sum K = 9 C fp32
products in other orders, each within K 2^-24 sum|x||w| of the exact sum,
so they agree to K 2^-22 sum|x||w| (+ |b|), the card tests' conv bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.kernels.conv3x3 import (
    DESIGNS,
    NARROW_COLS,
    NARROW_ROWS,
    SLICED_COLS,
    SLICED_M,
    SLICED_MAX_O,
    TW,
    WIDE_COLS,
    ConvPlan,
    NarrowPlan,
    SlicedPlan,
    WidePlan,
    conv3x3_implicit_gemm_plain,
    conv_plan,
    design,
    direct_fp32_reckoning,
    narrow_plan,
    out_tile,
    slice_width,
    sliced_plan,
    MAX_STAGES,
    MIN_SPLIT_SLICES,
    ROWS_COLS,
    SMEM_MAX,
    TF32_ROWS_MAX_O,
    TF32X1_SHAPES,
    RowsPlan,
    Tf32x1Plan,
    rows_channel,
    rows_phases,
    tf32_rows_plan,
    tf32_rows_stage_reckoning,
    tf32_slice_width,
    tf32x1_plan,
    tf32x1_stage_reckoning,
    tf32x3_plan,
    tf32x3_stage_reckoning,
    wide_cols,
    wide_plan,
    with_splits,
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


# ---------------------------------------------------------------------------
# The wide design (C % 64 = 0, C >= 128)
# ---------------------------------------------------------------------------

#: csrc/conv3x3.cu wgmma_desc_mn: the B operand's leading offset (one
#: 64-column box to the next along N) and stride offset (one group of 8 k
#: rows to the next), in bytes, and the start address step of a k16 step.
B_LBO, B_SBO, B_K16 = 8192, 1024, 2048

#: The VGG shapes the wide kernel takes (x shape, O), 16 frames of 640^2.
VGG_WIDE = [((16, 320, 320, 128), 128), ((16, 160, 160, 128), 256),
            ((16, 160, 160, 256), 256), ((16, 80, 80, 256), 512)]


def test_design_by_shape():
    """The launcher's dispatch: C = 64 streamed, C % 64 = 0 with C >= 128
    wide where O > 64 and sliced where O <= 64 (the grid of
    scripts/conv_ab.py), 1 <= C <= 7 narrow, other C the sliced TMA + wgmma
    kernel (no 16-bit C reaches a cp.async + mma.sync kernel), fp32 the
    rows kernel at O <= 32 and the split-TF32 kernel at larger O, every C
    (none reaches the CUDA cores' FMAs)."""
    assert SLICED_MAX_O == 64
    for dt in (torch.float16, torch.bfloat16):
        for o in (3, 64, 65, 512):
            assert design(64, dt, o) == "streamed"
        for c in (128, 192, 256, 512, 1024):
            for o in (65, 128, 192, 512):
                assert design(c, dt, o) == "wide"
            for o in (1, 3, 16, 32, 64):
                assert design(c, dt, o) == "sliced"
        for c in range(1, 8):
            for o in (3, 64, 128):
                assert design(c, dt, o) == "narrow"
        for c in (8, 32, 96, 100, 160, 200):
            for o in (3, 64, 512):
                assert design(c, dt, o) == "sliced"
    for c in (1, 3, 7, 8, 64, 100, 128, 512):
        for o in (3, 32):
            assert design(c, torch.float32, o) == "tf32_rows"
        for o in (33, 64, 512):
            assert design(c, torch.float32, o) == "tf32x3"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 37, 130, 640])
@pytest.mark.parametrize("width", [1, 7, 37, 130, 640])
def test_wide_plan_covers_every_output_once(batch, height, width):
    """Every output pixel x channel belongs to exactly one tile, the blocks
    take every tile once, the grid never exceeds the tiles or the SMs, and
    the tile is one TMA box of 256 pixels (128 at N = 256)."""
    for o in (5, 64, 128, 192, 512):
        for sms in (H100_SMS, 7):
            plan = wide_plan(batch, height, width, o, sms)
            assert plan.cols in WIDE_COLS
            assert plan.rows * plan.cols == plan.m
            assert plan.m == (256 if plan.n <= 128 else 128)
            assert plan.n >= 8 and plan.n % 8 == 0
            assert 1 <= plan.grid <= min(plan.tiles, sms)
            taken = np.sort(np.concatenate(
                [np.asarray(plan.block_tiles(bx)) for bx in range(plan.grid)]))
            assert (taken == np.arange(plan.tiles)).all()
            cover = np.zeros((plan.n_tiles, batch, height, width), np.int32)
            chans = np.zeros(plan.n_tiles * plan.n, np.int32)
            for t in range(plan.tiles):
                b, y0, x0, n0 = plan.tile(t)
                assert 0 <= b < batch and 0 <= y0 < height \
                    and 0 <= x0 < width and 0 <= n0 < o
                assert y0 % plan.rows == 0 and x0 % plan.cols == 0
                cover[n0 // plan.n, b, y0:y0 + plan.rows,
                      x0:x0 + plan.cols] += 1
                if b == 0 and y0 == 0 and x0 == 0:
                    chans[n0:n0 + plan.n] += 1
            assert (cover == 1).all(), (o, sms)
            assert (chans == 1).all() and chans.size >= o


def test_wide_plan_order_and_vgg_tiles():
    """The channel tile runs fastest, then the strip, band and image; the
    chosen tile shape wastes no pixel at the four VGG shapes the wide kernel
    takes (N = 128: 4 x 64 at W = 320; N = 256: 4 x 32 at 160, 8 x 16 at
    80; and 2 x 128 at 640), and each shape fills the H100's 132 SMs."""
    plan = WidePlan(2, 9, 40, 300, cols=16, n=256, grid=3)
    assert [plan.tile(t) for t in range(5)] == [
        (0, 0, 0, 0), (0, 0, 0, 256), (0, 0, 16, 0), (0, 0, 16, 256),
        (0, 0, 32, 0)]
    assert plan.tile(2 * 3) == (0, 8, 0, 0)          # the next band
    assert plan.tile(2 * 3 * 2) == (1, 0, 0, 0)      # the next image
    assert wide_plan(16, 640, 640, 128, H100_SMS).cols == 128
    assert wide_plan(16, 640, 640, 128, H100_SMS).rows == 2
    for (b, h, w, _), o in VGG_WIDE:
        plan = wide_plan(b, h, w, o, H100_SMS)
        assert plan.cols == {320: 64, 160: 32, 80: 16}[w]
        assert plan.strips * plan.cols == w and plan.bands * plan.rows == h
        assert plan.n == (128 if o < 256 else 256)
        assert plan.rows == {320: 4, 160: 4, 80: 8}[w]
        assert plan.grid == H100_SMS


def _emulate_wide(x, w, b, plan):
    """The wide kernel's order of work in numpy (fp32): for each tile, K
    steps k = tap (C / 64) + slice; step k's A is the TMA box of channels
    64 slice .. + 63 at rows y0 + dy - 1 .., columns x0 + dx - 1 .. (zero
    outside the image), flattened to [128 px][64 ch] row by row; its B the
    [64 c][N o] slice of the [9C, O] weights (zero past O); the product of
    each step is added in turn (a warpgroup's m64 blocks sum alike, each
    row on its own).  Only pixels and channels inside the output
    are stored, each once; the output starts as NaN."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    wk = np.zeros((9 * c, plan.n_tiles * plan.n), np.float32)
    wk[:, :o] = w.reshape(9 * c, o)
    y = np.full((bsz, h, wd, o), np.nan, np.float32)
    rows, cols = plan.rows, plan.cols
    for bx in range(plan.grid):
        for t in plan.block_tiles(bx):
            bi, y0, x0, n0 = plan.tile(t)
            acc = np.zeros((plan.m, plan.n), np.float32)
            for k in range(9 * (c // 64)):
                tap, sl = divmod(k, c // 64)
                dy, dx = divmod(tap, 3)
                box = np.zeros((rows, cols, 64), np.float32)
                ys, xs = y0 + dy - 1, x0 + dx - 1
                ylo, yhi = max(ys, 0), min(ys + rows, h)
                xlo, xhi = max(xs, 0), min(xs + cols, wd)
                if ylo < yhi and xlo < xhi:
                    box[ylo - ys:yhi - ys, xlo - xs:xhi - xs] = \
                        x[bi, ylo:yhi, xlo:xhi, 64 * sl:64 * sl + 64]
                acc += box.reshape(plan.m, 64) @ \
                    wk[k * 64:k * 64 + 64, n0:n0 + plan.n]
            out = (acc + np.pad(b, (0, plan.n_tiles * plan.n - o))
                   [n0:n0 + plan.n]).reshape(rows, cols, plan.n)
            nh, nw, nc = min(rows, h - y0), min(cols, wd - x0), \
                min(plan.n, o - n0)
            assert np.isnan(y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc]).all()
            y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc] = out[:nh, :nw, :nc]
    return y


@pytest.mark.parametrize("c,o,shape,cols", [
    (128, 5, (2, 9, 11), None), (128, 72, (1, 13, 7), 16),
    (256, 40, (1, 5, 19), 32), (256, 192, (2, 3, 9), None),
])
def test_wide_k_loop_matches_plain(c, o, shape, cols):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    plan = wide_plan(shape[0], shape[1], shape[2], o, H100_SMS)
    if cols is not None:
        plan = WidePlan(plan.batch, plan.height, plan.width, o, cols,
                        plan.n, grid=2)
    got = _emulate_wide(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


def tma_b_offset(k, n):
    """Byte offset at which TMA's 128-byte swizzle lands element (k, n) of
    a stage's B tile: 64-column box n // 64 (8192 bytes each), row k of it
    (128 bytes), 16-byte chunk (n % 64) // 8 at chunk ^ (k % 8)."""
    box, col = divmod(n, 64)
    return (box * 8192 + k * 128 + ((((col // 8) ^ (k % 8))) << 4)
            + 2 * (col % 8))


def wgmma_b_offset(step, kk, n):
    """Where wgmma, given wgmma_desc_mn's start address (+ B_K16 per k16
    step) and offsets, reads element (kk, n) of a k16 step's 16 x N B
    operand (MN-major, 128-byte swizzle): the canonical layout puts 8
    consecutive n in one 16-byte unit, 64 n in a 128-byte row, the 8 k rows
    of a group 128 bytes apart; the next 64 n at the leading offset, the
    next 8 k at the stride offset; then the swizzle XORs address bits 4-6
    with bits 7-9."""
    lin = (step * B_K16 + (n // 64) * B_LBO + (kk // 8) * B_SBO
           + (kk % 8) * 128 + (n % 64) * 2)
    return lin ^ (((lin >> 7) & 7) << 4)


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256])
def test_wgmma_reads_b_where_tma_lands_it(n):
    """For every k16 step and element of the [64 c][N o] tile, the address
    wgmma reads through the MN-major descriptor is the one TMA wrote, and a
    box's 64 x 64 elements land on distinct addresses; the 8 k rows of a
    group spread each 16-byte column chunk over 8 distinct bank groups."""
    for step in range(4):
        for kk in range(16):
            for col in range(n):
                assert wgmma_b_offset(step, kk, col) == \
                    tma_b_offset(16 * step + kk, col)
    offs = {tma_b_offset(k, col) for k in range(64) for col in range(64)}
    assert len(offs) == 64 * 64 and max(offs) < 8192
    for j in range(8):
        for g in range(8):
            groups = {(tma_b_offset(8 * g + r, 8 * j) >> 4) % 8
                      for r in range(8)}
            assert len(groups) == 8


# ---------------------------------------------------------------------------
# The narrow design (1 <= C <= 7)
# ---------------------------------------------------------------------------

#: csrc/conv3x3.cu Narrow: halo columns of a tile.
NARROW_HC = NARROW_COLS + 2


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 9, 37, 640])
@pytest.mark.parametrize("width", [1, 7, 33, 130, 640])
def test_narrow_plan_covers_every_output_once(batch, height, width):
    """Every output pixel x channel belongs to exactly one tile of one
    channel tile, the blocks of a channel tile take every tile once, and
    the grid never exceeds the tiles or two blocks per SM in all."""
    for o in (3, 5, 64, 72, 128):
        for sms in (H100_SMS, 7):
            plan = narrow_plan(batch, height, width, 3, o, sms)
            assert plan.n == (8 if o <= 8 else 64)
            assert 1 <= plan.grid <= plan.tiles
            assert plan.grid * plan.n_tiles <= max(2 * sms, plan.n_tiles)
            taken = np.sort(np.concatenate(
                [np.asarray(plan.block_tiles(bx)) for bx in range(plan.grid)]))
            assert (taken == np.arange(plan.tiles)).all()
            cover = np.zeros((batch, height, width), np.int32)
            for t in range(plan.tiles):
                b, y0, x0 = plan.tile(t)
                assert 0 <= b < batch and 0 <= y0 < height \
                    and 0 <= x0 < width
                assert y0 % NARROW_ROWS == 0 and x0 % NARROW_COLS == 0
                cover[b, y0:y0 + NARROW_ROWS, x0:x0 + NARROW_COLS] += 1
            assert (cover == 1).all(), (o, sms)
            chans = np.zeros(plan.n_tiles * plan.n, np.int32)
            for ny in range(plan.n_tiles):
                chans[ny * plan.n:(ny + 1) * plan.n] += 1
            assert (chans == 1).all() and chans.size >= o


def test_narrow_plan_at_conv1_1():
    """VGG conv1_1, 16 frames of 640^2 -> 64 on 132 SMs: 25,600 tiles with
    no pixel padded, two blocks per SM, the busiest block within one tile of
    the mean; the halo reads 1.33x the input."""
    plan = narrow_plan(16, 640, 640, 3, 64, H100_SMS)
    assert plan.tiles == 16 * 80 * 20 and plan.n_tiles == 1
    assert plan.grid == 2 * H100_SMS
    assert len(plan.block_tiles(0)) - plan.tiles / plan.grid < 1
    halo = (NARROW_ROWS + 2) * NARROW_HC
    assert halo / (NARROW_ROWS * NARROW_COLS) < 1.6
    assert NarrowPlan(2, 9, 40, 3, 8, 3).tile(1) == (0, 0, 32)
    assert NarrowPlan(2, 9, 40, 3, 8, 3).tile(4) == (1, 0, 0)


def narrow_k_offsets(c):
    """The kernel's per-block offset table: for each K column k of the
    padded K (16 per k16 step), the halo offset (in values) of A[p][k] from
    pixel p's own offset, tap k // c = 3 dy + dx, channel k % c; a padded
    column (k >= 9 c) points at the first value past the halo, the start of
    the zeroed tail."""
    ks = -(-9 * c // 16)
    halo = (NARROW_ROWS + 2) * NARROW_HC * c
    offs = []
    for k in range(16 * ks):
        tap = k // c
        offs.append(((tap // 3) * NARROW_HC + tap % 3) * c + k % c
                    if k < 9 * c else halo)
    return np.asarray(offs)


def _emulate_narrow(x, w, b, plan):
    """The narrow kernel's order of work in numpy (fp32): for each channel
    tile and tile, the 10 x 34 x C halo staged flat as the kernel's threads
    load it (value e: halo row e // (34 C), pixel x0 - 1 + (e % (34 C)) // C,
    zero outside the image), followed by the zeroed tail; A[p][k] read at
    pixel p's offset + the offset table; B the [9C, O] weights' rows and
    channels n0 .. n0 + N - 1, zero past K and past O; + bias.  Only pixels
    and channels inside the output are stored, each once; the output
    starts as NaN."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    koff = narrow_k_offsets(c)
    kp = koff.size
    halo = (NARROW_ROWS + 2) * NARROW_HC * c
    tail = ((NARROW_ROWS - 1) * NARROW_HC + NARROW_COLS) * c
    wk = np.zeros((kp, plan.n_tiles * plan.n), np.float32)
    wk[:9 * c, :o] = w.reshape(9 * c, o)
    bk = np.zeros(plan.n_tiles * plan.n, np.float32)
    bk[:o] = b
    pix = np.arange(NARROW_ROWS * NARROW_COLS)
    pbase = ((pix // NARROW_COLS) * NARROW_HC + pix % NARROW_COLS) * c
    y = np.full((bsz, h, wd, o), np.nan, np.float32)
    for ny in range(plan.n_tiles):
        n0 = ny * plan.n
        for bx in range(plan.grid):
            for t in plan.block_tiles(bx):
                bi, y0, x0 = plan.tile(t)
                buf = np.zeros(halo + tail, np.float32)
                e = np.arange(halo)
                r, q = e // (NARROW_HC * c), e % (NARROW_HC * c)
                yy, xx = y0 - 1 + r, x0 - 1 + q // c
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < wd)
                buf[e[ok]] = x[bi, yy[ok], xx[ok], q[ok] % c]
                a = buf[pbase[:, None] + koff[None, :]]
                acc = a @ wk[:, n0:n0 + plan.n] + bk[n0:n0 + plan.n]
                out = acc.reshape(NARROW_ROWS, NARROW_COLS, plan.n)
                nh, nw = min(NARROW_ROWS, h - y0), min(NARROW_COLS, wd - x0)
                nc = min(plan.n, o - n0)
                blk = y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc]
                assert np.isnan(blk).all()
                y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc] = out[:nh, :nw, :nc]
    return y


def _narrow_case(c, o, shape, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("c", [1, 3, 4, 7])
@pytest.mark.parametrize("o", [3, 5, 64, 128])
def test_narrow_tile_walk_matches_plain(c, o):
    """Ragged last band and strip (H = 11, W = 45), B = 2, and a grid of 3
    blocks per channel tile; O = 128 takes two channel tiles."""
    x, w, b = _narrow_case(c, o, (2, 11, 45))
    plan = narrow_plan(2, 11, 45, c, o, H100_SMS)
    plan = NarrowPlan(plan.batch, plan.height, plan.width, o, plan.n, grid=3)
    got = _emulate_narrow(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


def test_narrow_offsets_pad_k_with_the_zero_tail():
    """Each real K column reads its own (dy, dx, c) once; the padded columns
    (C = 3: 27 -> 32) all read the zeroed tail, which every pixel's offset
    keeps inside the buffer."""
    for c in range(1, 8):
        koff = narrow_k_offsets(c)
        halo = (NARROW_ROWS + 2) * NARROW_HC * c
        tail = ((NARROW_ROWS - 1) * NARROW_HC + NARROW_COLS) * c
        assert koff.size % 16 == 0 and koff.size - 9 * c < 16
        assert len(set(koff[:9 * c])) == 9 * c and koff[:9 * c].max() < halo
        assert (koff[9 * c:] == halo).all()
        last = ((NARROW_ROWS - 1) * NARROW_HC + NARROW_COLS - 1) * c
        assert last + koff.max() < halo + tail
        assert last + koff[:9 * c].max() == halo - 1


def test_narrow_nonfinite_inputs_stay_in_their_field():
    """inf and NaN on a tile's edge columns (31 | 32) and rows (7 | 8), at
    the image's edges and in a halo's corner: the emulation's non-finite
    outputs are exactly the plain conv's (the padded K columns read true
    zeros, so no inf meets a padded weight), and the finite ones agree."""
    c, o = 3, 64
    x, w, b = _narrow_case(c, o, (2, 19, 70), seed=3)
    for idx, v in [((0, 3, 31, 2), np.inf), ((0, 3, 32, 0), -np.inf),
                   ((0, 7, 10, 1), np.nan), ((0, 8, 40, 2), np.inf),
                   ((1, 0, 69, 2), np.inf), ((1, 18, 0, 0), -np.inf),
                   ((1, 15, 63, 1), np.inf), ((1, 16, 64, 2), np.nan)]:
        x[idx] = v
    plan = narrow_plan(2, 19, 70, c, o, H100_SMS)
    with np.errstate(invalid="ignore"):  # inf - inf and inf x 0 are NaN
        got = _emulate_narrow(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    assert not fin.all()
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    scale = conv3x3_implicit_gemm_plain(
        torch.from_numpy(np.abs(xz)), torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(b))).numpy()
    assert (np.abs(got[fin] - want[fin])
            <= 9 * c * 2.0 ** -22 * scale[fin]).all()


# ---------------------------------------------------------------------------
# The sliced design (other C >= 8: 8, 32, 96, 100, 160, 200, ...)
# ---------------------------------------------------------------------------

#: The two shapes the sliced design was built for: C = 32 at conv2_x scale,
#: and the decoder's filter `up` conv at relu4_1 scale.
SLICED_TARGETS = [((16, 320, 320, 32), 64), ((16, 80, 80, 32), 512)]


def test_slice_width():
    """KS = 16 up to C = 16 (one slice), else 32; the padded K per tap
    (slices x KS) covers C with less than one slice to spare."""
    assert {c: slice_width(c) for c in (8, 16, 24, 32, 40, 96, 100, 160,
                                        200)} == {
        8: 16, 16: 16, 24: 32, 32: 32, 40: 32, 96: 32, 100: 32, 160: 32,
        200: 32}
    for c in range(8, 600):
        if design(c, torch.float16, SLICED_MAX_O) != "sliced":
            continue
        ks = slice_width(c)
        padded = -(-c // ks) * ks
        assert 0 <= padded - c < ks


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 37, 130])
@pytest.mark.parametrize("width", [1, 7, 37, 130, 640])
def test_sliced_plan_covers_every_output_once(batch, height, width):
    """Every output pixel x channel belongs to exactly one tile, the blocks
    take every tile once, the grid never exceeds the tiles or the SMs, and
    the tile is 256 pixels, one TMA box of rows + 2 halo'd rows x cols."""
    for c, o in [(8, 5), (32, 64), (100, 192), (200, 512), (24, 24)]:
        for sms in (H100_SMS, 7):
            plan = sliced_plan(batch, height, width, c, o, sms)
            assert isinstance(plan, SlicedPlan)
            assert plan.cols in SLICED_COLS and plan.m == 256
            assert plan.rows * plan.cols == 256 and plan.rows + 2 <= 256
            assert plan.n == (out_tile(o) if o <= 64 else 128)
            assert plan.ks == slice_width(c) and plan.slices * plan.ks >= c
            assert 1 <= plan.grid <= min(plan.tiles, sms)
            taken = np.sort(np.concatenate(
                [np.asarray(plan.block_tiles(bx)) for bx in range(plan.grid)]))
            assert (taken == np.arange(plan.tiles)).all()
            cover = np.zeros((plan.n_tiles, batch, height, width), np.int32)
            for t in range(plan.tiles):
                b, y0, x0, n0 = plan.tile(t)
                assert 0 <= b < batch and 0 <= y0 < height \
                    and 0 <= x0 < width and 0 <= n0 < o
                cover[n0 // plan.n, b, y0:y0 + plan.rows,
                      x0:x0 + plan.cols] += 1
            assert (cover == 1).all(), (c, o, sms)
            assert plan.n_tiles * plan.n >= o > (plan.n_tiles - 1) * plan.n


def test_sliced_plan_at_the_target_shapes():
    """Both target shapes tile with no pixel padded, in the tallest tiles
    (16 x 16: each input row staged 18 / 16 times per dx), 32-channel
    slices, N = 64 and 128, on all 132 SMs; so does the filter blocks'
    `down` conv (512 -> 32), which takes the sliced design in 16 slices
    at N = 32 (400 tiles) where it took the wide one; the other designs
    keep their plans, and the design list names the sliced and split-TF32
    designs in place of the cp.async and CUDA-core ones."""
    for (b, h, w, c), o in SLICED_TARGETS:
        plan = sliced_plan(b, h, w, c, o, H100_SMS)
        assert (plan.cols, plan.rows, plan.ks, plan.slices) == (16, 16, 32, 1)
        assert plan.strips * plan.cols == w and plan.bands * plan.rows == h
        assert plan.n == (64 if o == 64 else 128)
        assert plan.grid == H100_SMS
    assert "sliced" in DESIGNS and "igemm" not in DESIGNS
    assert "tf32x3" in DESIGNS and "fp32" not in DESIGNS
    down = sliced_plan(16, 80, 80, 512, 32, H100_SMS)  # the filter `down`
    assert (down.cols, down.rows, down.ks, down.slices) == (16, 16, 32, 16)
    assert (down.n, down.tiles, down.grid) == (32, 400, H100_SMS)
    assert wide_plan(16, 80, 80, 32, H100_SMS).n == 32  # its former plan
    with pytest.raises(ValueError):
        sliced_plan(1, 8, 8, 64, 64, H100_SMS)
    with pytest.raises(ValueError):
        sliced_plan(1, 8, 8, 512, SLICED_MAX_O + 1, H100_SMS)


def _emulate_sliced(x, w, b, plan):
    """The sliced kernel's order of work in numpy (fp32), with the
    wrapper's copies (where C % 8 != 0, x and w zero-padded to C8 = C
    rounded up to KS input channels; w to ld = O rounded up to 8 output
    channels): for each tile,
    stages k = slice 3 + dx; stage k's A is the TMA box of channels KS
    slice .. + KS - 1 at rows y0 - 1 .. y0 + rows, columns x0 + dx - 1 ..
    (zero outside the image and past C8), flattened to [(rows + 2) cols px]
    [KS ch]; tap dy reads its rows dy cols .. + 255 against the weights'
    box of tap 3 dy + dx, rows KS slice .., channels n0 .. n0 + N - 1 (zero
    past C8 and past ld).  The sums start from the bias; the output starts
    as NaN and each pixel and channel inside it is stored once."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    c8 = c if c % 8 == 0 else -(-c // plan.ks) * plan.ks
    ld = -(-o // 8) * 8
    xp = np.zeros((bsz, h, wd, c8), np.float32)
    xp[..., :c] = x
    wk = np.zeros((9, c8, ld), np.float32)
    wk[:, :c, :o] = w.reshape(9, c, o)
    bk = np.zeros(plan.n_tiles * plan.n, np.float32)
    bk[:o] = b
    y = np.full((bsz, h, wd, o), np.nan, np.float32)
    rows, cols, ks = plan.rows, plan.cols, plan.ks
    for bx in range(plan.grid):
        for t in plan.block_tiles(bx):
            bi, y0, x0, n0 = plan.tile(t)
            acc = np.tile(bk[n0:n0 + plan.n], (plan.m, 1))
            for k in range(3 * plan.slices):
                sl, dx = divmod(k, 3)
                cs = sl * ks
                box = np.zeros((rows + 2, cols, ks), np.float32)
                ys, xs = y0 - 1, x0 + dx - 1
                ylo, yhi = max(ys, 0), min(ys + rows + 2, h)
                xlo, xhi = max(xs, 0), min(xs + cols, wd)
                chi = min(cs + ks, c8)
                if ylo < yhi and xlo < xhi:
                    box[ylo - ys:yhi - ys, xlo - xs:xhi - xs, :chi - cs] = \
                        xp[bi, ylo:yhi, xlo:xhi, cs:chi]
                flat = box.reshape((rows + 2) * cols, ks)
                for dy in range(3):
                    bt = np.zeros((ks, plan.n), np.float32)
                    nhi = min(n0 + plan.n, ld)
                    bt[:chi - cs, :nhi - n0] = wk[3 * dy + dx, cs:chi, n0:nhi]
                    acc += flat[dy * cols:dy * cols + plan.m] @ bt
            out = acc.reshape(rows, cols, plan.n)
            nh, nw, nc = min(rows, h - y0), min(cols, wd - x0), \
                min(plan.n, o - n0)
            assert np.isnan(y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc]).all()
            y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc] = out[:nh, :nw, :nc]
    return y


def _sliced_case(c, o, shape, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("c", [8, 24, 32, 40, 96, 100, 200])
@pytest.mark.parametrize("o", [5, 32, 64, 192, 512])
def test_sliced_k_loop_matches_plain(c, o):
    """Ragged last band and strip (H = 19, W = 21: 16 x 16 tiles), B = 2, a
    grid of 3 blocks; C = 8, 24, 40, 100 and 200 leave a zero-filled slice
    tail (100 also a zero-padded copy), O = 192 and 512 take two and four
    channel tiles."""
    x, w, b = _sliced_case(c, o, (2, 19, 21))
    plan = sliced_plan(2, 19, 21, c, o, H100_SMS)
    plan = dataclasses.replace(plan, grid=3)
    got = _emulate_sliced(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("o", [3, 32, 64])
def test_sliced_k_loop_wide_c_narrow_o(c, o):
    """C % 64 = 0 with O <= 64, the route moved off the wide kernel: C =
    128 and 512 in 4 and 16 slices of 32 channels, O = 3 (scalar stores, a
    padded weight copy), 32 and 64; ragged band and strip, B = 2, a grid of
    3 blocks."""
    x, w, b = _sliced_case(c, o, (2, 19, 21), seed=7)
    plan = sliced_plan(2, 19, 21, c, o, H100_SMS)
    assert plan.slices == c // 32 and plan.n == out_tile(o)
    got = _emulate_sliced(x, w, b, dataclasses.replace(plan, grid=3))
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


@pytest.mark.parametrize("c", [16, 96])
@pytest.mark.parametrize("cols", SLICED_COLS)
def test_sliced_k_loop_every_tile_width(c, cols):
    """The same walk at each tile width the kernel takes (rows = 256 /
    cols), C = 96 in three 32-channel slices and C = 16 in one of 16, O =
    24."""
    x, w, b = _sliced_case(c, 24, (1, 11, 150), seed=5)
    plan = sliced_plan(1, 11, 150, c, 24, H100_SMS)
    plan = dataclasses.replace(plan, cols=cols, grid=2)
    got = _emulate_sliced(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


def test_sliced_nonfinite_inputs_stay_in_their_field():
    """inf and NaN inside, on both sides of a tile's edge columns (15 | 16)
    and rows (15 | 16), at the image's edges and in the last real channel
    (C = 100: the padded channels and the slice's zero-filled tail follow
    it): the emulation's non-finite outputs are exactly the plain conv's
    (both sides of every padded K column are true zeros, so no inf meets a
    padded weight), and the finite ones agree."""
    c, o = 100, 24
    x, w, b = _sliced_case(c, o, (2, 19, 40), seed=6)
    for idx, v in [((0, 3, 5, 7), np.inf), ((0, 10, 15, 1), -np.inf),
                   ((0, 10, 16, c - 1), np.nan), ((0, 15, 30, 4), np.inf),
                   ((0, 16, 31, c - 1), np.inf), ((1, 0, 39, 0), np.nan),
                   ((1, 18, 0, c - 1), -np.inf)]:
        x[idx] = v
    plan = sliced_plan(2, 19, 40, c, o, H100_SMS)
    with np.errstate(invalid="ignore"):  # inf - inf and inf x 0 are NaN
        got = _emulate_sliced(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    assert not fin.all()
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    scale = conv3x3_implicit_gemm_plain(
        torch.from_numpy(np.abs(xz)), torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(b))).numpy()
    assert (np.abs(got[fin] - want[fin])
            <= 9 * c * 2.0 ** -22 * scale[fin]).all()


def tma_swizzle(off, span):
    """TMA's swizzle of `span` bytes (32, 64 or 128; 16: none) on a byte
    offset from a 1024-byte-aligned base: bits 4 .. of the offset XORed
    with bits 7 .. (one bit at 32 bytes, two at 64, three at 128)."""
    if span == 16:
        return off
    return off ^ (((off >> 7) & (span // 16 - 1)) << 4)


@pytest.mark.parametrize("ks", [16, 32])
@pytest.mark.parametrize("cols", SLICED_COLS)
def test_wgmma_reads_sliced_a_where_tma_lands_it(ks, cols):
    """For each tap dy, warpgroup, m64 block, k16 step and element of the
    64 x 16 A operand, the address wgmma reads through the K-major
    descriptor (csrc/conv3x3.cu wgmma_desc<KS 2>: rows of S = KS 2 bytes,
    8-row groups 8 S apart, + 32 bytes a k16 step) is where TMA landed the
    box's pixel dy cols + 128 wg + 64 m + row, channel 16 step + k; every
    operand starts on a whole 8-row group of the pattern; the box's
    elements land on distinct addresses."""
    span = 2 * ks
    rows = 256 // cols
    sbo = 8 * span

    def tma_a(q, ch):  # box pixel q (row-major over rows + 2 x cols)
        return tma_swizzle(q * span + 2 * ch, span)

    for dy in range(3):
        for wg in range(2):
            for mb in range(2):
                start = (dy * cols + 128 * wg + 64 * mb) * span
                assert start % sbo == 0
                for step in range(ks // 16):
                    for i in range(64):
                        for kk in range(16):
                            lin = (start + 32 * step + (i // 8) * sbo
                                   + (i % 8) * span + 2 * kk)
                            q = dy * cols + 128 * wg + 64 * mb + i
                            assert tma_swizzle(lin, span) == \
                                tma_a(q, 16 * step + kk)
    offs = {tma_a(q, ch) for q in range((rows + 2) * cols) for ch in range(ks)}
    assert len(offs) == (rows + 2) * cols * ks
    assert max(offs) < (rows + 2) * cols * span


@pytest.mark.parametrize("ks", [16, 32])
@pytest.mark.parametrize("n", [8, 16, 32, 64, 128])
def test_wgmma_reads_sliced_b_where_tma_lands_it(ks, n):
    """A stage's weights: for tap dy, TMA boxes {64 o, KS c} of the [9][C]
    [ld] map land chunk j of tap dy at (dy chunks + j) KS 128 bytes, row k
    of a box 128 bytes on, with the 128-byte swizzle.  wgmma reads element
    (k, n) of a k16 step's 16 x N operand through the MN-major descriptor
    (leading offset KS 128 bytes between 64-column chunks, stride 1024
    between 8-row groups, + 2048 a k16 step) at that same address."""
    chunks = max(1, n // 64)
    lbo = ks * 128

    def tma_b(dy, k, col):
        j, cc = divmod(col, 64)
        return ((dy * chunks + j) * lbo
                + tma_swizzle(k * 128 + 2 * cc, 128))

    for dy in range(3):
        base = dy * chunks * lbo
        for step in range(ks // 16):
            for kk in range(16):
                for col in range(n):
                    lin = (base + step * 2048 + (col // 64) * lbo
                           + (kk // 8) * 1024 + (kk % 8) * 128
                           + (col % 64) * 2)
                    # the boxes start on 1024-byte boundaries
                    assert (base + (col // 64) * lbo) % 1024 == 0
                    assert base + tma_swizzle(lin - base, 128) == \
                        tma_b(dy, 16 * step + kk, col)


def sliced_out_offset(cw, p, ch):
    """csrc/conv3x3.cu sliced_out_offset: where a consumer thread writes
    (pixel p, channel ch) of a staged output box of cw channels."""
    lin = (p * cw + ch) * 2
    return lin if cw == 8 else lin ^ (((lin >> 7) & (cw * 2 // 16 - 1)) << 4)


@pytest.mark.parametrize("cw", [8, 16, 32, 64])
def test_sliced_output_box_is_tmas_and_free_of_bank_conflicts(cw):
    """The staging box's layout is the one the TMA store reads (a box {cw,
    px, ...} of y swizzled by cw 2 bytes), its 64 x cw values land on
    distinct addresses inside it, and each store instruction of a warp
    (lane l: accumulator row 16 warp + l / 4 (+ 8), columns 8 j + 2 (l %
    4), + 1) hits 32 distinct banks."""
    offs = set()
    for p in range(64):
        for ch in range(cw):
            off = sliced_out_offset(cw, p, ch)
            assert off == tma_swizzle((p * cw + ch) * 2, 2 * cw)
            offs.add(off)
    assert len(offs) == 64 * cw and max(offs) < 64 * cw * 2
    for warp in range(4):
        for j in range(cw // 8):
            for half in (0, 8):
                banks = {(sliced_out_offset(cw, 16 * warp + lane // 4 + half,
                                            8 * j + 2 * (lane % 4)) // 4)
                         % 32 for lane in range(32)}
                assert len(banks) == 32


# ---------------------------------------------------------------------------
# The split-TF32 design (fp32, every C and O)
# ---------------------------------------------------------------------------

MASK = np.uint32(0xFFFFE000)
FLT_MAX = np.finfo(np.float32).max


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _floats(u):
    return np.asarray(u, np.uint32).view(np.float32)


def tf32_rna(v):
    """csrc/conv3x3.cu tf32_rna on fp32 bits (|v| < 0x7f7ff000): TF32
    rounded to nearest, ties away from zero."""
    return (np.asarray(v, np.uint32) + np.uint32(0x1000)) & MASK


def tf32_lo(v):
    """csrc/conv3x3.cu tf32_lo: the input's lo beside hi = v truncated to
    TF32 (the tensor cores' reading of the box)."""
    v = np.asarray(v, np.uint32)
    hi = v & MASK
    with np.errstate(invalid="ignore"):
        r = _bits(_floats(v) - _floats(hi))
    return np.where(hi == v, np.uint32(0), r & MASK)


def tf32_split_w(w):
    """csrc/conv3x3.cu tf32_split_w: (hi, lo) of fp32 weights, as floats."""
    v = _bits(w)
    a = v & np.uint32(0x7FFFFFFF)
    hi = _floats(np.where(a > 0x7F800000, np.uint32(0x7FFFE000), v & MASK))
    with np.errstate(invalid="ignore", over="ignore"):
        lo = np.where(a >= 0x7F800000, np.uint32(0),
                      tf32_rna(_bits(np.asarray(w, np.float32) - hi)))
    tiny = _bits(hi * np.float32(2.0 ** -30))
    lo = np.where((lo == 0) & (a != 0) & (a < 0x7F800000), tiny, lo)
    return hi, _floats(lo)


def tf32_round_w(w):
    """csrc/conv3x3.cu tf32_round_w: a weight's one-pass TF32 value, rna
    (truncated where that would overflow, and for NaN), as floats."""
    v = _bits(w)
    a = v & np.uint32(0x7FFFFFFF)
    return _floats(np.where(a >= 0x7F7FF000, v & MASK, tf32_rna(v)))


def tf32_round_x(x):
    """csrc/conv3x3.cu tf32_round_x: an input's one-pass TF32 value, rna
    (truncated where that would overflow, inf kept, NaN as 0x7fffe000), as
    floats."""
    v = _bits(x)
    a = v & np.uint32(0x7FFFFFFF)
    return _floats(np.where(a > 0x7F800000, np.uint32(0x7FFFE000),
                            np.where(a >= 0x7F7FF000, v & MASK,
                                     tf32_rna(v))))


def _rna_reference(v):
    """fp32 values rounded to 11 significant bits, ties away from zero,
    by arithmetic in float64 (normal values)."""
    m, e = np.frexp(np.asarray(v, np.float64))
    return (np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
            * 2.0 ** (e - 11)).astype(np.float32)


def test_tf32_split_bits():
    """rna on the bit pattern is round-to-nearest-ties-away to 11
    significant bits (ties built on purpose); hi + lo of an input holds it
    to 2^-20 with lo of its sign; the weights' lo never has hi's opposite
    sign and is 0 only for w = 0; inf and NaN stay what they are, lo of
    +-inf is 0, +-FLT_MAX splits into finite halves."""
    rng = np.random.default_rng(8)
    v = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
         ).astype(np.float32)
    ties = _floats((_bits(v) & MASK) | np.uint32(0x1000))
    for vals in (v, ties):
        assert (_floats(tf32_rna(_bits(vals))) == _rna_reference(vals)).all()
    hi, lo = _floats(_bits(v) & MASK), _floats(tf32_lo(_bits(v)))
    assert ((_bits(hi) | _bits(lo)) & ~MASK == 0).all()
    assert (np.abs(v.astype(np.float64) - hi - lo)
            <= 2.0 ** -20 * np.abs(v)).all()
    assert ((lo == 0) | (np.sign(lo) == np.sign(v))).all()
    whi, wlo = tf32_split_w(v)
    assert ((wlo != 0) & (np.sign(wlo) == np.sign(whi))).all()
    assert (np.abs(v.astype(np.float64) - whi - wlo)
            <= 2.0 ** -21 * np.abs(v)).all()
    assert (tf32_split_w(np.zeros(1, np.float32))[1] == 0).all()
    special = np.array([np.inf, -np.inf, np.nan, FLT_MAX, -FLT_MAX],
                       np.float32)
    lo = _floats(tf32_lo(_bits(special)))
    assert (lo[:3] == 0).all()
    assert np.isfinite(lo[3:]).all() and (lo[3:] != 0).all()
    assert np.isnan(_floats(_bits(special[2:3]) & MASK)).all()
    big = special[3:].astype(np.float64)
    assert (np.abs(_floats(_bits(special[3:]) & MASK).astype(np.float64)
                   + lo[3:] - big) <= 2.0 ** -20 * np.abs(big)).all()
    exotic = np.array([0x7F800001], np.uint32)  # NaN, payload below TF32's
    assert np.isnan(_floats(tf32_lo(exotic))).all()
    whi, wlo = tf32_split_w(special)
    assert np.isnan(whi[2]) and (wlo[:3] == 0).all()
    assert np.isfinite(whi[3:]).all()


def test_tf32_split_infinite_input_meets_each_weight_as_fp32():
    """x = +-inf against a weight exact in TF32 (0.5: lo would be 0), an
    inexact one, its negation and 0: the three passes give inf of x w's
    sign, NaN for w = 0, as one fp32 product does (never inf - inf)."""
    w = np.array([0.5, 0.1, -0.1, -3.0, 0.0], np.float32)
    whi, wlo = tf32_split_w(w)
    for x in (np.inf, -np.inf):
        xb = _bits(np.float32(x))
        xhi, xlo = _floats(xb & MASK), _floats(tf32_lo(xb))
        with np.errstate(invalid="ignore"):
            got = xhi * whi + xhi * wlo + xlo * whi
            want = np.float32(x) * w
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert (got[~np.isnan(want)] == want[~np.isnan(want)]).all()


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 37, 130])
@pytest.mark.parametrize("width", [1, 7, 130, 640])
def test_tf32x3_plan_covers_every_output_once(batch, height, width):
    """Every output pixel x channel belongs to exactly one 256-pixel tile,
    the blocks take every (tile, K split) unit once, N = 64 (O > 32 in
    tiles of 64; O <= 32 is the rows design's, which the plan refuses) and
    the K slice is 8 fp32 channels up to C = 8, else 16."""
    with pytest.raises(ValueError):
        tf32x3_plan(batch, height, width, 64, TF32_ROWS_MAX_O, H100_SMS)
    for c, o in [(3, 64), (8, 40), (64, 64), (100, 192), (64, 33), (7, 512)]:
        for sms in (H100_SMS, 7):
            plan = tf32x3_plan(batch, height, width, c, o, sms)
            assert plan.cols in SLICED_COLS and plan.m == 256
            assert plan.n == out_tile(o) == 64
            assert plan.ks == tf32_slice_width(c)
            assert plan.ks == (8 if c <= 8 else 16)
            assert 1 <= plan.grid <= min(plan.units, sms)
            taken = np.sort(np.concatenate(
                [np.asarray(plan.block_units(bx)) for bx in range(plan.grid)]))
            assert (taken == np.arange(plan.units)).all()
            cover = np.zeros((plan.n_tiles, batch, height, width), np.int32)
            for t in range(plan.tiles):
                b, y0, x0, n0 = plan.tile(t)
                cover[n0 // plan.n, b, y0:y0 + plan.rows,
                      x0:x0 + plan.cols] += 1
            assert (cover == 1).all(), (c, o, sms)
            assert plan.n_tiles * plan.n >= o > (plan.n_tiles - 1) * plan.n


def test_tf32x3_plan_at_row_3j():
    """[16,640,640,64] -> 64: 16 x 16 tiles, no pixel padded, N = 64, four
    16-channel slices (12 stages a tile), 25600 tiles on all 132 SMs."""
    plan = tf32x3_plan(16, 640, 640, 64, 64, H100_SMS)
    assert (plan.cols, plan.rows, plan.n, plan.ks, plan.slices) == \
        (16, 16, 64, 16, 4)
    assert plan.tiles == 25600 and plan.grid == H100_SMS


def _wg_view(box, p0, p1):
    """What a consumer warpgroup's taps may read of a landed box (pixels x
    channels) at one pass: pixels [p0, p1) rounded in place by the
    warpgroup itself (tf32_round_x), the rest NaN."""
    view = np.full_like(box, np.nan)
    view[p0:p1] = tf32_round_x(box[p0:p1])
    return view


def _split_sum(partials, t, splits):
    """Tile t's sums: its splits' fp32 partials added in split order (csrc/
    conv3x3.cu split_sum; one split: its partial as it is)."""
    total = partials[t, 0]
    for sp in range(1, splits):
        total = total + partials[t, sp]
    return total


def _emulate_tf32x3(x, w, b, plan):
    """The split-TF32 kernel's order of work in numpy: x zero-padded to Cp
    = C rounded up to 4; the split kernel's ws[p][tap][o][c] (p = 0: hi, 1:
    lo; zero past C); for each tile, stages k = slice 3 + dx, whose box
    (channels KS slice .., zero outside the image and past Cp) is x_hi as
    the tensor cores read it (truncated to TF32) beside its lo box; tap dy
    adds x_hi B_hi to the sums, which start from the bias, and x_hi B_lo +
    x_lo B_hi to the corrections, which start from 0, B_p = ws[p][3 dy +
    dx] rows n0 .. n0 + N - 1 (zero past O), columns of the slice; the two
    are added once a tile, and each output inside y is stored once."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    cp = -(-c // 4) * 4
    xp = np.zeros((bsz, h, wd, cp), np.float32)
    xp[..., :c] = x
    whi, wlo = tf32_split_w(w.reshape(9, c, o))
    ws = np.zeros((2, 9, o, cp), np.float32)
    ws[0, :, :, :c] = whi.transpose(0, 2, 1)
    ws[1, :, :, :c] = wlo.transpose(0, 2, 1)
    bk = np.zeros(plan.n_tiles * plan.n, np.float32)
    bk[:o] = b
    y = np.full((bsz, h, wd, o), np.nan, np.float32)
    rows, cols, ks, n = plan.rows, plan.cols, plan.ks, plan.n
    partials = {}
    for bx in range(plan.grid):
        for u in plan.block_units(bx):
            t, sp = plan.unit(u)
            bi, y0, x0, n0 = plan.tile(t)
            acc = np.tile(bk[n0:n0 + n] * (sp == 0), (plan.m, 1))
            cor = np.zeros_like(acc)
            run = plan.split_slices(sp)
            for k in range(3 * run.start, 3 * run.stop):
                sl, dx = divmod(k, 3)
                cs = sl * ks
                box = np.zeros((rows + 2, cols, ks), np.float32)
                ys, xs = y0 - 1, x0 + dx - 1
                ylo, yhi = max(ys, 0), min(ys + rows + 2, h)
                xlo, xhi = max(xs, 0), min(xs + cols, wd)
                chi = min(cs + ks, cp)
                if ylo < yhi and xlo < xhi:
                    box[ylo - ys:yhi - ys, xlo - xs:xhi - xs, :chi - cs] = \
                        xp[bi, ylo:yhi, xlo:xhi, cs:chi]
                bits = _bits(box.reshape((rows + 2) * cols, ks))
                ahi, alo = _floats(bits & MASK), _floats(tf32_lo(bits))
                for dy in range(3):
                    bt = np.zeros((2, ks, n), np.float32)
                    nhi = min(n0 + n, o)
                    bt[:, :chi - cs, :nhi - n0] = \
                        ws[:, 3 * dy + dx, n0:nhi, cs:chi].transpose(0, 2, 1)
                    rr = slice(dy * cols, dy * cols + plan.m)
                    acc += ahi[rr] @ bt[0]
                    cor += ahi[rr] @ bt[1]
                    cor += alo[rr] @ bt[0]
            partials[t, sp] = acc + cor
    for t in range(plan.tiles):
        bi, y0, x0, n0 = plan.tile(t)
        out = _split_sum(partials, t, plan.splits).reshape(rows, cols, n)
        nh, nw, nc = min(rows, h - y0), min(cols, wd - x0), min(n, o - n0)
        assert np.isnan(y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc]).all()
        y[bi, y0:y0 + nh, x0:x0 + nw, n0:n0 + nc] = out[:nh, :nw, :nc]
    return y


@pytest.mark.parametrize("c,o", [(3, 64), (7, 5), (8, 16), (64, 64),
                                 (64, 3), (100, 192), (13, 72), (7, 37),
                                 (64, 33)])
def test_tf32x3_k_loop_matches_plain(c, o):
    """Three passes on the route the wrapper takes (O > 32 the split-TF32
    walk, O <= 32 the rows design).  Ragged band and strip (H = 19, W =
    21), B = 2, a grid of 3 blocks: C = 3, 7 and 13 in a padded copy (Cp
    = 4, 8, 16), 8 in one 8-channel slice, 64 and 100 in 16-channel slices
    (100: a zero-filled tail); O = 3, 5, 33 and 37 (scalar stores), 16,
    64, 72 and 192 (two and three channel tiles).  Within 9C 2^-22
    sum|x||w| (+|b|) of the plain fp32 conv."""
    x, w, b = _sliced_case(c, o, (2, 19, 21), seed=9)
    plan = dataclasses.replace(_fp32_plan(2, 19, 21, c, o, H100_SMS, 3),
                               grid=3)
    assert isinstance(plan, RowsPlan) == (o <= TF32_ROWS_MAX_O)
    got = _emulate_fp32(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 9 * c * 2.0 ** -22 * scale).all()


def _fp32_plan(batch, height, width, c, o, sms, passes):
    """The plan of the design the wrapper takes for an fp32 call at
    `passes`: the rows design's at O <= 32, else the split-TF32 (three
    passes) or the one-pass design's (one)."""
    if o <= TF32_ROWS_MAX_O:
        return tf32_rows_plan(batch, height, width, c, o, sms, passes)
    plan_of = tf32x3_plan if passes == 3 else tf32x1_plan
    return plan_of(batch, height, width, c, o, sms)


def _emulate_fp32(x, w, b, plan):
    """The fp32 kernel the wrapper's plan names: the rows design (a
    RowsPlan), the one-pass design (a Tf32x1Plan) or the split-TF32
    kernel."""
    if isinstance(plan, RowsPlan):
        return _emulate_rows(x, w, b, plan)
    if isinstance(plan, Tf32x1Plan):
        return _emulate_tf32x1(x, w, b, plan)
    return _emulate_tf32x3(x, w, b, plan)


@pytest.mark.parametrize("c,o", [(3, 64), (8, 16), (64, 64), (100, 192)])
def test_tf32x1_k_loop_matches_plain(c, o):
    """One TF32 pass (the 'default' precision), on the route the wrapper
    takes (O = 64 and 192: the one-pass design; O = 16: the rows design):
    within (2^-10 + 2^-22 + 9C 2^-22) sum|x||w| (+|b|) of the plain fp32
    conv, x and w rounded to nearest TF32 (each <= 2^-11 of it); and
    farther from it than three passes on the route they take."""
    x, w, b = _sliced_case(c, o, (2, 19, 21), seed=12)
    plan = dataclasses.replace(_fp32_plan(2, 19, 21, c, o, H100_SMS, 1),
                               grid=3)
    assert isinstance(plan, Tf32x1Plan) == (o > TF32_ROWS_MAX_O)
    one = _emulate_fp32(x, w, b, plan)
    three = _emulate_fp32(x, w, b, dataclasses.replace(
        _fp32_plan(2, 19, 21, c, o, H100_SMS, 3), grid=3))
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert np.isfinite(one).all()
    assert (np.abs(one - want) <= (2.0 ** -10 + (9 * c + 1) * 2.0 ** -22)
            * scale).all()
    assert np.abs(one - want).max() > np.abs(three - want).max()


# The one-pass design (fp32, one TF32 pass, O > TF32_ROWS_MAX_O).

#: A consumer warpgroup's 128 threads: warp, lane; its accumulator row
#: (output channel within an m64 block) and first pixel column of each 8.
_WARP, _LANE = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(32),
                                               indexing="ij"))
_OROW = 16 * _WARP + _LANE // 4
_PCOL = 2 * (_LANE % 4)


def _x_box(xp, bi, y0, x0, dx, rows, cols, cs, ks):
    """The landed box {ks, cols, rows + 2} of x (zero-padded to Cp) at
    channel cs, column x0 + dx - 1, row y0 - 1: zero outside the image and
    past Cp, as pixels x channels."""
    _, h, wd, cp = xp.shape
    box = np.zeros((rows + 2, cols, ks), np.float32)
    ys, xs = y0 - 1, x0 + dx - 1
    ylo, yhi = max(ys, 0), min(ys + rows + 2, h)
    xlo, xhi = max(xs, 0), min(xs + cols, wd)
    chi = min(cs + ks, cp)
    if ylo < yhi and xlo < xhi:
        box[ylo - ys:yhi - ys, xlo - xs:xhi - xs, :chi - cs] = \
            xp[bi, ylo:yhi, xlo:xhi, cs:chi]
    return box.reshape((rows + 2) * cols, ks)


def _emulate_tf32x1(x, w, b, plan):
    """The one-pass design's order of work in numpy: ws[tap][o][Cp], the
    weights rounded to TF32 (zero past C); for each tile, stages k = slice
    3 + dx, the landed box of x zero outside the image and past Cp; each
    warpgroup wg rounds box pixels [NPX wg, NPX wg + NPX + 2 cols) and
    reads the rest as NaN (_wg_view); tap dy adds A B^T to its sums
    [64 MB channels][NPX pixels], which start from the bias: A the weights
    ws[3 dy + dx] rows n0 + 64 m .. (zero past O), B the NPX box pixels
    from NPX wg + dy cols.  The epilogue: each thread's accumulators
    (block m, row orow + 8 h, pixel 8 j + pcol + e) go, kCPX = 32 / MB
    pixels at a time, into output box (64 m + orow + 8 h) / 32 of 32
    channels at x1_out_offset(8 jj + pcol + e, channel % 32), each slot
    written once; then TMA stores each box {32, bc, kCPX / bc} at (n0 + 32
    box, x0 + q0 % cols, y0 + q0 / cols) (bc = min(cols, kCPX), q0 the
    chunk's first tile pixel), dropping what falls past the image or O:
    each output stored once."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    cp = -(-c // 4) * 4
    xp = np.zeros((bsz, h, wd, cp), np.float32)
    xp[..., :c] = x
    ws = np.zeros((9, o, cp), np.float32)
    ws[:, :, :c] = tf32_round_w(w.reshape(9, c, o)).transpose(0, 2, 1)
    mb, npx, rows, cols, ks, n = plan.mb, plan.npx, plan.rows, plan.cols, \
        plan.ks, plan.n
    assert n == 64 * mb and plan.m == 2 * npx == rows * cols
    cpx = 32 // mb
    bc = min(cols, cpx)
    bk = np.zeros(plan.n_tiles * n, np.float32)
    bk[:o] = b
    y = np.zeros((bsz, h, wd, o), np.float32)
    stored = np.zeros(y.shape, np.int32)
    partials = {}
    for bx in range(plan.grid):
        for u in plan.block_units(bx):
            t, sp = plan.unit(u)
            bi, y0, x0, n0 = plan.tile(t)
            d = [np.repeat(bk[n0:n0 + n, None] * (sp == 0), npx, 1)
                 for _ in range(2)]
            run = plan.split_slices(sp)
            for k in range(3 * run.start, 3 * run.stop):
                sl, dx = divmod(k, 3)
                cs = sl * ks
                box = _x_box(xp, bi, y0, x0, dx, rows, cols, cs, ks)
                a = np.zeros((3, n, ks), np.float32)
                nhi, chi = min(n0 + n, o), min(cs + ks, cp)
                for dy in range(3):
                    a[dy, :nhi - n0, :chi - cs] = \
                        ws[3 * dy + dx, n0:nhi, cs:chi]
                for wg in range(2):
                    view = _wg_view(box, npx * wg, npx * (wg + 1) + 2 * cols)
                    for dy in range(3):
                        p0 = npx * wg + dy * cols
                        d[wg] += a[dy] @ view[p0:p0 + npx].T
            partials[t, sp] = np.stack(d)
    for t in range(plan.tiles):
        bi, y0, x0, n0 = plan.tile(t)
        d = _split_sum(partials, t, plan.splits)
        for wg in range(2):
            for ch in range(npx // cpx):
                boxes = np.zeros((2 * mb, cpx * 32), np.float32)
                filled = np.zeros(boxes.shape, np.int32)
                for jj in range(cpx // 8):
                    j = ch * (cpx // 8) + jj
                    for m in range(mb):
                        for hh in range(2):
                            for e in range(2):
                                oc = 64 * m + _OROW + 8 * hh
                                slot = (oc // 32, x1_out_offset(
                                    8 * jj + _PCOL + e, oc % 32) // 4)
                                filled[slot] += 1
                                boxes[slot] = d[wg][oc, 8 * j + _PCOL + e]
                assert (filled == 1).all()
                q0 = npx * wg + cpx * ch
                bxi, r, cc, n32 = np.meshgrid(
                    np.arange(2 * mb), np.arange(cpx // bc),
                    np.arange(bc), np.arange(32), indexing="ij")
                yy = y0 + q0 // cols + r
                xx = x0 + q0 % cols + cc
                oo = n0 + 32 * bxi + n32
                ok = (yy < h) & (xx < wd) & (oo < o)
                dst = (bi, yy[ok], xx[ok], oo[ok])
                np.add.at(stored, dst, 1)
                y[dst] = boxes[bxi[ok], x1_out_offset(
                    (r * bc + cc)[ok], n32[ok]) // 4]
    assert (stored == 1).all()
    return y


def test_tf32x1_design_by_shape():
    """One pass: the one-pass design where O > 32, the rows design (N = O
    rounded up to 8, 16 or 32) at O <= 32, at every C; three passes the
    split-TF32 kernel where O > 32."""
    assert TF32_ROWS_MAX_O == 32
    assert "tf32x1" in DESIGNS and "tf32_rows" in DESIGNS
    for c in (1, 3, 8, 13, 64, 512):
        for o in (1, 3, 8, 32):
            assert design(c, torch.float32, o, 1) == "tf32_rows"
        for o in (33, 64, 65, 192, 512):
            assert design(c, torch.float32, o, 1) == "tf32x1"
            assert design(c, torch.float32, o, 3) == "tf32x3"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 32, 37, 130])
@pytest.mark.parametrize("width", [1, 7, 32, 130, 640])
def test_tf32x1_plan_covers_every_output_once(batch, height, width):
    """The one-pass plan at O = 3, 32, 64, 192 and 512: every output pixel
    x channel belongs to exactly one tile, the blocks take every (tile, K
    split) unit once; O > 32 takes tiles of 2 NPX pixels (rows x cols) x 64 MB
    channels of TF32X1_SHAPES (MB = 2 only where O > 64), each within the
    block's shared memory with at least two stages; O <= 32 (the rows
    design's) is refused."""
    for c, o in [(3, 64), (64, 3), (64, 32), (13, 192), (200, 512),
                 (64, 64)]:
        for sms in (H100_SMS, 7):
            if o <= TF32_ROWS_MAX_O:
                with pytest.raises(ValueError):
                    tf32x1_plan(batch, height, width, c, o, sms)
                continue
            plan = tf32x1_plan(batch, height, width, c, o, sms)
            assert isinstance(plan, Tf32x1Plan)
            assert (plan.mb, plan.npx) in TF32X1_SHAPES
            assert plan.mb == 1 or o > 64
            assert plan.n == 64 * plan.mb and plan.m == 2 * plan.npx
            assert plan.rows * plan.cols == plan.m
            assert plan.cols in SLICED_COLS
            assert plan.ks == tf32_slice_width(c)
            stages, nbytes = plan.smem()
            assert stages >= 2 and nbytes <= 232448
            assert 1 <= plan.grid <= min(plan.units, sms)
            taken = np.sort(np.concatenate(
                [np.asarray(plan.block_units(bx)) for bx in range(plan.grid)]))
            assert (taken == np.arange(plan.units)).all()
            cover = np.zeros((plan.n_tiles, batch, height, width), np.int32)
            for t in range(plan.tiles):
                b, y0, x0, n0 = plan.tile(t)
                cover[n0 // plan.n, b, y0:y0 + plan.rows,
                      x0:x0 + plan.cols] += 1
            assert (cover == 1).all(), (c, o, sms)
            assert plan.n_tiles * plan.n >= o > (plan.n_tiles - 1) * plan.n


def test_tf32x1_plan_at_row_3k():
    """[16,640,640,64] -> 64 (PERF.md row 3k): 512-pixel tiles of 32 x 16
    (no pixel padded), each warpgroup 256 pixels x 64 channels (one
    m64n256k8 a tap and k8 step), four 16-channel slices, 12800 tiles on
    all 132 SMs; four stages in 222528 bytes of the 232448; the reckoned
    stage 1.24 times its products' clocks, the old orientation's 1.69."""
    plan = tf32x1_plan(16, 640, 640, 64, 64, H100_SMS)
    assert (plan.mb, plan.npx, plan.cols, plan.rows, plan.n, plan.ks,
            plan.slices) == (1, 256, 16, 32, 64, 16, 4)
    assert plan.tiles == 12800 and plan.grid == H100_SMS
    assert plan.smem() == (4, 222528)
    clocks, nbytes = tf32x1_stage_reckoning(1, 256, 16, 16)
    assert clocks == 1536 and round(nbytes / 128 / clocks, 2) == 1.24
    # The old orientation: 24 m64n64k8 (4 KB each, 32 clocks), TMA's 30
    # KB and the whole box read and written once.
    old = 24 * 4096 + (18 * 16 * 64 + 3 * 64 * 64) + 2 * 18 * 16 * 64
    assert round(old / 128 / 768, 2) == 1.69


def test_tf32x1_plan_picks_by_reckoned_clocks():
    """O > 64 takes two m64n128 blocks a warpgroup at the Pass-2 batch's
    widths, O = 64 one m64n256; the train step's 32^2 images take 256-pixel
    tiles of 64 channels (as many blocks as the old orientation: 128 at
    [4,32,32,256] -> 512), never fewer tiles than SMs where more exist."""
    want = {((16, 320, 320, 128), 128): (2, 128),
            ((16, 80, 80, 256), 512): (2, 128),
            ((16, 80, 80, 32), 512): (2, 128),
            ((16, 640, 640, 3), 64): (1, 256),
            ((4, 256, 256, 64), 64): (1, 256),
            ((4, 32, 32, 256), 512): (1, 128),
            ((4, 32, 32, 32), 512): (1, 128)}
    for (shape, o), shp in want.items():
        plan = tf32x1_plan(*shape, o, H100_SMS)
        assert (plan.mb, plan.npx) == shp, (shape, o)
    assert tf32x1_plan(4, 32, 32, 256, 512, H100_SMS).tiles == 128 == \
        tf32x3_plan(4, 32, 32, 256, 512, H100_SMS).tiles


@pytest.mark.parametrize("npx,cols", [(npx, cols) for npx in (128, 256)
                                      for cols in SLICED_COLS])
def test_tf32x1_rounded_rows_cover_the_taps(npx, cols):
    """Each warpgroup rounds box pixels [NPX wg, NPX wg + NPX + 2 cols):
    every pixel its three taps' B operands read (NPX pixels from NPX wg +
    dy cols, whole 8-row swizzle groups), all inside the box of (rows + 2)
    cols pixels; the two warpgroups' ranges cover the box.  The split-TF32
    kernel's one-pass instance rounds the whole box, both warpgroups
    behind one barrier."""
    rows = 2 * npx // cols
    box = (rows + 2) * cols
    done = np.zeros(box, np.int32)
    for wg in range(2):
        r0, r1 = npx * wg, npx * (wg + 1) + 2 * cols
        assert 0 <= r0 < r1 <= box
        done[r0:r1] += 1
        for dy in range(3):
            start = npx * wg + dy * cols
            assert start % 8 == 0
            assert r0 <= start and start + npx <= r1
    assert (done >= 1).all()


def x1_out_offset(p, n):
    """csrc/conv3x3.cu x1_out_offset: byte offset of (pixel p, channel n)
    in an output box of 32 fp32 channels a pixel, 128-byte rows with TMA's
    128-byte swizzle."""
    p, n = np.asarray(p), np.asarray(n)
    return p * 128 + ((((n >> 2) ^ p) & 7) << 4) + ((n & 3) << 2)


def test_tf32x1_output_box_is_tmas_and_free_of_bank_conflicts():
    """The output box layout is TMA's 128-byte swizzle of [pixel][32
    channels] (tma_swizzle of the row-major offset); every 16-byte chunk
    holds four consecutive channels of one pixel; and a warp's accumulator
    writes (channel 16 warp + lane / 4 + 8 h of a box, pixel 8 jj + 2 (lane
    % 4) + e) fall in 32 banks for every register."""
    p, n = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    off = x1_out_offset(p, n)
    assert (off == tma_swizzle(p * 128 + n * 4, 128)).all()
    assert sorted(off.ravel()) == list(range(0, 32 * 128, 4))
    lanes = np.arange(32)
    for warp in range(4):
        for hh in range(2):
            for jj in range(4):
                for e in range(2):
                    slot = x1_out_offset(8 * jj + 2 * (lanes % 4) + e,
                                         (16 * warp + lanes // 4 + 8 * hh)
                                         % 32) // 4
                    assert len(set(slot % 32)) == 32


@pytest.mark.parametrize("c,o,shape", [
    (3, 64, (2, 19, 21)), (13, 72, (2, 19, 21)), (64, 64, (1, 32, 32)),
    (64, 192, (2, 19, 21)), (32, 512, (1, 32, 32)), (64, 3, (2, 19, 21)),
    (64, 32, (1, 32, 32)), (100, 65, (1, 9, 40))])
def test_tf32x1_walk_matches_plain(c, o, shape):
    """Both one-pass routes at the wrapper's plan and at every tile shape
    of TF32X1_SHAPES the width allows, 32^2 images among them, a grid of 3
    blocks: C = 3 and 13 in a padded copy, 100 with a zero-filled tail;
    O = 3 and 32 (the rows design), 64, 65 and 72 (scalar stores,
    a half-empty block), 192 and 512.  Within (2^-10 + (9C + 1) 2^-22)
    sum|x||w| (+|b|) of the plain fp32 conv, each output stored once."""
    x, w, b = _sliced_case(c, o, shape, seed=15)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    bar = (2.0 ** -10 + (9 * c + 1) * 2.0 ** -22) * scale
    base = _fp32_plan(*shape, c, o, H100_SMS, 1)
    plans = [dataclasses.replace(base, grid=3)]
    if isinstance(base, Tf32x1Plan):
        for mb, npx in TF32X1_SHAPES:
            if mb == 1 or o > 64:
                plans.append(dataclasses.replace(
                    base, mb=mb, npx=npx, n=64 * mb, grid=3,
                    cols=min(SLICED_COLS[1], 2 * npx)))
    for plan in plans:
        got = _emulate_fp32(x, w, b, plan)
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= bar).all(), plan


def test_tf32x1_nonfinite_and_huge_inputs():
    """inf, -inf, NaN and +-FLT_MAX inside, on both sides of a tile's edge
    columns and of the warpgroups' halves, at the image's edges and in the
    last channel (C = 13: a padded copy), O = 72 (a half-empty block): the
    one-pass emulation's NaN and inf outputs are exactly the plain conv's,
    of the same sign, and the finite ones agree within the one-pass bar."""
    c, o = 13, 72
    x, w, b = _sliced_case(c, o, (2, 19, 40), seed=16)
    for idx, v in [((0, 3, 5, 7), np.inf), ((0, 10, 15, 1), -np.inf),
                   ((0, 10, 16, c - 1), np.nan), ((0, 15, 30, 4), np.inf),
                   ((0, 16, 31, 2), -np.inf), ((1, 0, 39, 0), np.nan),
                   ((1, 18, 0, c - 1), -np.inf), ((0, 5, 25, 2), FLT_MAX),
                   ((1, 9, 12, c - 1), -FLT_MAX)]:
        x[idx] = v
    plan = tf32x1_plan(2, 19, 40, c, o, H100_SMS)
    assert isinstance(plan, Tf32x1Plan)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_tf32x1(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    assert (np.sign(got[np.isinf(want)]) == np.sign(want[np.isinf(want)])).all()
    fin = np.isfinite(want)
    assert not fin.all() and np.abs(want[fin]).max() > 1e36
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    scale = conv3x3_implicit_gemm_plain(
        torch.from_numpy(np.abs(xz)), torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(b))).numpy()
    assert (np.abs(got[fin] - want[fin])
            <= (2.0 ** -10 + (9 * c + 1) * 2.0 ** -22) * scale[fin]).all()


def test_tf32x1_matches_the_pallas_kernel():
    """The one-pass emulation against rerevst_tpu's conv3x3_implicit_gemm
    in interpret mode (fp32) at one small shape, within the one-pass bar."""
    import jax.numpy as jnp

    from rerevst_tpu.kernels import conv3x3 as jconv

    x, w, b = _sliced_case(24, 80, (2, 8, 24), seed=17)
    plan = tf32x1_plan(2, 8, 24, 24, 80, H100_SMS)
    assert isinstance(plan, Tf32x1Plan)
    got = _emulate_tf32x1(x, w, b, plan)
    want = np.asarray(jconv.conv3x3_implicit_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_h=8,
        interpret=True))
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert (np.abs(got - want)
            <= (2.0 ** -10 + (9 * 24 + 1) * 2.0 ** -22) * scale).all()


def test_tf32_round_w_bits():
    """The one-pass weights: rna to 11 significant bits (ties away),
    within 2^-11 of |w|, truncated near FLT_MAX (no overflow to inf), NaN
    and inf kept."""
    rng = np.random.default_rng(13)
    v = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
         ).astype(np.float32)
    r = tf32_round_w(v)
    assert (r == _rna_reference(v)).all()
    assert (np.abs(r.astype(np.float64) - v) <= 2.0 ** -11 * np.abs(v)).all()
    special = tf32_round_w(np.array([np.inf, -np.inf, np.nan, FLT_MAX,
                                     -FLT_MAX], np.float32))
    assert np.isinf(special[:2]).all() and np.isnan(special[2])
    assert np.isfinite(special[3:]).all()


def test_tf32_round_x_bits():
    """The one-pass inputs, rounded in the box: rna to 11 significant bits
    (ties away), within 2^-11 of |x|, truncated near FLT_MAX, inf kept,
    every NaN (a payload in the low 13 bits too) kept a NaN."""
    rng = np.random.default_rng(14)
    v = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
         ).astype(np.float32)
    r = tf32_round_x(v)
    assert (r == _rna_reference(v)).all()
    assert (np.abs(r.astype(np.float64) - v) <= 2.0 ** -11 * np.abs(v)).all()
    nans = _floats(np.array([0x7F800001, 0xFF801000, 0x7FC00000],
                            np.uint32))
    special = tf32_round_x(np.concatenate([np.array(
        [np.inf, -np.inf, FLT_MAX, -FLT_MAX], np.float32), nans]))
    assert np.isinf(special[:2]).all() and np.isfinite(special[2:4]).all()
    assert np.isnan(special[4:]).all()


def test_tf32x3_matches_the_pallas_kernel():
    """The emulation against rerevst_tpu's conv3x3_implicit_gemm in
    interpret mode (fp32) at one small shape, within the same bar."""
    import jax.numpy as jnp

    from rerevst_tpu.kernels import conv3x3 as jconv

    x, w, b = _sliced_case(24, 40, (2, 8, 24), seed=10)
    plan = tf32x3_plan(2, 8, 24, 24, 40, H100_SMS)
    got = _emulate_tf32x3(x, w, b, plan)
    want = np.asarray(jconv.conv3x3_implicit_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_h=8,
        interpret=True))
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert (np.abs(got - want) <= 9 * 24 * 2.0 ** -22 * scale).all()


def test_tf32x3_nonfinite_and_huge_inputs():
    """inf, -inf, NaN and +-FLT_MAX inside, on both sides of a tile's edge
    columns (15 | 16) and rows, at the image's edges and in the last
    channel (C = 13: a padded copy), O = 40: the emulation's NaN and inf
    outputs are exactly the plain conv's, and the finite ones agree
    (FLT_MAX's outputs too: its split does not overflow)."""
    c, o = 13, 40
    x, w, b = _sliced_case(c, o, (2, 19, 40), seed=11)
    for idx, v in [((0, 3, 5, 7), np.inf), ((0, 10, 15, 1), -np.inf),
                   ((0, 10, 16, c - 1), np.nan), ((0, 15, 30, 4), np.inf),
                   ((1, 0, 39, 0), np.nan), ((1, 18, 0, c - 1), -np.inf),
                   ((0, 5, 25, 2), FLT_MAX), ((1, 9, 12, c - 1), -FLT_MAX)]:
        x[idx] = v
    plan = tf32x3_plan(2, 19, 40, c, o, H100_SMS)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_tf32x3(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    assert (np.sign(got[np.isinf(want)]) == np.sign(want[np.isinf(want)])).all()
    fin = np.isfinite(want)
    assert not fin.all() and np.abs(want[fin]).max() > 1e36
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    scale = conv3x3_implicit_gemm_plain(
        torch.from_numpy(np.abs(xz)), torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(b))).numpy()
    assert (np.abs(got[fin] - want[fin])
            <= 9 * c * 2.0 ** -22 * scale[fin]).all()


# Split K over blocks (both fp32 kernels, csrc/conv3x3.cu split_sum).

#: The plans of a 640^2 fp32 batch's conv shapes with O > 32 (rows 3j, 3k
#: and the other Pass-2 shapes) before K could be split: (x shape, O) ->
#: (cols, n, ks, grid, tiles) of the three-pass plan, and of the one-pass
#: plan, with (mb, npx).
BATCH_PLANS = {
    ((16, 640, 640, 64), 64): ((16, 64, 16, 132, 25600),
                               (16, 64, 16, 132, 12800, 1, 256)),
    ((16, 640, 640, 3), 64): ((16, 64, 8, 132, 25600),
                              (16, 64, 8, 132, 12800, 1, 256)),
    ((16, 320, 320, 64), 128): ((16, 64, 16, 132, 12800),
                                (16, 128, 16, 132, 6400, 2, 128)),
    ((16, 320, 320, 128), 128): ((16, 64, 16, 132, 12800),
                                 (16, 128, 16, 132, 6400, 2, 128)),
    ((16, 160, 160, 128), 256): ((16, 64, 16, 132, 6400),
                                 (16, 128, 16, 132, 3200, 2, 128)),
    ((16, 160, 160, 256), 256): ((16, 64, 16, 132, 6400),
                                 (16, 128, 16, 132, 3200, 2, 128)),
    ((16, 80, 80, 256), 512): ((16, 64, 16, 132, 3200),
                               (16, 128, 16, 132, 1600, 2, 128)),
    ((16, 80, 80, 32), 512): ((16, 64, 16, 132, 3200),
                              (16, 128, 16, 132, 1600, 2, 128)),
}


def _plan_key(plan):
    key = (plan.cols, plan.n, plan.ks, plan.grid, plan.tiles)
    return key + ((plan.mb, plan.npx) if isinstance(plan, Tf32x1Plan)
                  else ())


def test_split_plans_keep_the_640_batch_plans():
    """Every conv shape of a 640^2 fp32 batch has tiles enough for every
    SM: one split and no workspace at three and at one pass, and where O >
    32 the plan it had before (O <= 32, the `out` and `down` convs: the
    rows design's plans)."""
    for (shape, o), (three, one) in BATCH_PLANS.items():
        for plan, want in ((tf32x3_plan(*shape, o, H100_SMS), three),
                           (tf32x1_plan(*shape, o, H100_SMS), one)):
            assert plan.tiles >= H100_SMS
            assert _plan_key(plan) == want, (shape, o)
            assert plan.splits == 1 and plan.workspace_bytes == 0
            assert plan.units == plan.tiles
    for shape, o in (((16, 640, 640, 64), 3), ((16, 80, 80, 512), 32)):
        for passes in (3, 1):
            plan = tf32_rows_plan(*shape, o, H100_SMS, passes)
            assert plan.tiles >= H100_SMS
            assert plan.splits == 1 and plan.workspace_bytes == 0
            assert plan.units == plan.tiles


def test_split_plans_at_the_train_step_32x32():
    """[4,32,32,512] -> 32 (the decoder filter blocks' `up` conv's input
    gradient, 72 launches a step) on the rows design: 16 tiles of 256
    pixels at three passes and 8 of 512 at one, each split 8 ways, units
    of 4 slices (4 stages), one block a unit; at one pass [4,32,32,512] ->
    256 splits too (more than 32 tiles for 132 SMs); the step's shapes
    whose tiles fill the SMs keep one split."""
    assert design(512, torch.float32, 32, 1) == "tf32_rows"
    for passes, tiles in ((3, 16), (1, 8)):
        plan = tf32_rows_plan(4, 32, 32, 512, 32, H100_SMS, passes)
        assert (plan.tiles, plan.splits, plan.units, plan.grid) == \
            (tiles, 8, 8 * tiles, 8 * tiles)
        assert plan.m * tiles == 4 * 32 * 32
        assert {len(plan.split_slices(s)) for s in range(8)} == {4}
        assert plan.workspace_bytes == tiles * (8 * plan.m * 32 + 2) * 4
    wide = tf32x1_plan(4, 32, 32, 512, 256, H100_SMS)
    assert wide.splits > 1 and wide.tiles < H100_SMS
    assert wide.units <= H100_SMS and wide.grid == wide.units
    assert tf32x3_plan(4, 32, 32, 512, 256, H100_SMS).splits > 1
    for shape, o in [((4, 256, 256, 64), 64), ((4, 128, 128, 64), 128),
                     ((4, 64, 64, 256), 256), ((4, 32, 32, 256), 512),
                     ((4, 32, 32, 32), 512)]:
        for plan in (tf32x3_plan(*shape, o, H100_SMS),
                     tf32x1_plan(*shape, o, H100_SMS)):
            assert plan.splits == 1, (shape, o)


@pytest.mark.parametrize("sms", [4, 7, H100_SMS])
def test_split_runs_cover_every_stage_once(sms):
    """At the plan's splits and at forced ones (2, 3, one a slice): the
    blocks take every (tile, split) unit once, a tile's units are
    consecutive (split fastest), and its splits' runs of slices, each
    staged at dx = 0, 1, 2 (the rows design, O <= 32: at once), cover
    every (slice, dx) stage once, in order; where the plan splits, every
    split has MIN_SPLIT_SLICES slices or more and the tiles are fewer than
    the SMs."""
    for shape, c, o in [((1, 8, 8), 64, 8), ((2, 19, 21), 200, 96),
                        ((4, 32, 32), 512, 32), ((1, 9, 40), 100, 65)]:
        for passes in (3, 1):
            base = _fp32_plan(*shape, c, o, sms, passes)
            if base.splits > 1:
                assert base.tiles < sms
                assert min(len(base.split_slices(s))
                           for s in range(base.splits)) >= MIN_SPLIT_SLICES
            for plan in [base] + [with_splits(base, s, sms)
                                  for s in (2, 3, base.slices)]:
                assert 1 <= plan.splits <= plan.slices
                assert plan.grid == min(plan.units, sms)
                taken = sorted(u for bx in range(plan.grid)
                               for u in plan.block_units(bx))
                assert taken == list(range(plan.units))
                assert [plan.unit(u) for u in range(plan.units)] == \
                    [(t, s) for t in range(plan.tiles)
                     for s in range(plan.splits)]
                stages = [(sl, dx) for s in range(plan.splits)
                          for sl in plan.split_slices(s) for dx in range(3)]
                assert stages == [(sl, dx) for sl in range(plan.slices)
                                  for dx in range(3)]
                assert plan.workspace_bytes == (
                    0 if plan.splits == 1 else
                    plan.tiles * (plan.splits * plan.m * plan.n + 2) * 4)


def _split_case(o, passes, seed):
    """[1,8,8,64] -> o at `passes`: x, w, b, the plan on a card of 4 SMs
    (one split: 4 slices are under two splits of MIN_SPLIT_SLICES), the
    emulation of the walk the plan names and the plain conv's bar."""
    x, w, b = _sliced_case(64, o, (1, 8, 8), seed=seed)
    plan = _fp32_plan(1, 8, 8, 64, o, 4, passes)
    bar = 9 * 64 * 2.0 ** -22 if passes == 3 \
        else 2.0 ** -10 + (9 * 64 + 1) * 2.0 ** -22
    assert plan.splits == 1 and plan.slices == 4
    return x, w, b, plan, _emulate_fp32, bar


@pytest.mark.parametrize("o", [8, 96])
@pytest.mark.parametrize("passes", [3, 1])
def test_split_walk_matches_plain(o, passes):
    """The kernels' walk with each tile's K split 2 and 4 ways (forced;
    the rows design at O = 8, at O = 96 the one-pass design at one pass and
    the split-TF32 walk at three): the
    splits' fp32 partials, split 0's from the bias, summed in split order,
    are within the unsplit walk's bar of the plain fp32 conv: 9C 2^-22
    sum|x||w| (+|b|) at three passes, (2^-10 + (9C + 1) 2^-22) at one."""
    x, w, b, plan, emulate, bar = _split_case(o, passes, seed=21)
    assert isinstance(plan, Tf32x1Plan) == (passes == 1 and o > 32)
    assert isinstance(plan, RowsPlan) == (o <= 32)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    for splits in (2, 4):
        got = emulate(x, w, b, with_splits(plan, splits, 4))
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= bar * scale).all(), splits


@pytest.mark.parametrize("passes", [3, 1])
def test_split_walk_matches_the_pallas_kernel(passes):
    """The walk split 4 ways (one slice a split) against rerevst_tpu's
    conv3x3_implicit_gemm in interpret mode (fp32), [1,8,8,64] -> 96,
    within the pass count's bar."""
    import jax.numpy as jnp

    from rerevst_tpu.kernels import conv3x3 as jconv

    x, w, b, plan, emulate, bar = _split_case(96, passes, seed=22)
    got = emulate(x, w, b, with_splits(plan, 4, 4))
    want = np.asarray(jconv.conv3x3_implicit_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_h=8,
        interpret=True))
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert (np.abs(got - want) <= bar * scale).all()


@pytest.mark.parametrize("variant", ["a_from_registers", "no_split",
                                     "loads_only", "no_a_load", "no_b_load",
                                     "no_store", "x1_no_round",
                                     "x1_loads_only", "x1_no_store",
                                     "x1_lockstep", "x1_no_fence",
                                     "x1_wait2"])
def test_tf32_probe_edits_match_the_kernel_source(variant):
    """scripts/probe_tf32_conv.py builds each variant by editing the text
    of csrc/conv3x3.cu (the split-TF32 kernel's, and, ``x1_*``, the
    one-pass design's): every edit must find its text there exactly once,
    or the probe's build refuses it.  (Its PARENT_VARIANTS edit the parent
    tree's source that ``--small-o --parent`` names, and the build checks
    them there.)"""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "probe_tf32_conv", root / "scripts" / "probe_tf32_conv.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "rerevst_torch" / "csrc" / "conv3x3.cu").read_text()
    assert set(probe.VARIANTS) == {"a_from_registers", "no_split",
                                   "loads_only", "no_a_load", "no_b_load",
                                   "no_store", "x1_no_round",
                                   "x1_loads_only", "x1_no_store",
                                   "x1_lockstep", "x1_no_fence",
                                   "x1_wait2"}
    for old, new in probe.VARIANTS[variant]:
        assert src.count(old) == 1
        src = src.replace(old, new)


# ---------------------------------------------------------------------------
# The rows design (fp32, O <= 32, both pass counts; csrc/conv3x3_rows.cu)
# ---------------------------------------------------------------------------

#: A consumer warpgroup's 128 threads: warp, lane; gq, t of the wgmma
#: fragment layouts; and rho, the thread's first fragment row (an
#: accumulator block's row: pixels rho and rho + 8 of the block).
_RW, _RL = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(32),
                                           indexing="ij"))
_RGQ, _RT = _RL // 4, _RL % 4
_RHO = 16 * _RW + _RGQ


def rows_offset(q, t, ks):
    """csrc/conv3x3_rows.cu rows_offset: the byte offset of lane t's
    channels of box pixel q (16 bytes at KS = 16, 8 at KS = 8)."""
    q, t = np.asarray(q), np.asarray(t)
    span = 4 * ks
    sw = (q * span >> 7) & (span // 16 - 1)
    if ks == 16:
        return q * span + ((t ^ sw) << 4)
    return q * span + (((t >> 1) ^ sw) << 4) + ((t & 1) << 3)


def _rows_landing(box, ks):
    """The box of x (pixels x ks channels) as TMA lands it in shared memory
    with the 4 ks-byte swizzle, as fp32 words by byte offset / 4."""
    flat = box.reshape(-1)
    words = np.empty_like(flat)
    logical = np.arange(flat.size) * 4
    words[tma_swizzle(logical, 4 * ks) // 4] = flat
    return words


def _rows_weights(w, ks, passes):
    """csrc/conv3x3_rows.cu conv3x3_rows_split_kernel: ws[plane][tap][o][p],
    Cs = C rounded up to ks positions a slice-ordered row, position p
    holding channel p - p % ks + rows_channel(p % ks, ks) (zero past C);
    planes hi and lo (three passes) or the value rounded to TF32."""
    c, o = w.shape[2], w.shape[3]
    cs = -(-c // ks) * ks
    p = np.arange(cs)
    ch = p - p % ks + np.array([rows_channel(int(v), ks) for v in p % ks])
    wf = np.zeros((9, cs, o), np.float32)
    inside = ch < c
    wf[:, inside] = w.reshape(9, c, o)[:, ch[inside]]
    if passes == 1:
        planes = [tf32_round_w(wf)]
    else:
        planes = list(tf32_split_w(wf))
    ws = np.stack([pl.transpose(0, 2, 1) for pl in planes])
    ws[:, :, :, ~inside] = 0
    return ws  # [plane][tap][o][Cs]


def _emulate_rows(x, w, b, plan):
    """The rows kernel's order of work in numpy, thread by thread where
    the index math is: x zero-padded to Cp = C rounded up to 4; the split
    kernel's planes (_rows_weights); for each (tile, K split) unit, a
    stage a slice: the box of x {KS, cols + 2, rows + 2} at (slice, x0 - 1,
    y0 - 1), zero outside the image and past Cp, landed with TMA's swizzle
    (_rows_landing); each warpgroup wg and phase t = 0 .. R + 1 and dx,
    each thread loads its KS / 4 channels of box pixels q and q + 8, q =
    (wg hr + t + R (rho // cols)) (cols + 2) + rho % cols + dx, from the
    landed words at rows_offset (checked against the box itself); the
    fragment of k8 step k gives rows rho, rho + 8 at K index t the loaded
    channels 2 k, and at K index t + 4 channel 2 k + 1 (wgmma's register-A
    layout); one pass rounds them (tf32_round_x), three split them (hi
    truncated, tf32_lo); each tap (dy, dx) with block j = t - dy in 0 ..
    R - 1 adds A B to block j's sums (from the bias, split 0) and at three
    passes A_hi B_lo + A_lo B_hi to its corrections, B[K][n] the stage's
    plane row n (zero past O) at position 8 k + K of tap 3 dy + dx.  The
    epilogue: thread (rho, t), block j, h stores channels 8 jj + 2 t, + 1
    of tile row wg hr + j + R (rho // cols), column rho % cols + 8 h, where
    inside the image and O; each output stored once."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    cp = -(-c // 4) * 4
    xp = np.zeros((bsz, h, wd, cp), np.float32)
    xp[..., :c] = x
    ks, n, cols, r, passes = plan.ks, plan.n, plan.cols, plan.phases, \
        plan.passes
    hr, rows = 64 * r // cols, plan.rows
    assert rows == 2 * hr and plan.m == rows * cols == 128 * r
    ws = _rows_weights(w, ks, passes)
    cs = ws.shape[-1]
    assert plan.slices == cs // ks
    bk = np.zeros(n, np.float32)
    bk[:o] = b
    rs = cols + 2
    seg, col = _RHO // cols, _RHO % cols
    assert (col + 8 < cols).all() and (_RHO % 16 < 8).all()
    y = np.zeros((bsz, h, wd, o), np.float32)
    stored = np.zeros(y.shape, np.int32)
    partials = {}
    for bx in range(plan.grid):
        for u in plan.block_units(bx):
            t_, sp = plan.unit(u)
            bi, y0, x0, n0 = plan.tile(t_)
            assert n0 == 0
            acc = np.tile(bk * (sp == 0), (2, r, 64, 1))
            cor = np.zeros_like(acc)
            for sl in plan.split_slices(sp):
                c0 = sl * ks
                box = np.zeros((rows + 2, rs, ks), np.float32)
                ys, xs = y0 - 1, x0 - 1
                ylo, yhi = max(ys, 0), min(ys + rows + 2, h)
                xlo, xhi = max(xs, 0), min(xs + rs, wd)
                chi = min(c0 + ks, cp)
                if ylo < yhi and xlo < xhi and chi > c0:
                    box[ylo - ys:yhi - ys, xlo - xs:xhi - xs, :chi - c0] = \
                        xp[bi, ylo:yhi, xlo:xhi, c0:chi]
                words = _rows_landing(box, ks)
                flat = box.reshape(-1, ks)
                bw = np.zeros((ws.shape[0], 9, n, ks), np.float32)
                bw[:, :, :min(n, o)] = ws[:, :, :min(n, o), c0:c0 + ks]
                for wg in range(2):
                    q0 = (wg * hr + seg * r) * rs + col
                    for ph in range(r + 2):
                        for dx in range(3):
                            q = q0 + ph * rs + dx
                            u = []
                            for qq in (q, q + 8):
                                off = rows_offset(qq, _RT, ks) // 4
                                got = words[off[:, None]
                                            + np.arange(ks // 4)]
                                want = flat[qq[:, None], (ks // 4) * _RT[:, None]
                                            + np.arange(ks // 4)]
                                assert np.array_equal(got, want, equal_nan=True)
                                u.append(got)
                            for k in range(ks // 8):
                                a = np.zeros((64, 8), np.float32)
                                filled = np.zeros((64, 8), np.int32)
                                for rr, uu in ((_RHO, u[0]), (_RHO + 8, u[1])):
                                    a[rr, _RT] = uu[:, 2 * k]
                                    a[rr, _RT + 4] = uu[:, 2 * k + 1]
                                    filled[rr, _RT] += 1
                                    filled[rr, _RT + 4] += 1
                                assert (filled == 1).all()
                                bits = _bits(a)
                                if passes == 1:
                                    ahi, alo = tf32_round_x(a), None
                                else:
                                    ahi = _floats(bits & MASK)
                                    alo = _floats(tf32_lo(bits))
                                for dy in range(3):
                                    j = ph - dy
                                    if not 0 <= j < r:
                                        continue
                                    tap = 3 * dy + dx
                                    bhi = bw[0, tap, :, 8 * k:8 * k + 8].T
                                    acc[wg, j] += ahi @ bhi
                                    if passes == 3:
                                        blo = bw[1, tap, :, 8 * k:8 * k + 8].T
                                        cor[wg, j] += ahi @ blo + alo @ bhi
            partials[t_, sp] = acc + cor
    for t_ in range(plan.tiles):
        bi, y0, x0, _ = plan.tile(t_)
        s = _split_sum(partials, t_, plan.splits)
        for wg in range(2):
            for j in range(r):
                for hh in range(2):
                    yy = y0 + wg * hr + j + r * seg
                    xx = x0 + col + 8 * hh
                    for jj in range(n // 8):
                        for e in range(2):
                            oo = 8 * jj + 2 * _RT + e
                            ok = (yy < h) & (xx < wd) & (oo < o)
                            dst = (bi, yy[ok], xx[ok], oo[ok])
                            np.add.at(stored, dst, 1)
                            y[dst] = s[wg, j][(_RHO + 8 * hh)[ok], oo[ok]]
    assert (stored == 1).all()
    return y


def _rows_bar(c, passes):
    """The pass count's bar on sum|x||w| (+|b|): 9C 2^-22 at three passes,
    2^-10 + (9C + 1) 2^-22 at one (x and w each rounded within 2^-11)."""
    return 9 * c * 2.0 ** -22 if passes == 3 \
        else 2.0 ** -10 + (9 * c + 1) * 2.0 ** -22


def _rows_pallas(x, w, b):
    """rerevst_tpu's conv3x3_implicit_gemm in interpret mode (fp32), in
    row tiles of 8 where H allows, else one tile."""
    import jax.numpy as jnp

    from rerevst_tpu.kernels import conv3x3 as jconv

    h = x.shape[1]
    return np.asarray(jconv.conv3x3_implicit_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        tile_h=8 if h % 8 == 0 else h, interpret=True))


def test_tf32_rows_design_by_shape():
    """Every fp32 call with O <= 32 takes the rows design at both pass
    counts, whatever C; wider O the split-TF32 design (three passes) or the
    one-pass design (one); 16-bit calls never take it."""
    assert TF32_ROWS_MAX_O == 32
    assert "tf32_rows" in DESIGNS and "tf32x1_sliced" not in DESIGNS
    for c in (1, 3, 8, 13, 64, 512):
        for o in (1, 3, 8, 9, 16, 17, 32):
            for passes in (1, 3):
                assert design(c, torch.float32, o, passes) == "tf32_rows"
            assert design(c, torch.float16, o) != "tf32_rows"
        for o in (33, 64, 512):
            assert design(c, torch.float32, o, 3) == "tf32x3"
            assert design(c, torch.float32, o, 1) == "tf32x1"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("height", [1, 7, 32, 37, 80, 130])
@pytest.mark.parametrize("width", [1, 7, 32, 80, 130, 640])
def test_tf32_rows_plan_covers_every_output_once(batch, height, width):
    """The rows plan at O = 3, 8, 16 and 32 (N 8, 16, 32, 32), C = 3, 64
    and 512, both pass counts: tiles of 128 R pixels, two warpgroup columns
    of cols x 64 R / cols rows (R = rows_phases: 64 fp32 sums a thread at
    most, acc and cor together at three passes) with cols of ROWS_COLS, at
    least 8 rows; every output pixel in exactly one tile; the blocks take
    every (tile, split) unit once; the launch fits the shared memory with
    at least two stages."""
    for c in (3, 64, 512):
        for o in (3, 8, 16, 32):
            for passes in (1, 3):
                plan = tf32_rows_plan(batch, height, width, c, o, H100_SMS,
                                      passes)
                assert isinstance(plan, RowsPlan)
                assert plan.n == out_tile(o) and plan.ks == tf32_slice_width(c)
                assert plan.phases == rows_phases(plan.n, passes) == {
                    (8, 1): 8, (16, 1): 8, (32, 1): 4, (8, 3): 8,
                    (16, 3): 4, (32, 3): 2}[plan.n, passes]
                assert plan.phases * plan.n * (1 if passes == 1 else 2) \
                    <= 128
                assert plan.cols in ROWS_COLS and plan.rows >= 8
                assert plan.rows * plan.cols == plan.m == 128 * plan.phases
                assert plan.n_tiles == 1
                stages, nbytes = plan.smem()
                assert 2 <= stages <= MAX_STAGES and nbytes <= SMEM_MAX
                assert 1 <= plan.grid == min(plan.units, H100_SMS)
                taken = sorted(u for bx in range(plan.grid)
                               for u in plan.block_units(bx))
                assert taken == list(range(plan.units))
                cover = np.zeros((batch, height, width), np.int32)
                for t in range(plan.tiles):
                    bi, y0, x0, n0 = plan.tile(t)
                    assert n0 == 0 and y0 < height and x0 < width
                    cover[bi, y0:y0 + plan.rows, x0:x0 + plan.cols] += 1
                assert (cover == 1).all(), (c, o, passes)


def _split_tf32_walk(shape, o):
    """The split-TF32 walk's tiles at an O <= 32 shape, as its N <= 32
    instances took them before the rows design (256-pixel tiles of the
    widest fit, N = O rounded up to 8, 16 or 32; unsplit: a stage's
    reckoning does not depend on the split)."""
    return SlicedPlan(*shape[:3], o,
                      wide_cols(*shape[1:3], SLICED_M, SLICED_COLS),
                      out_tile(o), 1, shape[3], tf32_slice_width(shape[3]))


def test_tf32_rows_plans_at_the_batch_and_step_shapes():
    """The Pass-2 batch's and the train step's O <= 32 shapes: the filter
    blocks' `down` [16,80,80,512] -> 32 takes 16 x 32 tiles at one pass
    (240, one split) and 16 x 16 at three (400), the `out` conv
    [16,640,640,64] -> 3 32 x 32 tiles (6400), the step's [4,32,32,512] ->
    32 splits K 8 ways, [4,256,256,64] -> 3 not.  Each stage reckons below
    the split-TF32 walk's per slice (three of its stages) in shared-memory
    bytes and in clocks, and moves fewer shared-memory bytes per clock of
    products at every N."""
    want = {((16, 80, 80, 512), 32, 1): (16, 32, 240, 1),
            ((16, 80, 80, 512), 32, 3): (16, 16, 400, 1),
            ((16, 640, 640, 64), 3, 1): (32, 32, 6400, 1),
            ((16, 640, 640, 64), 3, 3): (32, 32, 6400, 1),
            ((4, 32, 32, 512), 32, 1): (16, 32, 8, 8),
            ((4, 32, 32, 512), 32, 3): (16, 16, 16, 8),
            ((4, 256, 256, 64), 3, 1): (32, 32, 256, 1),
            ((4, 256, 256, 64), 3, 3): (32, 32, 256, 1)}
    for (shape, o, passes), (cols, rows, tiles, splits) in want.items():
        plan = tf32_rows_plan(*shape, o, H100_SMS, passes)
        assert (plan.cols, plan.rows, plan.tiles, plan.splits) == \
            (cols, rows, tiles, splits), (shape, o, passes)
        old = _split_tf32_walk(shape, o)
        new_c, new_b = tf32_rows_stage_reckoning(plan.n, plan.cols,
                                                 plan.ks, passes)
        old_c, old_b = tf32x3_stage_reckoning(old.n, old.cols, old.ks,
                                              passes)
        # a rows stage is one slice; the old walk's three stages are
        # one slice (its tile is 256 pixels, the rows tile m)
        per_px_new = max(new_c, new_b / 128) / plan.m
        per_px_old = 3 * max(old_c, old_b / 128) / old.m
        assert per_px_new < per_px_old
        assert new_b / new_c < old_b / old_c
    # The stage ratios (shared-memory clocks over product clocks) of the
    # split-TF32 walk at N = 32 and 8, one and three passes, and the rows
    # design's at the same N.
    assert [round(b / 128 / c, 2) for c, b in (
        tf32x3_stage_reckoning(32, 16, 16, 1),
        tf32x3_stage_reckoning(8, 16, 16, 1),
        tf32x3_stage_reckoning(32, 16, 16, 3),
        tf32x3_stage_reckoning(8, 16, 16, 3))] == [2.75, 9.12, 1.96, 6.08]
    assert [round(b / 128 / c, 2) for c, b in (
        tf32_rows_stage_reckoning(32, 16, 16, 1),
        tf32_rows_stage_reckoning(8, 32, 16, 1),
        tf32_rows_stage_reckoning(32, 16, 16, 3),
        tf32_rows_stage_reckoning(8, 32, 16, 3))] == [1.2, 2.7, 0.85, 1.24]


def test_direct_fp32_reckoning_at_the_out_shapes():
    """The CUDA-core candidate for O <= 8: at the decoder's `out` conv
    (a batch's [16,640,640,64] -> 3 and a step's [4,256,256,64] -> 3) the
    bytes bound it, its FMAs at 64% of them; at O = 8 and at the filter
    blocks' `down` conv (O = 32) the FMAs do, at 1.6x and 6.8x the
    bytes."""
    got = {shape: tuple(round(v, 4) for v in direct_fp32_reckoning(*shape))
           for shape in ((16, 640, 640, 64, 3), (4, 256, 256, 64, 3),
                         (16, 640, 640, 64, 8), (16, 80, 80, 512, 32))}
    assert got == {(16, 640, 640, 64, 3): (0.338, 0.5243),
                   (4, 256, 256, 64, 3): (0.0135, 0.021),
                   (16, 640, 640, 64, 8): (0.9015, 0.5634),
                   (16, 80, 80, 512, 32): (0.4507, 0.0665)}


@pytest.mark.parametrize("ks", [8, 16])
def test_rows_channel_order_matches_the_lanes_loads(ks):
    """The weights' planes put, at position 8 k + K of a slice, the channel
    that wgmma's A has at K index K of step k: lane t's loaded channels (ks
    / 4) t .. are its A values at K t (channels 2 k) and t + 4 (2 k + 1);
    the order is a permutation of the slice."""
    order = [rows_channel(p, ks) for p in range(ks)]
    assert sorted(order) == list(range(ks))
    per = ks // 4
    for k in range(ks // 8):
        for t in range(4):
            assert order[8 * k + t] == per * t + 2 * k
            assert order[8 * k + t + 4] == per * t + 2 * k + 1


@pytest.mark.parametrize("ks", [8, 16])
@pytest.mark.parametrize("cols", [16, 32, 64])
def test_rows_loads_read_where_tma_lands_and_hit_distinct_banks(ks, cols):
    """Lane t's load of box pixel q reads, at rows_offset, its channels
    (ks / 4) t .. as TMA's swizzle landed them; every fragment's loads of a
    warp (rows rho and rho + 8, any phase and dx) split into the hardware's
    phases (8 lanes of 16-byte loads, 16 of 8-byte ones) that each touch
    128 distinct bytes: no bank conflict."""
    span = 4 * ks
    rows = 2 * 64 * (4 if cols == 16 else 8) // cols
    npx = (rows + 2) * (cols + 2)
    for q in range(npx):
        for t in range(4):
            for i in range(ks // 4):
                logical = (q * ks + (ks // 4) * t + i) * 4
                assert rows_offset(q, t, ks) + 4 * i == \
                    tma_swizzle(logical, span)
    rs, width = cols + 2, 16 if ks == 16 else 8
    per_phase = 128 // width
    for q00 in (0, 1, 5, 2 * rs + 3):
        for warp in range(4):
            lanes = np.arange(32)
            rho = 16 * warp + lanes // 4
            for dq in (0, 8):
                q = q00 + (rho // cols) * 4 * rs + rho % cols + dq
                off = rows_offset(q, lanes % 4, ks)
                for g in range(0, 32, per_phase):
                    slots = (off[g:g + per_phase] % 128) // width
                    assert len(set(slots)) == per_phase


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("o", [3, 8, 16, 32])
@pytest.mark.parametrize("c,shape", [(3, (2, 19, 21)), (8, (2, 19, 21)),
                                     (64, (1, 21, 37)), (512, (1, 9, 10))])
def test_tf32_rows_walk_matches_plain_and_pallas(c, shape, o, passes):
    """The rows walk at the wrapper's plan (a grid of 3 blocks), thread by
    thread where its index math is (_emulate_rows): C = 3 in a padded copy
    (Cp = 4, one 8-channel slice), 8 in one slice, 64 in four 16-channel
    slices, 512 in 32 (a 9 x 10 image: most of a tile outside it); O = 3
    (scalar stores), 8, 16, 32; ragged tiles.  Within the pass count's bar
    of the plain fp32 conv and of the Pallas kernel in interpret mode."""
    x, w, b = _sliced_case(c, o, shape, seed=31)
    plan = dataclasses.replace(
        tf32_rows_plan(*shape, c, o, H100_SMS, passes), grid=3)
    got = _emulate_rows(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    bar = _rows_bar(c, passes) * scale
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= bar).all()
    assert (np.abs(got - _rows_pallas(x, w, b)) <= bar).all()


@pytest.mark.parametrize("cols", [16, 32, 64])
@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_rows_every_tile_width(cols, passes):
    """Each tile width the plan may take, [2,19,70,24] -> 17 (N = 32, R =
    4; two slices, the second zero-filled past C), a grid of 2 blocks:
    within the pass count's bar of the plain conv."""
    x, w, b = _sliced_case(24, 17, (2, 19, 70), seed=32)
    base = tf32_rows_plan(2, 19, 70, 24, 17, H100_SMS, passes)
    plan = dataclasses.replace(base, cols=cols, grid=2)
    got = _emulate_rows(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
    assert (np.abs(got - want) <= _rows_bar(24, passes) * scale).all()


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("splits", [2, 4])
def test_tf32_rows_split_walk_matches_plain_and_pallas(passes, splits):
    """[1,8,8,64] -> 16 and [1,9,10,512] -> 32 with each tile's K split
    2 and 4 ways (forced): the splits' partials, split 0's from the bias,
    summed in split order, within the pass count's bar of the plain conv
    and of the Pallas kernel in interpret mode."""
    for c, o, shape in ((64, 16, (1, 8, 8)), (512, 32, (1, 9, 10))):
        x, w, b = _sliced_case(c, o, shape, seed=33)
        base = tf32_rows_plan(*shape, c, o, 4, passes)
        plan = with_splits(base, splits, 4)
        assert plan.splits == splits and plan.units == plan.tiles * splits
        got = _emulate_rows(x, w, b, plan)
        tt = [torch.from_numpy(v) for v in (x, w, b)]
        want = conv3x3_implicit_gemm_plain(*tt).numpy()
        scale = conv3x3_implicit_gemm_plain(*(t.abs() for t in tt)).numpy()
        bar = _rows_bar(c, passes) * scale
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= bar).all()
        assert (np.abs(got - _rows_pallas(x, w, b)) <= bar).all()


@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_rows_nonfinite_and_huge_inputs(passes):
    """inf, -inf, NaN and +-FLT_MAX inside, on both sides of a tile's and a
    warpgroup column's edges, at the image's edges and in the last channel
    (C = 13: a padded copy), O = 24: the rows walk's NaN and inf outputs are
    exactly the plain conv's, of the same sign, and the finite ones agree
    within the pass count's bar (FLT_MAX's too: neither its rounding nor its
    split overflows)."""
    c, o = 13, 24
    x, w, b = _sliced_case(c, o, (2, 19, 40), seed=34)
    for idx, v in [((0, 3, 5, 7), np.inf), ((0, 10, 15, 1), -np.inf),
                   ((0, 10, 16, c - 1), np.nan), ((0, 15, 30, 4), np.inf),
                   ((0, 16, 31, 2), -np.inf), ((1, 0, 39, 0), np.nan),
                   ((1, 18, 0, c - 1), -np.inf), ((0, 5, 25, 2), FLT_MAX),
                   ((1, 9, 12, c - 1), -FLT_MAX)]:
        x[idx] = v
    plan = tf32_rows_plan(2, 19, 40, c, o, H100_SMS, passes)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_rows(x, w, b, plan)
    tt = [torch.from_numpy(v) for v in (x, w, b)]
    want = conv3x3_implicit_gemm_plain(*tt).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isinf(got) == np.isinf(want)).all()
    assert (np.sign(got[np.isinf(want)]) == np.sign(want[np.isinf(want)])).all()
    fin = np.isfinite(want)
    assert not fin.all() and np.abs(want[fin]).max() > 1e36
    xz = np.where(np.isfinite(x), x, 0).astype(np.float32)
    scale = conv3x3_implicit_gemm_plain(
        torch.from_numpy(np.abs(xz)), torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(b))).numpy()
    assert (np.abs(got[fin] - want[fin])
            <= _rows_bar(c, passes) * scale[fin]).all()


@pytest.mark.parametrize("variant", ["as_is", "no_wgmma", "no_round",
                                     "one_dx", "three_dx", "no_store",
                                     "one_group", "regs_40", "no_split_sum",
                                     "no_group_fence", "no_lds"])
def test_rows_probe_edits_match_the_kernel_source(variant):
    """scripts/probe_rows_conv.py builds each variant by editing the text
    of csrc/conv3x3_rows.cu: every edit must find its text there exactly
    once, or the probe's build refuses it."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "probe_rows_conv", root / "scripts" / "probe_rows_conv.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "rerevst_torch" / "csrc" / "conv3x3_rows.cu").read_text()
    assert set(probe.VARIANTS) == {"as_is", "no_wgmma", "no_round", "one_dx",
                                   "three_dx", "no_store", "one_group",
                                   "regs_40", "no_split_sum",
                                   "no_group_fence", "no_lds"}
    for old, new in probe.VARIANTS[variant]:
        assert src.count(old) == 1
        src = src.replace(old, new)
