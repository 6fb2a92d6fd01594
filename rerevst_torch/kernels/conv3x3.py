"""SAME-padded 3x3 convolution, NHWC x HWIO -> NHWC, with an optional bias.

The ports of the two TPU conv kernels of ``rerevst_tpu/kernels/conv3x3.py``:

* ``conv3x3_implicit_gemm`` (any C, any O) — ``conv3x3_implicit_gemm`` there;
* ``conv3x3_pairlane`` (C = 64, O <= 64) — ``conv3x3_pairlane`` there, the
  full-resolution 64-channel layers of the pair-lane model path (encoder
  conv1_2, decoder res2.conv2 and the 64->3 out conv).  The TPU kernel's
  W-pair lane layout (and its ``fused_io`` form) has no counterpart: in NHWC
  the pair fuse is a contiguous reshape, and the card's kernel needs none.

Both compute ``y = conv(x, w) + b`` with fp32 accumulation and the bias added
in fp32, rounded once to x's dtype.  ``x`` is contiguous NHWC, ``w`` the HWIO
``[3, 3, C, O]`` weights as the checkpoints hold them, ``b`` ``[O]``, all in
one storage dtype.  The kernels are ``csrc/conv3x3.cu``, one design per
shape (:func:`design` names it):

* f16/bf16 with C = 64 (both entry points): the streamed TMA + wgmma
  design, whose work split :func:`conv_plan` computes here;
* f16/bf16 with C % 64 = 0, C >= 128 and O > ``SLICED_MAX_O``: the wide
  design, a TMA-fed ring of 64-channel tap slices into wgmma, whose work
  split :func:`wide_plan` computes here (where O % 8 != 0 the wrapper hands
  it a copy of ``w`` padded with zeros to a multiple of 8 channels: no
  tensor map takes the weights' row stride otherwise);
* f16/bf16 with 1 <= C <= 7 (VGG conv1_1's C = 3): the narrow design, one
  halo read per tile of 8 x 32 pixels, K = 9 C in one mma.sync pass and
  the output staged for TMA bulk stores, whose work split
  :func:`narrow_plan` computes here;
* f16/bf16 with any other C >= 8 (C = 8, 32, 96, 100, 160, 200, ..., and
  C % 64 = 0 with O <= ``SLICED_MAX_O``, such as the decoder filter
  blocks' `down` conv 512 -> 32): the sliced design, a TMA-fed wgmma ring
  over K slices of 16 or 32 channels (one halo'd box per slice and dx
  feeds the three taps dy), with its
  output staged per m64 block and written by TMA bulk stores behind the
  next tile's products; its work split :func:`sliced_plan` computes here
  (where C % 8 != 0 the wrapper hands it copies of ``x`` and ``w`` padded
  with zero channels to a whole K slice, and where O % 8 != 0 a copy of
  ``w`` padded to 8 output channels, as for the wide design);
* fp32 with O <= ``TF32_ROWS_MAX_O`` = 32 (both entry points, any C,
  either pass count): the rows design (``"tf32_rows"``,
  ``csrc/conv3x3_rows.cu``): pixels as wgmma's A from registers, each
  fragment of x loaded once from a slice's one halo'd box and fed to the
  three taps dy of its dx through R accumulator rows a warpgroup, the
  weights' K-major planes as B, N = O rounded up to 8, 16 or 32; its work
  split :func:`tf32_rows_plan` computes here;
* fp32 with larger O (both entry points): the split-TF32 design, the
  sliced design's walk over K slices of 16 fp32 channels (8 where C <= 8)
  with each fp32 product taken on the tensor cores as three TF32 passes,
  x_hi w_hi + x_hi w_lo + x_lo w_hi (fp32-accurate, as the JAX package's
  HIGHEST and HIGH; design ``"tf32x3"``); its work split
  :func:`tf32x3_plan` computes here.  Where the implicit-GEMM wrapper is
  called with ``passes=1`` (the ``'default'`` precision) each product is
  one pass x w with both rounded to nearest TF32, on the one-pass design
  (``"tf32x1"``: the weights as wgmma's A, 64 output channels a block,
  over a wide N of 128 or 256 pixels of x, each warpgroup rounding the box
  rows its own taps read); :func:`tf32x1_plan` computes its work split.
  Where a call has fewer tiles than the card has SMs (a train step's 32^2
  images), the fp32 plans split each tile's K over several blocks, whose
  fp32 partials the last of them to finish sums in split order
  (``SlicedPlan.splits``).  The wrapper hands the fp32 kernels a scratch
  tensor for the weights' K-major hi (and lo) planes, which the kernel
  writes first, followed by the split partials' workspace, and where C %
  4 != 0 a copy of ``x`` padded with zero channels to a multiple of 4.

No forward call reaches a cp.async + mma.sync kernel or the CUDA cores'
FMAs.

The backward of the fp32 designs (``Conv3x3Fn``, which the implicit-GEMM
wrapper takes where autograd needs a gradient): the input gradient is the
same kernel on the output gradient with the weights rotated 180 degrees and
C and O swapped, at the same ``passes``; the weight gradient is
``conv3x3_wgrad``, ``csrc/conv3x3_wgrad.cu`` (wgmma ``.tf32`` fed by TMA
where C and O are 8 or more and multiples of 4, else mma.sync m16n8k8
TF32; the same hi/lo split, K split over blocks and summed in a fixed
order), whose route and work split :func:`wgrad_plan` computes here; the
bias gradient is a sum.  It replaces no TPU kernel: it is the weight gradient JAX's autodiff
makes of the XLA conv at HIGH or DEFAULT.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  Each wrapper reaches both through its
``torch.library`` op, ``rerevst::conv3x3_implicit_gemm``,
``rerevst::conv3x3_pairlane`` or ``rerevst::conv3x3_wgrad``: the op's CUDA
implementation launches the
kernel, its CPU implementation is the plain version, and its fake
implementation gives the output's shape alone, so that ``torch.export``
captures the op as one node.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from rerevst_torch.kernels import _build
from rerevst_torch.ops.precision import exact_products

_CODES = _build.DTYPE_CODES
_C64 = 64       # csrc/conv3x3.cu kC: the channels of the streamed design
TW = 128        # csrc/conv3x3.cu kTW: output pixels per column strip
MAX_ROWS = 64   # the tallest band conv_plan considers


def out_tile(o: int) -> int:
    """The streamed kernel's wgmma width N for O output channels (the
    launcher's dispatch): 8, 16, 32 or 64; O > 64 tiles by 64."""
    return 8 if o <= 8 else 16 if o <= 16 else 32 if o <= 32 else 64


@dataclass(frozen=True)
class ConvPlan:
    """The streamed kernel's work split for one call.

    A unit is one image x a strip of ``TW`` output columns x a band of
    ``rows`` output rows; ``grid`` persistent blocks per tile of output
    channels take units ``bx, bx + grid, ...``.
    """

    batch: int
    height: int
    width: int
    rows: int
    grid: int
    n_tiles: int

    @property
    def strips(self) -> int:
        return -(-self.width // TW)

    @property
    def bands(self) -> int:
        return -(-self.height // self.rows)

    @property
    def units(self) -> int:
        return self.batch * self.bands * self.strips

    def unit(self, u: int):
        """(image, first output row, first output column, rows) of unit
        ``u``: the kernel's ``unit_of`` (strip fastest, then band, image)."""
        x0 = (u % self.strips) * TW
        q = u // self.strips
        y0 = (q % self.bands) * self.rows
        return q // self.bands, y0, x0, min(self.rows, self.height - y0)

    def block_units(self, bx: int) -> range:
        return range(bx, self.units, self.grid)


@functools.lru_cache(maxsize=256)
def conv_plan(batch: int, height: int, width: int, o: int,
              sms: int) -> ConvPlan:
    """Band height and grid for a [batch, height, width, 64] -> o conv on a
    card with ``sms`` SMs: one block per SM in all (split over the output
    channel tiles), and the band height that makes the busiest block's
    stream of input rows (each unit's rows + 2) shortest, taller bands first
    on a tie."""
    n_tiles = -(-o // out_tile(o))
    per_tile = max(1, sms // n_tiles)
    strips = -(-width // TW)
    best = None
    for r in range(1, min(height, MAX_ROWS) + 1):
        bands = -(-height // r)
        units = batch * bands * strips
        grid = min(units, per_tile)
        band_rows = np.minimum(r, height - r * np.arange(bands)) + 2
        cost = np.tile(np.repeat(band_rows, strips), batch)
        span = np.bincount(np.arange(units) % grid, weights=cost).max()
        if best is None or span <= best[0]:
            best = (span, r, grid)
    _, r, grid = best
    return ConvPlan(batch, height, width, r, grid, n_tiles)


#: The tile widths the wide design takes (rows = pixels per tile // cols),
#: widest first: the order that breaks a tie between shapes that waste
#: alike.
WIDE_COLS = (128, 64, 32, 16)


#: csrc/conv3x3.cu kSlicedMaxO: 16-bit C % 64 = 0, C >= 128 with O up to
#: this take the sliced design, wider O the wide one (PERF.md section 6:
#: the two designs' A/B at C 128 / 256 / 512 x O 3 / 16 / 32 / 64).
SLICED_MAX_O = 64


#: fp32 calls with O up to this take the rows design ("tf32_rows",
#: csrc/conv3x3_rows.cu: N = O rounded up to 8, 16 or 32) at either pass
#: count; wider O the split-TF32 design (three passes) or the one-pass
#: design ("tf32x1"), whose m64 blocks of output channels would be mostly
#: padding below it.
TF32_ROWS_MAX_O = 32

SMEM_BYTES_PER_CLOCK = 128  # what an SM's shared memory moves a clock
SMEM_MAX = 232448  # csrc/conv3x3.cu kSmemMax: dynamic shared memory a block
MAX_STAGES = 8     # csrc/conv3x3.cu kSlicedMaxStages
#: The fewest K slices a split of the fp32 designs takes where the plan
#: chooses: 3 slices x 3 dx = 9 stages, enough to fill a ring of
#: MAX_STAGES before the unit's products run out.
MIN_SPLIT_SLICES = -(-MAX_STAGES // 3)
#: The card's memory rate in bytes an SM clock (3.35 TB/s at 1.755 GHz),
#: at which the plans reckon the split partials' traffic.
HBM_BYTES_PER_CLOCK = 3.35e12 / 1.755e9


def design(c: int, dtype: torch.dtype, o: int, passes: int = 3) -> str:
    """Which kernel of ``csrc/conv3x3.cu`` takes a call with C input
    channels and O output channels in ``dtype`` (the launcher's dispatch
    by shape; `passes`, the TF32 passes of an fp32 call, 3 or 1)."""
    if dtype == torch.float32:
        if o <= TF32_ROWS_MAX_O:
            return "tf32_rows"
        return "tf32x3" if passes == 3 else "tf32x1"
    if c == _C64:
        return "streamed"
    if c % 64 == 0 and c >= 128 and o > SLICED_MAX_O:
        return "wide"
    if 1 <= c <= NARROW_MAX_C:
        return "narrow"
    return "sliced"


def wide_tile_n(o: int) -> int:
    """The wide kernel's wgmma width N for O output channels: O rounded up
    to 8, 16, 32 or 64 below 64, else 128, or 256 from O = 256 on (fewer
    bytes staged per flop; 128 fp32 accumulators a thread fit the consumer
    warpgroups' 232 registers)."""
    if o <= 64:
        return out_tile(o)
    return 128 if o < 256 else 256


def wide_tile_m(n: int) -> int:
    """Output pixels per tile of the wide kernel at width N (csrc/conv3x3.cu
    Wide::kM): 256, two m64 blocks per consumer warpgroup, where their
    accumulators fit (N <= 128); 128 at N = 256."""
    return 256 if n <= 128 else 128


@dataclass(frozen=True)
class WidePlan:
    """The wide kernel's work split for one call.

    A tile is ``rows x cols`` output pixels (``m`` of them, one TMA box of
    the input per tap and channel slice) x ``n`` output channels; ``grid``
    persistent blocks take tiles ``bx, bx + grid, ...`` in the order of
    :meth:`tile`.
    """

    batch: int
    height: int
    width: int
    o: int
    cols: int
    n: int
    grid: int

    @property
    def m(self) -> int:
        return wide_tile_m(self.n)

    @property
    def rows(self) -> int:
        return self.m // self.cols

    @property
    def strips(self) -> int:
        return -(-self.width // self.cols)

    @property
    def bands(self) -> int:
        return -(-self.height // self.rows)

    @property
    def n_tiles(self) -> int:
        return -(-self.o // self.n)

    @property
    def tiles(self) -> int:
        return self.n_tiles * self.strips * self.bands * self.batch

    def tile(self, t: int):
        """(image, first output row, first output column, first output
        channel) of tile ``t``: the kernel's ``wide_tile`` (channel tile
        fastest, then strip, band, image; blocks at work together read
        neighbouring rows, which L2 still holds for the taps that re-read
        them)."""
        n0 = (t % self.n_tiles) * self.n
        q = t // self.n_tiles
        x0 = (q % self.strips) * self.cols
        q //= self.strips
        y0 = (q % self.bands) * self.rows
        return q // self.bands, y0, x0, n0

    def block_tiles(self, bx: int) -> range:
        return range(bx, self.tiles, self.grid)


def wide_cols(height: int, width: int, m: int,
              choices: tuple = WIDE_COLS) -> int:
    """The tile width that pads the image least (tiles of m pixels, rows x
    cols, over height x width), the first of `choices` on a tie (the
    widest, for the wide design)."""
    def padded(cols):
        rows = m // cols
        return -(-width // cols) * cols * (-(-height // rows) * rows)
    return min(choices, key=padded)  # min keeps the first of equals


@functools.lru_cache(maxsize=256)
def wide_plan(batch: int, height: int, width: int, o: int,
              sms: int) -> WidePlan:
    """Tile shape, width N and grid for a [batch, height, width, C] -> o
    conv (C % 64 = 0, C >= 128) on a card with ``sms`` SMs: one block per
    SM, or one per tile where there are fewer tiles."""
    n = wide_tile_n(o)
    cols = wide_cols(height, width, wide_tile_m(n))
    plan = WidePlan(batch, height, width, o, cols, n, 1)
    return WidePlan(batch, height, width, o, cols, n, min(plan.tiles, sms))


#: The tile widths the sliced design takes, narrowest first: a tie between
#: shapes that pad alike goes to the tallest tile, whose halo'd boxes
#: (rows + 2 rows for rows of output) re-read the fewest input rows.
SLICED_COLS = (16, 32, 64, 128)
SLICED_M = 256  # csrc/conv3x3.cu Sliced::kM: output pixels a tile


def slice_width(c: int) -> int:
    """The sliced design's K slice KS for C input channels: 16 where C <=
    16 (one slice, half the zero-filled K of a 32-channel one at C = 8),
    else 32: a stage of 16 channels carries half the products of a 32-
    channel one for the same barrier round trip and wgmma wait (PERF.md
    section 6)."""
    return 16 if c <= 16 else 32


def sliced_tile_n(o: int) -> int:
    """The sliced kernel's wgmma width N for O output channels: O rounded
    up to 8, 16, 32 or 64 below 64, else 128 (256 would halve the tile's
    pixels and double each stage's weight bytes)."""
    return out_tile(o) if o <= 64 else 128


@dataclass(frozen=True)
class SlicedPlan(WidePlan):
    """The sliced kernel's work split for one call: the wide design's tile
    walk (256-pixel tiles of ``rows x cols``, channel tile fastest) over K
    slices of ``ks`` of the ``c`` input channels (``slices`` of them, the
    last zero-filled past C), each slice staged once per dx.

    The fp32 designs (the split-TF32 walk and the one-pass design) may
    split each tile's K over ``splits`` blocks: ``grid`` persistent blocks
    then walk units (tile, split), split fastest (:meth:`unit`); split
    ``s`` takes the contiguous run of slices :meth:`split_slices`, each
    unit's consumer warpgroups write their fp32 partial sums to the
    workspace, and the last of a tile's units to finish sums the partials
    in split order.  The 16-bit sliced kernel has ``splits`` = 1."""

    c: int
    ks: int
    splits: int = dataclasses.field(default=1, kw_only=True)

    #: Stages a K slice: one a dx (the tap-shifted boxes of the sliced
    #: walk).
    STAGES_PER_SLICE = 3

    @property
    def slices(self) -> int:
        return -(-self.c // self.ks)

    @property
    def units(self) -> int:
        """(tile, split) units in all: ``tiles`` x ``splits``."""
        return self.tiles * self.splits

    def unit(self, u: int) -> tuple:
        """(tile, split) of unit ``u``: the kernel's order, split fastest
        (a tile's units run side by side in one round of the blocks)."""
        return divmod(u, self.splits)

    def block_units(self, bx: int) -> range:
        return range(bx, self.units, self.grid)

    def split_slices(self, s: int) -> range:
        """The K slices split ``s`` sums: a contiguous run; the runs of
        splits 0, 1, ... cover every slice once, in order."""
        return range(s * self.slices // self.splits,
                     (s + 1) * self.slices // self.splits)

    @property
    def workspace_bytes(self) -> int:
        """The partials' workspace after the weights' scratch (none at one
        split): ``splits`` fp32 partials of every tile (m pixels x n
        channels, in the consumer threads' register order), then one int
        counter per tile and consumer warpgroup (csrc/conv3x3.cu
        split_sum)."""
        if self.splits == 1:
            return 0
        return self.tiles * (self.splits * self.m * self.n + 2) * 4

    def split_cost(self, sms: int, stage_clocks: float) -> float:
        """Reckoned clocks of the call at ``stage_clocks`` a stage: the
        busiest block's rounds of units over the SMs x its units'
        ``STAGES_PER_SLICE`` x slices / splits stages (rounded up), plus the
        workspace's bytes, written and read once, at the card's memory
        rate."""
        rounds = -(-self.units // sms)
        stages = self.STAGES_PER_SLICE * -(-self.slices // self.splits)
        return rounds * stages * stage_clocks \
            + 2 * self.workspace_bytes / HBM_BYTES_PER_CLOCK


@functools.lru_cache(maxsize=256)
def sliced_plan(batch: int, height: int, width: int, c: int, o: int,
                sms: int) -> SlicedPlan:
    """Tile shape, width N, K slice and grid for a [batch, height, width,
    c] -> o conv on the sliced design, on a card with ``sms`` SMs: one
    block per SM, or one per tile where there are fewer tiles."""
    if design(c, torch.float16, o) != "sliced":
        raise ValueError(f"the sliced design takes C >= 8 that is neither "
                         f"64 nor a multiple of 64 >= 128 (those too with "
                         f"O <= {SLICED_MAX_O}); got C={c}, O={o}")
    n = sliced_tile_n(o)
    cols = wide_cols(height, width, SLICED_M, SLICED_COLS)
    plan = SlicedPlan(batch, height, width, o, cols, n, 1, c, slice_width(c))
    return dataclasses.replace(plan, grid=min(plan.tiles, sms))


def with_splits(plan: SlicedPlan, splits: int, sms: int) -> SlicedPlan:
    """`plan` with its K split over `splits` blocks a tile (at most one a
    slice) and one block an SM, or one a unit where there are fewer."""
    splits = max(1, min(splits, plan.slices))
    return dataclasses.replace(plan, splits=splits,
                               grid=min(plan.tiles * splits, sms))


def _split_k(plan: SlicedPlan, sms: int, stage_clocks: float) -> SlicedPlan:
    """`plan` (one split) with the K split of least reckoned clocks
    (:meth:`SlicedPlan.split_cost`), the fewest splits on a tie: one
    wherever the tiles fill the SMs; else up to one split per
    ``MIN_SPLIT_SLICES`` slices, so that each unit's stages still fill the
    ring."""
    best = with_splits(plan, 1, sms)
    if plan.tiles >= sms:
        return best
    for splits in range(2, plan.slices // MIN_SPLIT_SLICES + 1):
        cand = with_splits(plan, splits, sms)
        if cand.split_cost(sms, stage_clocks) < \
                best.split_cost(sms, stage_clocks):
            best = cand
    return best


def tf32x3_stage_reckoning(n: int, cols: int, ks: int,
                           passes: int = 3) -> tuple:
    """(clocks of products, bytes through shared memory) of one stage of
    the split-TF32 walk on one SM, both consumer warpgroups: 3 taps x KS /
    8 k8 steps x two m64 blocks x `passes` wgmma m64nNk8 .tf32 each (N / 2
    clocks at 1024 TF32 FMAs a clock; 2 KB of A, the pixels, and 32 N
    bytes of B, the weights, read); TMA's writes of the box of x ((rows +
    2) x cols pixels of 4 KS bytes, rows = 256 / cols) and of the
    weights' 3 boxes {KS, N} a plane (hi, and lo at three passes); and the
    consumers' pass over the box, read once and written once (its lo, or
    x rounded in place).  The kernel runs N = 64 at three passes; N <= 32
    and one pass reckon the instances it once had, against which the rows
    design was chosen (:func:`tf32_rows_stage_reckoning`)."""
    steps = 2 * 3 * (ks // 8) * 2 * passes
    clocks = steps * n // 2
    reads = steps * (64 * 8 * 4 + n * 8 * 4)
    box = (SLICED_M // cols + 2) * cols * ks * 4
    tma = box + 3 * (2 if passes == 3 else 1) * n * ks * 4
    return clocks, reads + tma + 2 * box


def tf32_slice_width(c: int) -> int:
    """The split-TF32 design's K slice for C fp32 input channels: 8 where
    C <= 8 (a wgmma k8 step: 32 bytes a pixel), else 16 (64 bytes a pixel,
    the byte geometry of the 16-bit KS = 32 slice)."""
    return 8 if c <= 8 else 16


@functools.lru_cache(maxsize=256)
def tf32x3_plan(batch: int, height: int, width: int, c: int, o: int,
                sms: int) -> SlicedPlan:
    """Tile shape, width N, K slice, K split and grid for a [batch,
    height, width, c] -> o fp32 conv (O > ``TF32_ROWS_MAX_O``) on the
    split-TF32 design (the sliced design's walk) at three TF32 passes:
    256-pixel tiles, N = 64 (O tiles by 64); where the tiles are fewer
    than the SMs, each tile's K split over the blocks that reckon least
    (:func:`_split_k`, a stage as :func:`tf32x3_stage_reckoning` reckons
    it); one block per SM or one per unit where there are fewer."""
    if o <= TF32_ROWS_MAX_O:
        raise ValueError(f"the split-TF32 design takes O > "
                         f"{TF32_ROWS_MAX_O} (the rows design the rest); "
                         f"got O={o}")
    plan = SlicedPlan(batch, height, width, o,
                      wide_cols(height, width, SLICED_M, SLICED_COLS),
                      out_tile(o), 1, c, tf32_slice_width(c))
    clocks, nbytes = tf32x3_stage_reckoning(plan.n, plan.cols, plan.ks)
    return _split_k(plan, sms, max(clocks, nbytes / SMEM_BYTES_PER_CLOCK))


#: The one-pass design's tile shapes (csrc/conv3x3.cu Tf32x1<MB, NPX, KS>):
#: (m64 blocks of output channels a warpgroup, pixels a warpgroup: wgmma's
#: N), a tile being 2 NPX pixels x 64 MB channels; fewest shared-memory
#: bytes a product first.  MB = 2 (two m64n128 blocks) only where O > 64.
TF32X1_SHAPES = ((2, 128), (1, 256), (1, 128))


def tf32x1_stage_reckoning(mb: int, npx: int, cols: int,
                           ks: int) -> tuple:
    """(clocks of products, bytes through shared memory) of one stage of
    the one-pass design on one SM, both consumer warpgroups: 3 taps x KS /
    8 k8 steps x MB blocks of wgmma m64nNk8 .tf32 each, N = NPX pixels (N
    / 2 clocks at 1024 TF32 FMAs a clock; 2 KB of A, the weights, and 32 N
    bytes of B, the pixels, read); TMA's writes of the box of x ((rows +
    2) x cols pixels of 4 KS bytes, rows = 2 NPX / cols) and of the 3 MB
    weight boxes {KS, 64}; and each warpgroup's rounding, a read and a
    write of the NPX + 2 cols box pixels its taps read."""
    steps = 2 * 3 * (ks // 8) * mb
    clocks = steps * npx // 2
    reads = steps * (64 * 8 * 4 + npx * 8 * 4)
    rows = 2 * npx // cols
    tma = (rows + 2) * cols * ks * 4 + 3 * mb * 64 * ks * 4
    rounding = 2 * 2 * (npx + 2 * cols) * ks * 4
    return clocks, reads + tma + rounding


@dataclass(frozen=True)
class Tf32x1Plan(SlicedPlan):
    """The one-pass design's work split: tiles of ``m`` = 2 ``npx``
    pixels (rows x cols) x ``n`` = 64 ``mb`` output channels in the sliced
    walk's order (channel tile fastest), each consumer warpgroup ``npx``
    of the tile's pixels (its rows / 2 rows) x every channel, over K
    slices of ``ks`` fp32 channels."""

    mb: int
    npx: int

    @property
    def m(self) -> int:
        return 2 * self.npx

    def stage_clocks(self) -> float:
        """The reckoned clocks of a stage: the products, or the shared
        memory's bytes at SMEM_BYTES_PER_CLOCK, the larger."""
        clocks, nbytes = tf32x1_stage_reckoning(self.mb, self.npx,
                                                self.cols, self.ks)
        return max(clocks, nbytes / SMEM_BYTES_PER_CLOCK)

    def cost(self, sms: int) -> float:
        """Reckoned clocks of the call: the busiest block's units x their
        3 x slices / splits stages, and the split partials' bytes
        (:meth:`SlicedPlan.split_cost`)."""
        return self.split_cost(sms, self.stage_clocks())

    def smem(self) -> tuple:
        """(ring stages, dynamic shared-memory bytes) of the launch, as
        csrc/conv3x3.cu launch_tf32x1 reckons them: 1024 bytes of
        alignment, two warpgroups' epilogue staging (two buffers of 8 KB
        each: 32 / MB pixels x 64 MB fp32 channels), the bias (O rounded up
        to the tile's channels), then as many stages (the box of x on whole
        KB, the 3 MB weight boxes {KS, 64}, two mbarriers) as fit, at most
        MAX_STAGES."""
        ks4 = 4 * self.ks
        a_slot = -(-(self.rows + 2) * self.cols * ks4 // 1024) * 1024
        stage = a_slot + 3 * self.mb * 64 * ks4 + 16
        fixed = 1024 + 2 * 2 * 8192 + self.n_tiles * self.n * 4
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // stage)
        return stages, fixed + stages * stage


@functools.lru_cache(maxsize=256)
def tf32x1_plan(batch: int, height: int, width: int, c: int, o: int,
                sms: int) -> SlicedPlan:
    """The work split of a one-pass fp32 [batch, height, width, c] -> o
    conv on a card with ``sms`` SMs.  Design "tf32x1": of the tile shapes
    ``TF32X1_SHAPES`` (each with the tile width that pads the image least,
    the narrowest on a tie, and the K split that reckons least,
    :func:`_split_k`), the one whose reckoned clocks
    (:meth:`Tf32x1Plan.cost`: rounds of units over the SMs x stages x each
    stage's products or shared-memory bytes, plus the split partials'
    bytes) are least, the first on a tie; one block per SM or one per unit
    where there are fewer.  O > ``TF32_ROWS_MAX_O`` (the rows design
    takes the rest)."""
    if o <= TF32_ROWS_MAX_O:
        raise ValueError(f"the one-pass design takes O > "
                         f"{TF32_ROWS_MAX_O} (the rows design the rest); "
                         f"got O={o}")
    best = None
    for mb, npx in TF32X1_SHAPES:
        if mb > 1 and o <= 64:
            continue
        cols = wide_cols(height, width, 2 * npx, SLICED_COLS)
        plan = Tf32x1Plan(batch, height, width, o, cols, 64 * mb, 1, c,
                          tf32_slice_width(c), mb, npx)
        plan = _split_k(plan, sms, plan.stage_clocks())
        if best is None or plan.cost(sms) < best.cost(sms):
            best = plan
    return best


#: The rows design's tile widths (csrc/conv3x3_rows.cu: cw, the columns of
#: a warpgroup's column of output), narrowest first.
ROWS_COLS = (16, 32, 64)


def rows_phases(n: int, passes: int) -> int:
    """The rows design's accumulator rows a warpgroup (csrc/conv3x3_rows.cu
    Rows::kR) at width N: R N / 2 fp32 sums a thread, and as many again at
    three passes (the corrections), 64 registers at most, R at most 8: one
    pass 8, 8, 4 at N = 8, 16, 32; three passes 8, 4, 2."""
    return min(8, (128 if passes == 1 else 64) // n)


def rows_channel(p: int, ks: int) -> int:
    """The input channel at position p of a K slice of `ks` in the rows
    design's weight planes (csrc/conv3x3_rows.cu rows_channel): k8 step j =
    p // 8 takes, at its K index k, channel (ks / 4) (k % 4) + 2 j + k // 4,
    so that the ks / 4 channels a lane loads from a pixel are its A values
    at K indices t and t + 4 of every step."""
    j, k = divmod(p, 8)
    return (ks // 4) * (k % 4) + 2 * j + k // 4


def tf32_rows_stage_reckoning(n: int, cols: int, ks: int,
                              passes: int) -> tuple:
    """(clocks of products, bytes through shared memory) of one stage (one
    K slice) of the rows design on one SM, both consumer warpgroups: 9 taps
    x R rows x KS / 8 k8 steps x `passes` wgmma m64nNk8 .tf32 a warpgroup
    (N / 2 clocks each at 1024 TF32 FMAs a clock; A from registers, 32 N
    bytes of B, the weights, read from shared memory); the A fragments
    loaded from the box, (R + 2) phases x 3 dx of 64 pixels x KS fp32
    channels a warpgroup; and TMA's writes of the box of x ((rows + 2) x
    (cols + 2) pixels of 4 KS bytes, rows = 128 R / cols) and of the
    weights ({KS, N} for 9 taps, hi and lo at three passes)."""
    r = rows_phases(n, passes)
    steps = 2 * 9 * r * (ks // 8) * passes
    clocks = steps * n // 2
    b_reads = steps * n * 8 * 4
    a_loads = 2 * (r + 2) * 3 * 64 * ks * 4
    box = (128 * r // cols + 2) * (cols + 2) * ks * 4
    weights = 9 * (2 if passes == 3 else 1) * n * ks * 4
    return clocks, b_reads + a_loads + box + weights


#: The card's fp32 rate outside the tensor cores (H100 SXM: 67 TFLOP/s)
#: and its memory rate, in the units of :func:`direct_fp32_reckoning`.
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def direct_fp32_reckoning(batch: int, height: int, width: int, c: int,
                          o: int) -> tuple:
    """(ms of products, ms of bytes) of a CUDA-core direct conv, the
    candidate the rows design was weighed against for O <= 8 (not built):
    9 C O fp32 FMAs an output pixel at FP32_FLOP_PER_S, and x read once
    and y written once at HBM_BYTES_PER_S.  The pass count does not enter:
    one fp32 FMA is as accurate as three TF32 passes, and a TF32 x TF32
    product is exact in fp32."""
    pixels = batch * height * width
    flops = 2 * pixels * 9 * c * o
    nbytes = 4 * pixels * (c + o)
    return flops / FP32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


@dataclass(frozen=True)
class RowsPlan(SlicedPlan):
    """The rows design's work split: tiles of ``m`` = 128 ``phases``
    pixels (``rows`` x ``cols``: two warpgroup columns of cols x rows / 2,
    one above the other) x ``n`` output channels, walked strip fastest,
    then band and image (one channel tile), each K slice of ``ks``
    channels one stage, at ``passes`` TF32 passes."""

    phases: int
    passes: int

    #: One stage a K slice: the dx shift is an offset into the slice's box.
    STAGES_PER_SLICE = 1

    @property
    def m(self) -> int:
        return 128 * self.phases

    def stage_clocks(self) -> float:
        """The reckoned clocks of a stage: the products, or the shared
        memory's bytes at SMEM_BYTES_PER_CLOCK, the larger."""
        clocks, nbytes = tf32_rows_stage_reckoning(self.n, self.cols,
                                                   self.ks, self.passes)
        return max(clocks, nbytes / SMEM_BYTES_PER_CLOCK)

    def cost(self, sms: int) -> float:
        """Reckoned clocks of the call (:meth:`SlicedPlan.split_cost`)."""
        return self.split_cost(sms, self.stage_clocks())

    @property
    def weight_floats(self) -> int:
        """The weights' planes in the scratch: 9 O Cs floats a plane (Cs =
        C rounded up to ks), two planes at three passes."""
        cs = -(-self.c // self.ks) * self.ks
        return (2 if self.passes == 3 else 1) * 9 * self.o * cs

    def smem(self) -> tuple:
        """(ring stages, dynamic shared-memory bytes) of the launch, as
        csrc/conv3x3_rows.cu launch_rows reckons them: 1024 bytes of
        alignment, the bias (N floats), then as many stages (the box of x
        on whole KB, the weights' boxes on whole KB, two mbarriers) as fit,
        at most MAX_STAGES."""
        ks4 = 4 * self.ks
        a_slot = -(-(self.rows + 2) * (self.cols + 2) * ks4 // 1024) * 1024
        w = -(-9 * (2 if self.passes == 3 else 1) * self.n * ks4
              // 1024) * 1024
        fixed = 1024 + self.n * 4
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // (a_slot + w + 16))
        return stages, fixed + stages * (a_slot + w + 16)


@functools.lru_cache(maxsize=256)
def tf32_rows_plan(batch: int, height: int, width: int, c: int, o: int,
                   sms: int, passes: int = 3) -> RowsPlan:
    """The work split of an fp32 [batch, height, width, c] -> o conv (O <=
    ``TF32_ROWS_MAX_O``) on the rows design at `passes`: of the tile widths
    ``ROWS_COLS``, each with the K split that reckons least
    (:func:`_split_k`), the one whose reckoned clocks
    (:meth:`RowsPlan.cost`) are least, the narrowest on a tie; widths whose
    tiles would be under 8 rows tall are not taken (the kernel lands the
    box of x in 8-row pieces); one block per SM or one per unit where there
    are fewer."""
    if o > TF32_ROWS_MAX_O:
        raise ValueError(f"the rows design takes O <= {TF32_ROWS_MAX_O}; "
                         f"got O={o}")
    n = out_tile(o)
    phases = rows_phases(n, passes)
    best = None
    for cols in ROWS_COLS:
        if 128 * phases // cols < 8:
            continue
        plan = RowsPlan(batch, height, width, o, cols, n, 1, c,
                        tf32_slice_width(c), phases, passes)
        plan = _split_k(plan, sms, plan.stage_clocks())
        if best is None or plan.cost(sms) < best.cost(sms):
            best = plan
    return best


#: The narrow design (csrc/conv3x3.cu conv3x3_narrow_kernel): the widest C
#: it takes, its tile of output pixels (kNR x kNC) and its blocks per SM.
NARROW_MAX_C = 7
NARROW_ROWS, NARROW_COLS = 8, 32
NARROW_BLOCKS_PER_SM = 2


def narrow_tile_n(o: int) -> int:
    """The narrow kernel's output channels per tile: 8 where O <= 8, else
    64 (larger O tiles by 64 over the grid's y)."""
    return 8 if o <= 8 else 64


@dataclass(frozen=True)
class NarrowPlan:
    """The narrow kernel's work split for one call.

    A tile is ``NARROW_ROWS x NARROW_COLS`` output pixels of one image;
    ``grid`` persistent blocks per tile of ``n`` output channels take tiles
    ``bx, bx + grid, ...`` in the order of :meth:`tile`.
    """

    batch: int
    height: int
    width: int
    o: int
    n: int
    grid: int

    @property
    def strips(self) -> int:
        return -(-self.width // NARROW_COLS)

    @property
    def bands(self) -> int:
        return -(-self.height // NARROW_ROWS)

    @property
    def tiles(self) -> int:
        """Pixel tiles (each is taken once per channel tile)."""
        return self.batch * self.bands * self.strips

    @property
    def n_tiles(self) -> int:
        return -(-self.o // self.n)

    def tile(self, t: int):
        """(image, first output row, first output column) of tile ``t``:
        the kernel's ``narrow_tile`` (strip fastest, then band, image)."""
        x0 = (t % self.strips) * NARROW_COLS
        q = t // self.strips
        return q // self.bands, (q % self.bands) * NARROW_ROWS, x0

    def block_tiles(self, bx: int) -> range:
        return range(bx, self.tiles, self.grid)


@functools.lru_cache(maxsize=256)
def narrow_plan(batch: int, height: int, width: int, c: int, o: int,
                sms: int) -> NarrowPlan:
    """Channel tile and grid for a [batch, height, width, c] -> o conv with
    1 <= c <= 7 on a card with ``sms`` SMs: two blocks per SM in all (split
    over the channel tiles), or one per tile where there are fewer."""
    if not 1 <= c <= NARROW_MAX_C:
        raise ValueError(f"the narrow design takes 1 <= C <= "
                         f"{NARROW_MAX_C}; got C={c}")
    n = narrow_tile_n(o)
    plan = NarrowPlan(batch, height, width, o, n, 1)
    per_tile = max(1, NARROW_BLOCKS_PER_SM * sms // plan.n_tiles)
    return NarrowPlan(batch, height, width, o, n, min(plan.tiles, per_tile))


def _plain(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor], passes: int = 3) -> torch.Tensor:
    # Exact fp32 whatever `passes` says: the JAX package computes every
    # precision level alike on the CPU.
    xf = x.float()
    with exact_products(xf):  # no TF32 in the fp32 reference on the card
        out = F.conv2d(xf.permute(0, 3, 1, 2),
                       w.float().permute(3, 2, 0, 1), padding=1)
    if b is not None:
        out = out + b.float().reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _validate(name: str, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor], c64: bool, passes: int = 3) -> None:
    if x.dtype not in _CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if passes not in (1, 3):
        raise ValueError(f"{name}: passes must be 1 or 3; got {passes!r}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    c = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"{name}: w must be HWIO [3,3,{c},O]; got shape "
                         f"{tuple(w.shape)}")
    o = w.shape[-1]
    if c64 and c != _C64:
        raise ValueError(f"{name}: the kernel takes C={_C64}; got C={c}")
    if c64 and o > _C64:
        raise ValueError(f"{name}: the kernel takes O<={_C64}; got O={o}")
    for what, t in (("w", w), ("b", b)):
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{x.dtype} tensor on {x.device}")
    if b is not None and tuple(b.shape) != (o,):
        raise ValueError(f"{name}: b must have shape ({o},); got "
                         f"{tuple(b.shape)}")


#: The K splits every fp32 launch takes in place of its plan's, inside
#: :func:`forced_splits`; None: the plan's.
_FORCED_SPLITS: Optional[int] = None


@contextlib.contextmanager
def forced_splits(splits: int):
    """Inside, every fp32 launch splits each tile's K over `splits` blocks
    (at most one a K slice, :func:`with_splits`) whatever its plan chose:
    the card's tests and checks of the split walk at small shapes, and the
    timing of a plan's alternatives.  Not thread-safe."""
    global _FORCED_SPLITS
    before, _FORCED_SPLITS = _FORCED_SPLITS, splits
    try:
        yield
    finally:
        _FORCED_SPLITS = before


def plan_for(x: torch.Tensor, o: int, passes: int = 3):
    """The plan an fp32 call of the implicit-GEMM conv on x -> `o` output
    channels launches on x's card at `passes` (forced splits included)."""
    bb, h, wd, c = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if design(c, torch.float32, o, passes) == "tf32_rows":
        plan = tf32_rows_plan(bb, h, wd, c, o, sms, passes)
    else:
        plan = (tf32x3_plan if passes == 3 else tf32x1_plan)(bb, h, wd, c, o,
                                                             sms)
    if _FORCED_SPLITS is not None:
        plan = with_splits(plan, _FORCED_SPLITS, sms)
    return plan


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor], c64: bool,
            passes: int = 3) -> torch.Tensor:
    _validate(name, x, w, b, c64, passes)
    for what, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    bb, h, wd, c = x.shape
    o = w.shape[-1]
    y = torch.empty((bb, h, wd, o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rows = cols = n = ks = grid = 0  # the plan of a persistent design
    splits = 1  # the fp32 designs' K split
    ws = None  # the split-TF32 kernel's scratch
    kind = design(c, x.dtype, o, passes)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "streamed":
        plan = conv_plan(bb, h, wd, o, sms)
        rows, grid = plan.rows, plan.grid
    elif kind == "wide":
        plan = wide_plan(bb, h, wd, o, sms)
        cols, n, grid = plan.cols, plan.n, plan.grid
        if o % 8:
            # TMA needs a 16-byte row stride: zero-pad the channels to 8.
            wp = w.new_zeros(3, 3, c, -(-o // 8) * 8)
            wp[..., :o] = w
            w = wp
    elif kind == "narrow":
        plan = narrow_plan(bb, h, wd, c, o, sms)
        n, grid = plan.n, plan.grid
    elif kind == "sliced":
        plan = sliced_plan(bb, h, wd, c, o, sms)
        cols, n, ks, grid = plan.cols, plan.n, plan.ks, plan.grid
        # TMA needs 16-byte pixel and weight-row strides: zero-pad the
        # input channels (x and w; to a whole K slice) where C % 8 != 0 and
        # the output channels (w) to 8.
        cp = c if c % 8 == 0 else -(-c // ks) * ks
        ld = -(-o // 8) * 8
        if cp != c:
            x = F.pad(x, (0, cp - c))
        if (cp, ld) != (c, o):
            wp = w.new_zeros(3, 3, cp, ld)
            wp[:, :, :c, :o] = w
            w = wp
    elif kind == "tf32_rows":
        plan = plan_for(x, o, passes)
        # x padded to a 16-byte pixel stride, as below; ws: the weights'
        # planes in the rows order (kernels' split kernel), then the split
        # partials and their counters where splits > 1.
        cp = -(-c // 4) * 4
        if cp != c:
            x = F.pad(x, (0, cp - c))
        ws = torch.empty(plan.weight_floats + plan.workspace_bytes // 4,
                         dtype=torch.float32, device=x.device)
        err = _build.library().rr_conv3x3_rows(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), ws.data_ptr(), bb, h, wd, c, o, plan.cols, plan.n,
            plan.ks, plan.grid, plan.splits, passes,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, name)
        return y
    elif kind in ("tf32x3", "tf32x1"):
        plan = plan_for(x, o, passes)
        cols, n, ks, grid = plan.cols, plan.n, plan.ks, plan.grid
        splits = plan.splits
        if kind == "tf32x1":
            rows = plan.npx  # the C entry's `R`: pixels a warpgroup
        # TMA needs a 16-byte pixel stride: zero-pad x's channels to 4.  The
        # kernel splits the weights into the scratch ws [2][9][O][Cp] first
        # (one pass: only the rounded plane, [9][O][Cp]); the split
        # partials and their counters follow where splits > 1.
        cp = -(-c // 4) * 4
        if cp != c:
            x = F.pad(x, (0, cp - c))
        ws = torch.empty((18 if passes == 3 else 9) * o * cp
                         + plan.workspace_bytes // 4,
                         dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    scratch = None if ws is None else ws.data_ptr()
    lib = _build.library()
    if c64:
        err = lib.rr_conv3x3_c64(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                 bias, y.data_ptr(), scratch, bb, h, wd, o,
                                 rows, cols, n, ks, grid, splits, passes,
                                 stream)
    else:
        err = lib.rr_conv3x3(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                             bias, y.data_ptr(), scratch, bb, h, wd, c, o,
                             rows, cols, n, ks, grid, splits, passes, stream)
    _build.check(err, name)
    return y


def conv3x3_implicit_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                                b: Optional[torch.Tensor] = None,
                                passes: int = 3) -> torch.Tensor:
    """The plain PyTorch version: fp32 conv (no TF32), fp32 bias, one
    rounding to x's dtype, for either pass count."""
    _validate("conv3x3_implicit_gemm", x, w, b, False, passes)
    return _plain(x, w, b)


def conv3x3_implicit_gemm(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          passes: int = 3) -> torch.Tensor:
    """x: contiguous [B,H,W,C], any C; w: [3,3,C,O], any O; b: [O] or None.
    `passes`: the TF32 passes of an fp32 call on the card, 3
    (fp32-accurate) or 1 (ignored by 16-bit calls).

    Where grad mode is on and an operand requires grad, the call goes
    through :class:`Conv3x3Fn` (fp32 only); otherwise (``no_grad``,
    ``inference_mode``, constants) straight to the op."""
    _validate("conv3x3_implicit_gemm", x, w, b, False, passes)
    _check_device("conv3x3_implicit_gemm", x)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        if x.dtype != torch.float32:
            raise TypeError(f"conv3x3_implicit_gemm: the backward takes "
                            f"fp32 operands; got {x.dtype}")
        return Conv3x3Fn.apply(x, w, b, passes)
    return torch.ops.rerevst.conv3x3_implicit_gemm(x, w, b, passes)


class Conv3x3Fn(torch.autograd.Function):
    """The fp32 SAME 3x3 conv with its backward on the hand-written
    kernels, each gradient at the forward's `passes` and only where
    ``needs_input_grad`` asks for it: dx the forward kernel on g with the
    weights rotated 180 degrees and C and O swapped, dw ``conv3x3_wgrad``,
    db the sum of g over the pixels (fp32).  Once differentiable."""

    @staticmethod
    def forward(ctx, x, w, b, passes):
        ctx.save_for_backward(x, w)
        ctx.passes = passes
        return torch.ops.rerevst.conv3x3_implicit_gemm(x, w, b, passes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = torch.ops.rerevst.conv3x3_implicit_gemm(
                g, w.flip(0, 1).transpose(2, 3).contiguous(), None,
                ctx.passes)
        if need_w:
            dw = conv3x3_wgrad(x, g, ctx.passes)
        if need_b:
            db = g.sum((0, 1, 2))
        return dx, dw, db, None


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def _out_like(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None,
              passes: int = 3) -> torch.Tensor:
    """The output of the conv of x by w, uninitialized: [B,H,W,O] (the
    ops' fake)."""
    return x.new_empty(tuple(x.shape[:3]) + (w.shape[-1],))


def _implicit_gemm_cuda(x, w, b, passes=3):
    y = _launch("conv3x3_implicit_gemm", x, w, b, False, passes)
    if y.numel():
        with _build.COUNT_LOCK:
            conv3x3_implicit_gemm.launches += 1
            conv3x3_implicit_gemm.launches_by_design[
                design(x.shape[-1], x.dtype, w.shape[-1], passes)] += 1
            if x.dtype == torch.float32:
                key = tuple(x.shape) + (w.shape[-1], passes)
                conv3x3_implicit_gemm.launches_by_shape[key] = \
                    conv3x3_implicit_gemm.launches_by_shape.get(key, 0) + 1
    return y


_build.define_op("conv3x3_implicit_gemm(Tensor x, Tensor w, Tensor? b, "
                 "int passes=3) -> Tensor", _plain, _implicit_gemm_cuda,
                 _out_like)


def conv3x3_pairlane_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of the C = 64, O <= 64 conv (the same
    arithmetic as ``conv3x3_implicit_gemm_plain``)."""
    _validate("conv3x3_pairlane", x, w, b, c64=True)
    return _plain(x, w, b)


def conv3x3_pairlane(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: contiguous [B,H,W,64]; w: [3,3,64,O] with O <= 64; b: [O] or None."""
    _validate("conv3x3_pairlane", x, w, b, c64=True)
    _check_device("conv3x3_pairlane", x)
    return torch.ops.rerevst.conv3x3_pairlane(x, w, b)


def _pairlane_cuda(x, w, b):
    y = _launch("conv3x3_pairlane", x, w, b, c64=True)
    if y.numel():
        with _build.COUNT_LOCK:
            conv3x3_pairlane.launches += 1
    return y


_build.define_op("conv3x3_pairlane(Tensor x, Tensor w, Tensor? b) -> Tensor",
                 _plain, _pairlane_cuda, _out_like)


WGRAD_TW = 32  # csrc/conv3x3_wgrad.cu kTW: output pixels of a K tile
#: The mma.sync route's plan: blocks per SM its K split aims at (the kernel
#: keeps three resident: about three waves), and the K tiles a split sums
#: at least (where there are that many).
WGRAD_BLOCKS_PER_SM = 8
WGRAD_MIN_TILES = 4
#: The wgmma route's unit (csrc/conv3x3_wgrad.cu kTcM x kTcN): input x
#: output channels, all nine taps.
WGRAD_TC_TILE = (64, 32)


def wgrad_route(c: int, o: int, aligned: bool = True) -> str:
    """The weight-gradient kernel's route for C and O (the launcher's
    dispatch, csrc/conv3x3_wgrad.cu tc_route): "wgmma" where C >= 8, O >=
    8, both multiples of 4 (16-byte pixel strides for the tensor maps) and
    x and g 16-byte ``aligned``, else "mma" (mma.sync)."""
    ok = c >= 8 and o >= 8 and c % 4 == 0 and o % 4 == 0 and aligned
    return "wgmma" if ok else "mma"


def wgrad_tile(c: int, o: int, aligned: bool = True) -> tuple:
    """The weight-gradient kernel's unit (input channels, output channels)
    for C and O: the wgmma route's 64 x 32; on the mma.sync route 64 x 8
    where O <= 8, else 16 x 64."""
    if wgrad_route(c, o, aligned) == "wgmma":
        return WGRAD_TC_TILE
    return (64, 8) if o <= 8 else (16, 64)


@dataclass(frozen=True)
class WgradPlan:
    """The weight-gradient kernel's work split: output tiles of ``bm``
    input x ``bn`` output channels (all nine taps), each summed over the K
    tiles (row segments of ``WGRAD_TW`` output pixels of one image, in
    image, row, segment order) by ``splits`` blocks (on the wgmma route
    items of persistent blocks), split ``s`` taking the contiguous run
    :meth:`split_tiles`."""

    batch: int
    height: int
    width: int
    c: int
    o: int
    bm: int
    bn: int
    splits: int
    route: str = "mma"

    @property
    def strips(self) -> int:
        """K tiles in all."""
        return self.batch * self.height * -(-self.width // WGRAD_TW)

    @property
    def tiles(self) -> int:
        """Output tiles (units)."""
        return -(-self.c // self.bm) * -(-self.o // self.bn)

    def split_tiles(self, s: int) -> range:
        return range(s * self.strips // self.splits,
                     (s + 1) * self.strips // self.splits)

    def tile(self, q: int):
        """(image, output row, first output column) of K tile ``q``: the
        kernel's order (segment fastest, then row, image)."""
        segs = -(-self.width // WGRAD_TW)
        r = q // segs
        return r // self.height, r % self.height, (q % segs) * WGRAD_TW

    @property
    def k_split(self) -> int:
        """The most pixels one block sums (zero-filled ones included)."""
        return -(-self.strips // self.splits) * WGRAD_TW

    @property
    def workspace_bytes(self) -> int:
        """The partials' scratch (none at one split)."""
        return self.splits * 9 * self.c * self.o * 4 if self.splits > 1 else 0


@functools.lru_cache(maxsize=256)
def wgrad_plan(batch: int, height: int, width: int, c: int, o: int,
               sms: int, aligned: bool = True) -> WgradPlan:
    """Route, unit and K split of the weight gradient of a [batch, height,
    width, c] -> o conv on a card with ``sms`` SMs; with splits > 1 the
    partials are summed in split order through a workspace.

    wgmma route: one block an SM, so as many splits as keep units x splits
    within the SMs and no more than there are K tiles.  mma.sync route:
    enough splits for about ``WGRAD_BLOCKS_PER_SM`` blocks an SM over the
    output tiles, each split summing ``WGRAD_MIN_TILES`` K tiles or more
    where there are enough."""
    route = wgrad_route(c, o, aligned)
    bm, bn = wgrad_tile(c, o, aligned)
    plan = WgradPlan(batch, height, width, c, o, bm, bn, 1, route)
    if route == "wgmma":
        splits = min(sms // plan.tiles, plan.strips)
    else:
        splits = min(-(-WGRAD_BLOCKS_PER_SM * sms // plan.tiles),
                     plan.strips // WGRAD_MIN_TILES, 65535)
    return dataclasses.replace(plan, splits=max(1, splits))


def _validate_wgrad(x: torch.Tensor, g: torch.Tensor, passes: int) -> None:
    name = "conv3x3_wgrad"
    if passes not in (1, 3):
        raise ValueError(f"{name}: passes must be 1 or 3; got {passes!r}")
    for what, t in (("x", x), ("g", g)):
        if t.dtype != torch.float32 or t.dim() != 4 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous fp32 "
                             f"NHWC tensor; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tuple(g.shape[:3]) != tuple(x.shape[:3]) or g.device != x.device:
        raise ValueError(f"{name}: g must be [B,H,W,O] on x's device with "
                         f"x's [B,H,W] {tuple(x.shape[:3])}; got "
                         f"{tuple(g.shape)} on {g.device}")


def _wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                 passes: int = 3) -> torch.Tensor:
    # Exact fp32 whatever `passes` says, as _plain.
    c, o = x.shape[-1], g.shape[-1]
    with exact_products(x):
        dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (o, c, 3, 3),
                                         g.permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        passes: int = 3) -> torch.Tensor:
    """The plain PyTorch version: ``torch.nn.grad.conv2d_weight`` in exact
    fp32 (no TF32), laid out HWIO, for either pass count."""
    _validate_wgrad(x, g, passes)
    return _wgrad_plain(x, g)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  passes: int = 3) -> torch.Tensor:
    """The weight gradient of a SAME 3x3 conv of x: dw[ky,kx,c,o] =
    sum over the pixels of x_pad[n,h+ky,w+kx,c] g[n,h,w,o]; x contiguous
    fp32 [B,H,W,C], g contiguous fp32 [B,H,W,O] (the output's gradient) ->
    fp32 [3,3,C,O].  `passes`: the TF32 passes on the card, 3
    (fp32-accurate) or 1."""
    _validate_wgrad(x, g, passes)
    _check_device("conv3x3_wgrad", x)
    return torch.ops.rerevst.conv3x3_wgrad(x, g, passes)


def wgrad_plan_for(x: torch.Tensor, g: torch.Tensor) -> WgradPlan:
    """The plan ``conv3x3_wgrad`` launches for x and g on the card."""
    bb, h, wd, c = x.shape
    idx = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return wgrad_plan(bb, h, wd, c, g.shape[-1], sms,
                      x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)


def _wgrad_cuda(x, g, passes=3):
    _validate_wgrad(x, g, passes)
    bb, h, wd, c = x.shape
    o = g.shape[-1]
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_()  # no pixels: nothing to launch
    plan = wgrad_plan_for(x, g)
    ws = (torch.empty(plan.splits * 9 * c * o, dtype=torch.float32,
                      device=x.device) if plan.workspace_bytes else None)
    err = _build.library().rr_conv3x3_wgrad(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(),
        None if ws is None else ws.data_ptr(), bb, h, wd, c, o, plan.splits,
        passes, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_wgrad")
    with _build.COUNT_LOCK:
        conv3x3_wgrad.launches += 1
        key = (bb, h, wd, c, o)
        conv3x3_wgrad.launches_by_shape[key] = \
            conv3x3_wgrad.launches_by_shape.get(key, 0) + 1
    return dw


def _wgrad_like(x: torch.Tensor, g: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """The weight gradient's [3,3,C,O] fp32, uninitialized (the op's
    fake)."""
    return x.new_empty((3, 3, x.shape[-1], g.shape[-1]))


_build.define_op("conv3x3_wgrad(Tensor x, Tensor g, int passes=3) -> Tensor",
                 _wgrad_plain, _wgrad_cuda, _wgrad_like)


#: The kernel designs of csrc/conv3x3.cu and csrc/conv3x3_rows.cu, as
#: :func:`design` names them.
DESIGNS = ("streamed", "wide", "narrow", "sliced", "tf32x3", "tf32x1",
           "tf32_rows")

#: Kernel launches so far (CPU calls and empty inputs launch nothing); the
#: implicit-GEMM wrapper's also by design, and its fp32 launches by (B, H,
#: W, C, O, passes).
conv3x3_implicit_gemm.launches = 0
conv3x3_implicit_gemm.launches_by_design = dict.fromkeys(DESIGNS, 0)
conv3x3_implicit_gemm.launches_by_shape = {}
conv3x3_pairlane.launches = 0
#: The weight-gradient kernel's launches, also by (B, H, W, C, O).
conv3x3_wgrad.launches = 0
conv3x3_wgrad.launches_by_shape = {}
