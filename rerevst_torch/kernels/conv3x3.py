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
one storage dtype.  The kernels are ``csrc/conv3x3.cu``: for f16/bf16 with
C = 64 (both entry points) the streamed TMA + wgmma design, whose work
split :func:`conv_plan` computes here; for f16/bf16 with other C the
cp.async implicit GEMM; for fp32 CUDA-core FMAs.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build
from rerevst_torch.models.layers import _fp32_products_exact

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


def _plain(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    _fp32_products_exact(xf)  # no TF32 in the fp32 reference on the card
    out = F.conv2d(xf.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
    if b is not None:
        out = out + b.float().reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _validate(name: str, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor], c64: bool) -> None:
    if x.dtype not in _CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
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


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor], c64: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for what, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    bb, h, wd, c = x.shape
    o = w.shape[-1]
    y = torch.empty((bb, h, wd, o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rows = grid = 0  # read only by the streamed kernel (16-bit, C = 64)
    if c == _C64 and x.dtype != torch.float32:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = conv_plan(bb, h, wd, o, sms)
        rows, grid = plan.rows, plan.grid
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    lib = _build.library()
    if c64:
        err = lib.rr_conv3x3_c64(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                 bias, y.data_ptr(), bb, h, wd, o, rows, grid,
                                 stream)
    else:
        err = lib.rr_conv3x3(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                             bias, y.data_ptr(), bb, h, wd, c, o, rows, grid,
                             stream)
    _build.check(err, name)
    return y


def conv3x3_implicit_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                                b: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version: fp32 conv (no TF32), fp32 bias, one
    rounding to x's dtype."""
    _validate("conv3x3_implicit_gemm", x, w, b, c64=False)
    return _plain(x, w, b)


def conv3x3_implicit_gemm(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: contiguous [B,H,W,C], any C; w: [3,3,C,O], any O; b: [O] or None."""
    _validate("conv3x3_implicit_gemm", x, w, b, c64=False)
    if x.device.type == "cpu":
        return _plain(x, w, b)
    y = _launch("conv3x3_implicit_gemm", x, w, b, c64=False)
    if y.numel():
        conv3x3_implicit_gemm.launches += 1
    return y


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
    if x.device.type == "cpu":
        return _plain(x, w, b)
    y = _launch("conv3x3_pairlane", x, w, b, c64=True)
    if y.numel():
        conv3x3_pairlane.launches += 1
    return y


#: Kernel launches so far (CPU calls and empty inputs launch nothing).
conv3x3_implicit_gemm.launches = 0
conv3x3_pairlane.launches = 0
