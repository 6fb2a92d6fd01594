"""Frozen dynamic-filter pair: y = leaky_0.2(x . f1^T) . f2^T on rows of C.

The port of ``rerevst_tpu/kernels/filter_chain.py:dynamic_filter_pair`` — the
middle of the global decoder's ``_kernel_filter_frozen``, between the 512->32
``down`` conv and the 32->512 ``up`` conv, three times per decode.  The kernel
is ``csrc/filter_chain.cu``: tensor-core products (mma.sync TF32) made
fp32-accurate by a hi/lo split, both filters fp32 in every storage dtype and
the intermediate fp32 in registers, never in memory; its persistent grid
takes 16-row tiles as :func:`row_plan` splits them.  A CUDA tensor launches
the kernel (or the wrapper raises); a CPU tensor takes the plain version.

The filters are shared, ``[1,C,C]``, or per sample, ``[B,C,C]`` with B
equal to x's leading dim (multi-style blending gives each frame its own).
On the card the per-sample case launches the kernel once per sample, on
that sample's slice of x with its own filters, each launch counted; the
plain version multiplies batch by batch.

The wrapper reaches both through the ``rerevst::dynamic_filter_pair``
``torch.library`` op: its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and its fake implementation gives the
output's shape alone, so that ``torch.export`` captures the op as one node.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build
from rerevst_torch.ops.precision import exact_products

_CODES = _build.DTYPE_CODES
_C = 32          # csrc/filter_chain.cu kC
TILE_ROWS = 16   # csrc/filter_chain.cu kTileRows: rows per mma tile
WARPS = 8        # csrc/filter_chain.cu kWarps: warps per block


@dataclass(frozen=True)
class RowPlan:
    """The kernel's split of ``rows`` rows over ``grid`` persistent blocks.

    Rows go in tiles of ``TILE_ROWS`` (the last one ragged); block ``bx``
    takes a contiguous share of whole tiles, and its ``WARPS`` warps take
    that share's tiles in turn.
    """

    rows: int
    grid: int

    @property
    def tiles(self) -> int:
        return -(-self.rows // TILE_ROWS)

    def block_tiles(self, bx: int) -> range:
        """The kernel's ``[bx T / grid, (bx + 1) T / grid)``."""
        return range(bx * self.tiles // self.grid,
                     (bx + 1) * self.tiles // self.grid)

    def warp_tiles(self, bx: int, warp: int) -> range:
        share = self.block_tiles(bx)
        return range(share.start + warp, share.stop, WARPS)

    def tile_rows(self, tile: int) -> range:
        """The rows of ``tile`` that exist (the kernel reads and writes no
        other)."""
        return range(tile * TILE_ROWS, min((tile + 1) * TILE_ROWS, self.rows))


def row_plan(rows: int, sms: int) -> RowPlan:
    """One block per SM (the kernel's registers allow no second), never more
    blocks than tiles."""
    return RowPlan(rows, min(-(-rows // TILE_ROWS), sms))


def _filters(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A shared filter as [1,C,C] or per-sample filters as [B,C,C]."""
    c = x.shape[-1]
    if f.shape in ((1, c, c), (c, c)):
        return f.reshape(1, c, c)
    if x.dim() > 1 and f.shape == (x.shape[0], c, c):
        return f
    raise ValueError(
        f"dynamic_filter_pair takes one shared [1,{c},{c}] filter or "
        f"per-sample [B,{c},{c}] filters with B = x's leading dim "
        f"{x.shape[0]}; got shape {tuple(f.shape)}")


def dynamic_filter_pair_plain(x: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: fp32 operands and intermediate, output
    rounded once to x's dtype."""
    c = x.shape[-1]
    a, b = _filters(f1, x).float(), _filters(f2, x).float()
    if a.shape[0] == b.shape[0] == 1:
        xf = x.reshape(-1, c).float()
        a, b = a[0], b[0]
    else:
        xf = x.reshape(x.shape[0], -1, c).float()
    with exact_products(xf):
        h = F.leaky_relu(xf @ a.transpose(-1, -2), 0.2)
        y = h @ b.transpose(-1, -2)
    return y.to(x.dtype).reshape(x.shape)


def dynamic_filter_pair(x: torch.Tensor, f1: torch.Tensor,
                        f2: torch.Tensor) -> torch.Tensor:
    """x: contiguous [..., C]; f1, f2: shared [1,C,C] (or [C,C]) filters, or
    per-sample [B,C,C] ones, with out_p = sum_q h_q f[p, q]."""
    if x.dtype not in _CODES:
        raise TypeError(f"dynamic_filter_pair: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dynamic_filter_pair: x must be contiguous NHWC")
    for f in (f1, f2):
        _filters(f, x)  # raises on a shape the op does not take
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dynamic_filter_pair: no kernel for {x.device}")
    return torch.ops.rerevst.dynamic_filter_pair(x, f1, f2)


def _fake(x, f1, f2):
    return torch.empty_like(x)


def _cuda(x, f1, f2):
    c = x.shape[-1]
    if c != _C:
        raise ValueError(f"dynamic_filter_pair: the kernel takes C={_C}, "
                         f"got {c}")
    if not x.is_contiguous():
        raise ValueError("dynamic_filter_pair: x must be contiguous NHWC")
    a, b = _filters(f1, x), _filters(f2, x)
    for name, f in (("f1", a), ("f2", b)):
        if f.dtype != torch.float32 or f.device != x.device \
                or not f.is_contiguous():
            raise ValueError(f"dynamic_filter_pair: {name} must be a "
                             f"contiguous fp32 tensor on {x.device}")
    for name, t in (("x", x), ("f1", a), ("f2", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"dynamic_filter_pair: {name} must be 16-byte "
                             f"aligned")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if a.shape[0] == b.shape[0] == 1:
        _launch(x, y, a, b)
        return y
    for i in range(x.shape[0]):
        _launch(x[i], y[i], a[i if a.shape[0] > 1 else 0],
                b[i if b.shape[0] > 1 else 0])
    return y


_build.define_op(
    "dynamic_filter_pair(Tensor x, Tensor f1, Tensor f2) -> Tensor",
    dynamic_filter_pair_plain, _cuda, _fake)


def _launch(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> None:
    """One kernel launch over contiguous x -> y with one filter pair."""
    rows = x.numel() // _C
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = row_plan(rows, sms)
    err = _build.library().rr_filter_pair(
        _CODES[x.dtype], x.data_ptr(), y.data_ptr(), rows, a.data_ptr(),
        b.data_ptr(), plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dynamic_filter_pair")
    with _build.COUNT_LOCK:
        dynamic_filter_pair.launches += 1


#: Kernel launches so far (CPU calls and empty inputs launch nothing).
dynamic_filter_pair.launches = 0
