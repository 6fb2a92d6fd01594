"""Frozen dynamic-filter pair: y = leaky_0.2(x . f1^T) . f2^T on rows of C.

The port of ``rerevst_tpu/kernels/filter_chain.py:dynamic_filter_pair`` — the
middle of the global decoder's ``_kernel_filter_frozen``, between the 512->32
``down`` conv and the 32->512 ``up`` conv, three times per decode.  The kernel
is ``csrc/filter_chain.cu``: both filters stay fp32 in every storage dtype and
the intermediate stays fp32 in shared memory, never in device memory.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build
from rerevst_torch.models.layers import _fp32_products_exact

_CODES = _build.DTYPE_CODES
_C = 32          # csrc/filter_chain.cu kC
_TILE = 128      # csrc/filter_chain.cu kTile: rows per block per step
_BLOCKS_PER_SM = 2  # csrc/filter_chain.cu __launch_bounds__


def _square(f: torch.Tensor, c: int) -> torch.Tensor:
    if f.shape not in ((1, c, c), (c, c)):
        raise ValueError(
            f"dynamic_filter_pair takes one shared [1,{c},{c}] filter; got "
            f"shape {tuple(f.shape)} (per-sample filters are not supported)")
    return f.reshape(c, c)


def dynamic_filter_pair_plain(x: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: fp32 operands and intermediate, output
    rounded once to x's dtype."""
    c = x.shape[-1]
    a, b = _square(f1, c).float(), _square(f2, c).float()
    xf = x.reshape(-1, c).float()
    _fp32_products_exact(xf)
    h = F.leaky_relu(xf @ a.T, 0.2)
    return (h @ b.T).to(x.dtype).reshape(x.shape)


def dynamic_filter_pair(x: torch.Tensor, f1: torch.Tensor,
                        f2: torch.Tensor) -> torch.Tensor:
    """x: contiguous [..., C]; f1, f2: shared [1,C,C] (or [C,C]) filters with
    out_p = sum_q h_q f[p, q]."""
    if x.dtype not in _CODES:
        raise TypeError(f"dynamic_filter_pair: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dynamic_filter_pair: x must be contiguous NHWC")
    c = x.shape[-1]
    a, b = _square(f1, c), _square(f2, c)
    if x.device.type == "cpu":
        return dynamic_filter_pair_plain(x, f1, f2)
    if x.device.type != "cuda":
        raise ValueError(f"dynamic_filter_pair: no kernel for {x.device}")
    if c != _C:
        raise ValueError(f"dynamic_filter_pair: the kernel takes C={_C}, "
                         f"got {c}")
    if x.data_ptr() % 16:
        raise ValueError("dynamic_filter_pair: x must be 16-byte aligned")
    for name, f in (("f1", a), ("f2", b)):
        if f.dtype != torch.float32 or f.device != x.device \
                or not f.is_contiguous():
            raise ValueError(f"dynamic_filter_pair: {name} must be a "
                             f"contiguous fp32 tensor on {x.device}")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # Persistent: as many blocks as fit on the card at once
    # (__launch_bounds__(256, 2)), each staging the filters once.
    grid = min(-(-rows // _TILE), sms * _BLOCKS_PER_SM)
    err = _build.library().rr_filter_pair(
        _CODES[x.dtype], x.data_ptr(), y.data_ptr(), rows, a.data_ptr(),
        b.data_ptr(), grid, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dynamic_filter_pair")
    dynamic_filter_pair.launches += 1
    return y


#: Kernel launches so far (CPU calls and empty inputs launch nothing).
dynamic_filter_pair.launches = 0
