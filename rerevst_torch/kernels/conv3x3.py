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
one storage dtype.  The kernels are ``csrc/conv3x3.cu``: tensor-core products
for f16/bf16, fp32 CUDA-core FMAs for fp32.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build
from rerevst_torch.models.layers import _fp32_products_exact

_CODES = _build.DTYPE_CODES
_C64 = 64    # csrc/conv3x3.cu kC64
_TW = 128    # csrc/conv3x3.cu kTW: output pixels per row segment


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    lib = _build.library()
    if c64:
        segs = bb * h * -(-wd // _TW)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        err = lib.rr_conv3x3_c64(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                 bias, y.data_ptr(), bb, h, wd, o,
                                 min(segs, sms), stream)
    else:
        err = lib.rr_conv3x3(_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                             bias, y.data_ptr(), bb, h, wd, c, o, stream)
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
