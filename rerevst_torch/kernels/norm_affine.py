"""Frozen-statistics normalize + clamp (+ style affine), one pass over NHWC.

The port of ``rerevst_tpu/kernels/norm_affine.py:norm_affine_clamp`` — the
function the global decoder evaluates at all 11 of its ``_norm_apply`` sites:

    v = leaky_relu(x, 0.2) if leaky else x
    y = clip((v - mean) * rstd, xmin, xmax)            per channel, in fp32
    y = y * style_std + style_mean                     if a style affine is given

stored once in x's dtype.  The kernel is ``csrc/norm_affine.cu``; the plain
PyTorch version below has the same arithmetic, step for step.  A CUDA tensor
launches the kernel (or the wrapper raises); a CPU tensor takes the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build

_CODES = _build.DTYPE_CODES
_THREADS = 256  # csrc/norm_affine.cu kThreads


def _vec(t: torch.Tensor, c: int) -> torch.Tensor:
    return t.reshape(c).to(torch.float32)


def norm_affine_clamp_plain(x: torch.Tensor, st,
                            style_std: Optional[torch.Tensor] = None,
                            style_mean: Optional[torch.Tensor] = None,
                            leaky: bool = False) -> torch.Tensor:
    """The plain PyTorch version: same semantics and the same fp32 steps."""
    c = x.shape[-1]
    v = x.to(torch.float32)
    if leaky:
        v = F.leaky_relu(v, 0.2)
    t = (v - _vec(st.mean, c)) * _vec(st.rstd, c)
    t = torch.minimum(torch.maximum(t, _vec(st.xmin, c)), _vec(st.xmax, c))
    if style_std is not None:
        t = t * _vec(style_std, c) + _vec(style_mean, c)
    return t.to(x.dtype)


def _validate(x: torch.Tensor, st, style_std, style_mean) -> None:
    if x.dtype not in _CODES:
        raise TypeError(f"norm_affine_clamp: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("norm_affine_clamp: x must be contiguous NHWC")
    c = x.shape[-1]
    for name in ("mean", "rstd", "xmin", "xmax"):
        v = getattr(st, name)
        if v.numel() != c:
            raise ValueError(f"norm_affine_clamp: stats.{name} has {v.numel()}"
                             f" values for {c} channels")
        if v.dtype != torch.float32 or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"norm_affine_clamp: stats.{name} must be a "
                             f"contiguous fp32 tensor on {x.device}")
    if (style_std is None) != (style_mean is None):
        raise ValueError("norm_affine_clamp: pass both style_std and "
                         "style_mean, or neither")
    if style_std is not None:
        for name, v in (("style_std", style_std), ("style_mean", style_mean)):
            if v.numel() != c:
                raise ValueError(
                    f"norm_affine_clamp: {name} must be one shared [1,1,1,C] "
                    f"affine; got shape {tuple(v.shape)} for {c} channels")
            if v.dtype not in _CODES or v.device != x.device \
                    or not v.is_contiguous():
                raise ValueError(f"norm_affine_clamp: {name} must be a "
                                 f"contiguous float tensor on {x.device}")
        if style_std.dtype != style_mean.dtype:
            raise ValueError("norm_affine_clamp: style_std and style_mean "
                             "differ in dtype")


def norm_affine_clamp(x: torch.Tensor, st,
                      style_std: Optional[torch.Tensor] = None,
                      style_mean: Optional[torch.Tensor] = None,
                      leaky: bool = False) -> torch.Tensor:
    """x: contiguous [..., C]; st: NormStats of fp32 [1,1,1,C] tensors;
    style_std/style_mean: one shared [1,1,1,C] affine, or None for the
    identity; leaky: apply leaky_relu(0.2) to x first."""
    _validate(x, st, style_std, style_mean)
    if x.device.type == "cpu":
        return norm_affine_clamp_plain(x, st, style_std, style_mean, leaky)
    if x.device.type != "cuda":
        raise ValueError(f"norm_affine_clamp: no kernel for {x.device}")
    c = x.shape[-1]
    v = 16 // x.element_size()
    if c % v or c // v > _THREADS:
        raise ValueError(f"norm_affine_clamp: the kernel takes C divisible by "
                         f"{v} and at most {_THREADS * v}; got C={c}")
    if x.data_ptr() % 16:
        raise ValueError("norm_affine_clamp: x must be 16-byte aligned")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    rows_per_block = _THREADS // (c // v)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-rows // rows_per_block), sms * (2048 // _THREADS))
    affine = 0 if style_std is None else _CODES[style_std.dtype]
    err = _build.library().rr_norm_affine(
        _CODES[x.dtype], affine, int(leaky), x.data_ptr(), y.data_ptr(),
        rows, c, st.mean.data_ptr(), st.rstd.data_ptr(), st.xmin.data_ptr(),
        st.xmax.data_ptr(), style_std.data_ptr() if affine else None,
        style_mean.data_ptr() if affine else None, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "norm_affine_clamp")
    norm_affine_clamp.launches += 1
    return y


#: Kernel launches so far (CPU calls and empty inputs launch nothing).
norm_affine_clamp.launches = 0
