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

The conditioning (each statistic and the style affine) is either shared,
``[1,1,1,C]``, or per sample, ``[B,1,1,C]`` with B equal to x's leading dim
(multi-style blending gives each frame its own).  On the card the
per-sample case launches the kernel once per sample, on that sample's slice
of x (contiguous in NHWC) with its own conditioning, each launch counted;
the plain version broadcasts.

The wrapper reaches both through the ``rerevst::norm_affine_clamp``
``torch.library`` op, which dispatches by device: its CUDA implementation
launches the kernel, its CPU implementation is the plain version, and its
fake implementation gives the output's shape alone, so that
``torch.export`` captures the op as one node of a graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import _build

_CODES = _build.DTYPE_CODES
_THREADS = 256  # csrc/norm_affine.cu kThreads


class _Stats(NamedTuple):
    """The four frozen statistics as the op passes them (the fields of
    ``models.transformer.NormStats``)."""
    mean: torch.Tensor
    rstd: torch.Tensor
    xmin: torch.Tensor
    xmax: torch.Tensor


def _per_sample(t: Optional[torch.Tensor], x: torch.Tensor) -> bool:
    """True for a [B,1,1,C] tensor with B > 1 (x's leading dim B)."""
    return t is not None and t.numel() != x.shape[-1]


def _vec(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A conditioning tensor as fp32, shaped to broadcast against x."""
    c = x.shape[-1]
    if _per_sample(t, x):
        return t.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (c,)) \
            .to(torch.float32)
    return t.reshape(c).to(torch.float32)


def norm_affine_clamp_plain(x: torch.Tensor, st,
                            style_std: Optional[torch.Tensor] = None,
                            style_mean: Optional[torch.Tensor] = None,
                            leaky: bool = False) -> torch.Tensor:
    """The plain PyTorch version: same semantics and the same fp32 steps."""
    v = x.to(torch.float32)
    if leaky:
        v = F.leaky_relu(v, 0.2)
    t = (v - _vec(st.mean, x)) * _vec(st.rstd, x)
    t = torch.minimum(torch.maximum(t, _vec(st.xmin, x)), _vec(st.xmax, x))
    if style_std is not None:
        t = t * _vec(style_std, x) + _vec(style_mean, x)
    return t.to(x.dtype)


def _check_shape(name: str, v: torch.Tensor, x: torch.Tensor) -> None:
    """One shared [1,1,1,C] or one per-sample [B,1,1,C] conditioning."""
    c, b = x.shape[-1], x.shape[0] if x.dim() > 1 else 1
    if v.numel() == c or (x.dim() > 1 and v.numel() == b * c
                          and v.shape[0] == b):
        return
    raise ValueError(f"norm_affine_clamp: {name} must be a shared [1,1,1,C] "
                     f"or a per-sample [B,1,1,C] tensor for x of shape "
                     f"{tuple(x.shape)}; got shape {tuple(v.shape)} for {c} "
                     f"channels")


def _validate(x: torch.Tensor, st, style_std, style_mean) -> None:
    if x.dtype not in _CODES:
        raise TypeError(f"norm_affine_clamp: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("norm_affine_clamp: x must be contiguous NHWC")
    for name in ("mean", "rstd", "xmin", "xmax"):
        v = getattr(st, name)
        _check_shape(f"stats.{name}", v, x)
        if v.dtype != torch.float32 or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"norm_affine_clamp: stats.{name} must be a "
                             f"contiguous fp32 tensor on {x.device}")
    if (style_std is None) != (style_mean is None):
        raise ValueError("norm_affine_clamp: pass both style_std and "
                         "style_mean, or neither")
    if style_std is not None:
        for name, v in (("style_std", style_std), ("style_mean", style_mean)):
            _check_shape(name, v, x)
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
    """x: contiguous [..., C]; st: NormStats of fp32 tensors; style_std /
    style_mean: the style affine, or None for the identity; each
    conditioning tensor shared [1,1,1,C] or per sample [B,1,1,C];
    leaky: apply leaky_relu(0.2) to x first."""
    _validate(x, st, style_std, style_mean)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"norm_affine_clamp: no kernel for {x.device}")
    return torch.ops.rerevst.norm_affine_clamp(
        x, st.mean, st.rstd, st.xmin, st.xmax, style_std, style_mean, leaky)


def _cpu(x, mean, rstd, xmin, xmax, style_std, style_mean, leaky):
    return norm_affine_clamp_plain(x, _Stats(mean, rstd, xmin, xmax),
                                   style_std, style_mean, leaky)


def _fake(x, mean, rstd, xmin, xmax, style_std, style_mean, leaky):
    return torch.empty_like(x)


def _cuda(x, mean, rstd, xmin, xmax, style_std, style_mean, leaky):
    c = x.shape[-1]
    v = 16 // x.element_size()
    if c % v or c // v > _THREADS:
        raise ValueError(f"norm_affine_clamp: the kernel takes C divisible by "
                         f"{v} and at most {_THREADS * v}; got C={c}")
    if not x.is_contiguous():
        raise ValueError("norm_affine_clamp: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError("norm_affine_clamp: x must be 16-byte aligned")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    cond = (mean, rstd, xmin, xmax, style_std, style_mean)
    if not any(_per_sample(t, x) for t in cond):
        _launch(x, y, cond, leaky)
        return y
    for b in range(x.shape[0]):
        _launch(x[b], y[b], [t[b] if _per_sample(t, x) else t for t in cond],
                leaky)
    return y


_build.define_op(
    "norm_affine_clamp(Tensor x, Tensor mean, Tensor rstd, Tensor xmin, "
    "Tensor xmax, Tensor? style_std, Tensor? style_mean, bool leaky) "
    "-> Tensor", _cpu, _cuda, _fake)


def _launch(x: torch.Tensor, y: torch.Tensor, cond, leaky: bool) -> None:
    """One kernel launch over contiguous x -> y with shared conditioning."""
    mean, rstd, xmin, xmax, s, m = cond
    c = x.shape[-1]
    rows = x.numel() // c
    rows_per_block = _THREADS // (c // (16 // x.element_size()))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-rows // rows_per_block), sms * (2048 // _THREADS))
    affine = 0 if s is None else _CODES[s.dtype]
    err = _build.library().rr_norm_affine(
        _CODES[x.dtype], affine, int(leaky), x.data_ptr(), y.data_ptr(),
        rows, c, mean.data_ptr(), rstd.data_ptr(), xmin.data_ptr(),
        xmax.data_ptr(), s.data_ptr() if affine else None,
        m.data_ptr() if affine else None, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "norm_affine_clamp")
    with _build.COUNT_LOCK:
        norm_affine_clamp.launches += 1


#: Kernel launches so far (CPU calls and empty inputs launch nothing).
norm_affine_clamp.launches = 0
