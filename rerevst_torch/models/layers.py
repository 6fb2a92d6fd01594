"""Parameterized layers as functions over parameter dicts (NHWC) —
``rerevst_tpu/models/layers.py``.

Activations are contiguous NHWC tensors.  Convolutions permute them to
NCHW *views* — channels_last in memory — for ``F.conv2d``, and permute the
(channels_last) result back, so no activation is ever copied to another
layout.  Weights are HWIO at the API, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rerevst_torch.ops.resize import upsample_nearest_2x


def _fp32_products_exact(x: torch.Tensor) -> None:
    """fp32 storage means true fp32 products, the counterpart of the JAX
    package's HIGHEST precision.  cuDNN runs fp32 convolutions as TF32 while
    ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default), and
    cuBLAS does the same for matmuls under
    ``torch.backends.cuda.matmul.allow_tf32``; both are switched off for the
    process the first time an fp32 product runs on the card."""
    if x.is_cuda and x.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def from_torch_conv(weight_oihw, bias=None,
                    dtype: Optional[torch.dtype] = torch.float32):
    """torch Conv2d [O,I,kH,kW] -> HWIO param dict (`dtype` None keeps the
    stored dtype)."""
    p = {"w": torch.as_tensor(weight_oihw).permute(2, 3, 1, 0).contiguous()
         .to(dtype)}
    if bias is not None:
        p["b"] = torch.as_tensor(bias).to(dtype)
    return p


def from_torch_linear(weight_oi, bias=None,
                      dtype: Optional[torch.dtype] = torch.float32):
    """torch Linear [O,I] -> [I,O] param dict."""
    p = {"w": torch.as_tensor(weight_oi).T.contiguous().to(dtype)}
    if bias is not None:
        p["b"] = torch.as_tensor(bias).to(dtype)
    return p


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    # Free when the op kept channels_last; a copy only if it did not.
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0):
    """3x3/1x1 conv with torch-style symmetric zero padding; p['w'] is HWIO."""
    _fp32_products_exact(x)
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    b = p["b"].to(x.dtype) if "b" in p else None
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding))


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b with w as [in, out]."""
    _fp32_products_exact(x)
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=2, stride=2) on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def upsample2x_conv3x3(p, x: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_upsample_2x(x)).  The JAX package pre-sums the kernel
    into one input-dilated conv, a TPU layout choice; this computes the plain
    composition — the same function, reassociated."""
    return conv2d(p, upsample_nearest_2x(x), padding=1)


def upsample2x_conv1x1(p, x: torch.Tensor) -> torch.Tensor:
    """conv1x1(nearest_upsample_2x(x)), evaluated as the upsample of the 1x1
    conv: a pointwise conv commutes exactly with nearest upsampling."""
    return upsample_nearest_2x(conv2d(p, x))


def apply_dynamic_filter(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Per-sample predicted 1x1 conv: out[b,h,w,p] = sum_q x[b,h,w,q] f[b,p,q]
    with [B,P,Q] filters (per-frame mode), or a [1,P,Q] filter broadcast over
    the batch (the frozen filters of Pass 1; at B = 1 the same product).

    f16 guard: the frozen filters are unbounded FC outputs that f16's exponent
    cannot hold, so under f16 storage the operands are fp32 and only the
    output is rounded to f16."""
    _fp32_products_exact(x)
    if x.dtype == torch.float16:
        return apply_dynamic_filter(x.float(), filt.float()).to(x.dtype)
    f = filt.to(x.dtype)
    if f.shape[0] == 1:
        return x @ f[0].T
    return torch.einsum("bhwq,bpq->bhwp", x, f)


def apply_dynamic_filter_3x3(x: torch.Tensor,
                             filt: torch.Tensor) -> torch.Tensor:
    """Per-sample predicted 3x3 SAME conv (the KernelFilter_S ablation):
    out[b] = conv(x[b], filt[b]) with ``filt`` [B,P,Q,3,3] (or [1,P,Q,3,3]
    broadcast over the batch), ``filt[b]`` already OIHW with O = P, I = Q.
    One grouped conv, a group per sample.

    f16 guard as in ``apply_dynamic_filter``: the predicted kernels are
    unbounded FC outputs, so under f16 storage the conv runs in fp32 and
    only the output is rounded to f16."""
    if x.dtype == torch.float16:
        return apply_dynamic_filter_3x3(x.float(), filt.float()).to(x.dtype)
    _fp32_products_exact(x)
    b, h, w, q = x.shape
    f = filt.to(x.dtype)
    if f.shape[0] == 1 and b != 1:
        f = f.expand(b, *f.shape[1:])
    p = f.shape[1]
    y = F.conv2d(_nchw(x).reshape(1, b * q, h, w), f.reshape(b * p, q, 3, 3),
                 padding=1, groups=b)
    return y.reshape(b, p, h, w).permute(0, 2, 3, 1).contiguous()
