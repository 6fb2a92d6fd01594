"""Parameterized layers as functions over parameter dicts (NHWC) —
``rerevst_tpu/models/layers.py``.

Activations are contiguous NHWC tensors.  Convolutions permute them to
NCHW *views* — channels_last in memory — for ``F.conv2d``, and permute the
(channels_last) result back, so no activation is ever copied to another
layout.  Weights are HWIO at the API, as in the JAX package.

The convs take a ``precision`` level (``ops/precision.py``), as the JAX
package's take a ``lax.Precision``: on the card the fp32 3x3 SAME convs at
'high' and 'default' run the ``conv3x3_implicit_gemm`` kernel (three or one
TF32 passes), forward and, under autograd, backward (its input gradient on
the same kernel, its weight gradient on ``conv3x3_wgrad``), and every other
product is the library's, exact in fp32.
``None`` is 'highest'.  ``linear`` and the dynamic filters are exact in
fp32 at every level, so they take none.

The initializers draw from an explicit ``torch.Generator`` (the JAX
package's PRNG key), on the generator's device, with the JAX package's
distributions: normal(0, 0.02) weights and zero bias for the decoder, and
torch's ``nn.Conv2d`` default (kaiming-uniform a=sqrt(5), fan-in uniform
bias) for the VGG scheme 'torch'.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from rerevst_torch.kernels import conv3x3_implicit_gemm
from rerevst_torch.ops import halo
from rerevst_torch.ops.precision import exact_products, tf32_passes
# A public name of rerevst_tpu.models.layers, kept here for its callers.
from rerevst_torch.ops.precision import precision_for  # noqa: F401
from rerevst_torch.ops.resize import upsample_nearest_2x


def init_conv_normal(gen: torch.Generator, kh: int, kw: int, cin: int,
                     cout: int, gain: float = 0.02, bias: bool = True,
                     dtype: torch.dtype = torch.float32):
    """normal(0, gain) HWIO weights, zero bias — the reference decoder's
    init."""
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device,
                    dtype=dtype) * gain
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=gen.device)
    return p


def init_conv_torch_default(gen: torch.Generator, kh: int, kw: int,
                            cin: int, cout: int, bias: bool = True,
                            dtype: torch.dtype = torch.float32):
    """torch ``nn.Conv2d``'s default init (kaiming-uniform a=sqrt(5), fan-in
    uniform bias), HWIO."""
    fan_in = kh * kw * cin
    bound = math.sqrt(6.0 / ((1 + 5.0) * fan_in))  # gain^2 = 2/(1+a^2)
    w = torch.empty((kh, kw, cin, cout), dtype=dtype, device=gen.device)
    p = {"w": w.uniform_(-bound, bound, generator=gen)}
    if bias:
        bb = 1.0 / math.sqrt(fan_in)
        b = torch.empty((cout,), dtype=dtype, device=gen.device)
        p["b"] = b.uniform_(-bb, bb, generator=gen)
    return p


def init_linear_normal(gen: torch.Generator, cin: int, cout: int,
                       gain: float = 0.02,
                       dtype: torch.dtype = torch.float32):
    """normal(0, gain) ``[in, out]`` weights, zero bias."""
    w = torch.randn((cin, cout), generator=gen, device=gen.device,
                    dtype=dtype) * gain
    return {"w": w, "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


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


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0,
           precision: Optional[str] = None):
    """3x3/1x1 conv with torch-style symmetric zero padding; p['w'] is HWIO,
    cast to x's dtype (the region's, not the session's).

    A 3x3 SAME conv (stride 1, padding 1) of fp32 operands at `precision`
    'high' or 'default' runs the ``conv3x3_implicit_gemm`` op: on the card
    its kernel with three or one TF32 passes, on the CPU its plain version.
    Where autograd needs a gradient the call goes through
    ``kernels.conv3x3.Conv3x3Fn``, whose backward runs the hand-written
    kernels at the same passes (under ``no_grad`` and ``inference_mode``
    the op alone).  Every other conv is the library's, exact in fp32.

    On an H shard of Pass 2 (``ops/halo.py``) the H padding of a conv taller
    than one row comes from the neighbouring shards' rows instead of
    zeros."""
    passes = (tf32_passes(x, precision) if stride == 1 and padding == 1
              and tuple(p["w"].shape[:2]) == (3, 3) else 0)
    if passes:
        wk, bk = weights_as(p, x.dtype)
        return halo.same_conv(
            lambda v: conv3x3_implicit_gemm(v.contiguous(), wk.contiguous(),
                                            None if bk is None
                                            else bk.contiguous(), passes), x)
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    b = p["b"].to(x.dtype) if "b" in p else None
    pad = padding
    if padding and w.shape[2] > 1:
        ctx = halo.current()
        if ctx is not None:
            x = ctx.exchange_rows(x, padding)
            pad = (0, padding)
    with exact_products(x):
        y = F.conv2d(_nchw(x), w, b, stride=stride, padding=pad)
    return _nhwc(y)


def weights_as(p, dtype: torch.dtype):
    """(w, b or None) of a conv's params cast to `dtype`, for the kernels,
    which take operands of one dtype (a session keeps the checkpoint's
    stored dtype)."""
    b = p.get("b")
    return p["w"].to(dtype), None if b is None else b.to(dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b with w as [in, out]; exact in fp32, whatever the config's
    precision (cuBLAS has no three-pass TF32), so it takes none."""
    with exact_products(x):
        return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=2, stride=2) on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def upsample2x_conv3x3(p, x: torch.Tensor,
                       precision: Optional[str] = None) -> torch.Tensor:
    """conv3x3(nearest_upsample_2x(x)) without the 2x intermediate: each
    output parity (a, b) reads a 2x2 window of `x` with the 3x3 taps
    pre-summed, so one 2x2 conv over the zero-padded input gives the four
    parities as channel groups, which interleave into the 2x output.  The
    same function, its taps reassociated, at 4/9 of the products.

    The taps are summed as the JAX package sums them: into the 4x4 "spread"
    kernel K = full-conv(W, ones(2, 2)), adding W at the offsets (0, 0),
    (0, 1), (1, 0), (1, 1) in that order, in the weight's own dtype (a bf16
    checkpoint's weights are summed in bf16, as ``rerevst_tpu``'s session
    sums them); parity (a, b) takes the taps K[a::2, b::2].  The conv then
    runs in x's dtype.

    The plain composition (upsample, then the 3x3 conv) is not used: cuDNN
    ran that fp32 conv at [4, 256, 128, 128] -> 128, the decoder's
    res3.conv1 in a train step of 256x256 crops, as an FFT of 33024
    launches, over 300 ms against 0.73 ms for this form on an H100
    (PERF.md section 6).  A transposed conv of the spread 4x4 kernel was faster still,
    but cuDNN's algorithms for it accumulate in another order from run to
    run, forward and backward."""
    n, h, w, _ = x.shape
    wt = p["w"]  # [3, 3, Cin, Cout]
    cin, o = wt.shape[2:]
    spread = wt.new_zeros((4, 4, cin, o))
    for t1 in (0, 1):
        for t2 in (0, 1):
            spread[t1:t1 + 3, t2:t2 + 3] += wt
    # K[a + 2t, b + 2u] is tap (t, u) of parity (a, b): dims (t, a, u, b).
    k = spread.reshape(2, 2, 2, 2, cin, o).permute(0, 2, 4, 1, 3, 5) \
        .reshape(2, 2, cin, 4 * o)  # output channels ordered (a, b, Cout)
    kp = {"w": k}
    if "b" in p:
        kp["b"] = p["b"].repeat(4)
    y = conv2d(kp, x, padding=1, precision=precision)  # [N,H+1,W+1,4 O]
    y = y.reshape(n, h + 1, w + 1, 2, 2, o)
    out = torch.stack([torch.stack([y[:, a:a + h, c:c + w, a, c]
                                    for c in (0, 1)], 3) for a in (0, 1)], 2)
    return out.reshape(n, 2 * h, 2 * w, o)


def upsample2x_conv1x1(p, x: torch.Tensor,
                       precision: Optional[str] = None) -> torch.Tensor:
    """conv1x1(nearest_upsample_2x(x)), evaluated as the upsample of the 1x1
    conv: a pointwise conv commutes exactly with nearest upsampling."""
    return upsample_nearest_2x(conv2d(p, x, precision=precision))


def apply_dynamic_filter(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Per-sample predicted 1x1 conv: out[b,h,w,p] = sum_q x[b,h,w,q] f[b,p,q]
    with [B,P,Q] filters (per-frame mode), or a [1,P,Q] filter broadcast over
    the batch (the frozen filters of Pass 1; at B = 1 the same product).

    f16 guard: the frozen filters are unbounded FC outputs that f16's exponent
    cannot hold, so under f16 storage the operands are fp32 and only the
    output is rounded to f16.  Exact in fp32 whatever the config's
    precision, so it takes none."""
    if x.dtype == torch.float16:
        return apply_dynamic_filter(x.float(), filt.float()).to(x.dtype)
    f = filt.to(x.dtype)
    with exact_products(x):
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
    only the output is rounded to f16.  Exact in fp32 whatever the config's
    precision (a per-sample grouped conv, cuDNN's), so it takes none."""
    if x.dtype == torch.float16:
        return apply_dynamic_filter_3x3(x.float(), filt.float()).to(x.dtype)
    b, h, w, q = x.shape
    f = filt.to(x.dtype)
    if f.shape[0] == 1 and b != 1:
        f = f.expand(b, *f.shape[1:])
    p = f.shape[1]
    with exact_products(x):
        y = F.conv2d(_nchw(x).reshape(1, b * q, h, w),
                     f.reshape(b * p, q, 3, 3), padding=1, groups=b)
    return y.reshape(b, p, h, w).permute(0, 2, 3, 1).contiguous()
