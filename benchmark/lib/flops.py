"""Operations, bytes and roofline bounds: the arithmetic of the kernel table.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity): f16 and
bf16 989 TFLOP/s, TF32 495, fp32 outside the tensor cores 67, HBM3 at 3.35
TB/s.  A launch's bound is the larger of its operations over the peak of
their type (times the TF32 passes it takes) and its bytes (each input read
once, the output written once) over the memory bandwidth.

The model counts follow the plain reference network
(``benchmark/reference/model.py``): every conv, counted as 2 * outputs *
taps * input channels at the geometry it runs at (a decoder block's
upsample comes before its 3x3 and 1x1 convs), and the dynamic filters'
1x1 products.  Norms, activations and pools are not counted.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

PEAK_FLOPS = {"f16": 989e12, "bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

#: (name, cin, cout, pools before it) of VGG-19 through conv4_1.
VGG = (("conv1_1", 3, 64, 0), ("conv1_2", 64, 64, 0),
       ("conv2_1", 64, 128, 1), ("conv2_2", 128, 128, 1),
       ("conv3_1", 128, 256, 2), ("conv3_2", 256, 256, 2),
       ("conv3_3", 256, 256, 2), ("conv3_4", 256, 256, 2),
       ("conv4_1", 256, 512, 3))

#: (name, cin, cout) of the decoder's residual blocks, coarse to fine.
RES_BLOCKS = (("res4", 512, 256), ("res3", 256, 128), ("res2", 128, 64))


def conv_flops(b: int, h: int, w: int, c: int, o: int, k: int = 3) -> float:
    """Multiply-adds times two of a stride-1 SAME k x k conv."""
    return 2.0 * b * h * w * c * o * k * k


def conv_bytes(b: int, h: int, w: int, c: int, o: int, itemsize: int = 4,
               k: int = 3, bias: bool = True) -> float:
    """x read once, the weights and bias read once, y written once."""
    return float(itemsize) * (b * h * w * c + k * k * c * o
                              + (o if bias else 0) + b * h * w * o)


def _bound(ops_s: float, mem_s: float) -> Tuple[float, str]:
    return (ops_s, "operations") if ops_s >= mem_s else (mem_s, "bytes")


def conv_bound(b: int, h: int, w: int, c: int, o: int, passes: int,
               itemsize: int = 4, bias: bool = True) -> Tuple[float, str]:
    """(least time, what bounds it) of one 3x3 conv launch at `passes`
    TF32 passes."""
    return _bound(passes * conv_flops(b, h, w, c, o) / PEAK_FLOPS["tf32"],
                  conv_bytes(b, h, w, c, o, itemsize, bias=bias)
                  / HBM_BYTES_PER_S)


def wgrad_bound(b: int, h: int, w: int, c: int, o: int, passes: int,
                itemsize: int = 4) -> Tuple[float, str]:
    """(least time, what bounds it) of one 3x3 weight-gradient launch: x
    and g read once, dw written once; the products of the forward conv."""
    return _bound(passes * conv_flops(b, h, w, c, o) / PEAK_FLOPS["tf32"],
                  itemsize * (b * h * w * (c + o) + 9 * c * o)
                  / HBM_BYTES_PER_S)


def elementwise_bound_s(numel: int, itemsize: int, vectors: int = 0) -> float:
    """A pass that reads x and writes y of the same size, plus `vectors`
    fp32 elements of conditioning."""
    return (2.0 * numel * itemsize + 4.0 * vectors) / HBM_BYTES_PER_S


def _pool(n: int, times: int) -> int:
    for _ in range(times):
        n //= 2
    return n


def vgg_flops(h: int, w: int, upto: str = "conv4_1") -> float:
    """VGG-19 through `upto` on one h x w frame."""
    total = 0.0
    for name, cin, cout, pools in VGG:
        total += conv_flops(1, _pool(h, pools), _pool(w, pools), cin, cout)
        if name == upto:
            break
    return total


def _filter_block_flops(h8: int, w8: int, ic: int, vc: int,
                        predicted: bool) -> float:
    """One KernelFilter at h8 x w8: down conv, two ic x ic products, up
    conv; per-frame mode also runs each predictor's down conv on the
    content and its FC."""
    total = (conv_flops(1, h8, w8, vc, ic) + conv_flops(1, h8, w8, ic, vc)
             + 2 * 2.0 * h8 * w8 * ic * ic)
    if predicted:
        total += 2 * (conv_flops(1, h8, w8, vc, ic) + 2.0 * 2 * ic * ic * ic)
    return total


def decoder_flops(h8: int, w8: int, per_frame: bool, ic: int = 32,
                  vc: int = 512) -> float:
    """The decoder on one frame's relu4_1 map of h8 x w8: three filter
    blocks, three residual blocks (upsample, then the 3x3 conv1 and the 1x1
    shortcut at the doubled size, the 3x3 conv2) and the out conv."""
    total = 3 * _filter_block_flops(h8, w8, ic, vc, per_frame)
    h, w = h8, w8
    for _, cin, cout in RES_BLOCKS:
        h, w = 2 * h, 2 * w
        total += (conv_flops(1, h, w, cin, cout)
                  + conv_flops(1, h, w, cin, cout, k=1)
                  + conv_flops(1, h, w, cout, cout))
    return total + conv_flops(1, h, w, 64, 3)


def stylize_flops(h: int, w: int, per_frame: bool) -> float:
    """One frame's Pass 2 at the padded h x w: encoder and decoder."""
    return vgg_flops(h, w) + decoder_flops(h // 8, w // 8, per_frame)


def launch_bound_s(op: str, shapes: Sequence[Sequence[int]], passes: int
                   ) -> Tuple[float, str]:
    """(bound in seconds, 'operations' or 'bytes') of one traced launch of
    a ``rerevst::`` op from its recorded input shapes (fp32 operands)."""
    if op in ("conv3x3_implicit_gemm", "conv3x3_pairlane"):
        (b, h, w, c), (_, _, _, o) = shapes[0], shapes[1]
        return conv_bound(b, h, w, c, o, passes,
                          bias=len(shapes) > 2 and len(shapes[2]) == 1)
    if op == "conv3x3_wgrad":
        (b, h, w, c), (_, _, _, o) = shapes[0], shapes[1]
        return wgrad_bound(b, h, w, c, o, passes)
    if op == "norm_affine_clamp":
        vectors = sum(math.prod(s) for s in shapes[1:] if s)
        return elementwise_bound_s(math.prod(shapes[0]), 4, vectors), "bytes"
    raise KeyError(op)


def traced_roofline_pct(trace, ops: Sequence[str], passes: int
                        ) -> Optional[float]:
    """Sum of the bounds over sum of the device time of every traced launch
    of the ``rerevst::`` ops named, in percent; None where no launch was
    traced or no device time was attributed to one."""
    from benchmark.lib.trace import device_us, op_scalar, op_shapes

    bound = spent = 0.0
    for op in ops:
        for e in trace.ops(f"rerevst::{op}"):
            shapes = op_shapes(e)
            us = device_us(e)
            if not shapes or us <= 0:
                continue
            p = op_scalar(e, 3 if op == "conv3x3_implicit_gemm" else 2)
            bound += launch_bound_s(op, shapes, p or passes)[0]
            spent += us / 1e6
    return 100.0 * bound / spent if spent > 0 else None
