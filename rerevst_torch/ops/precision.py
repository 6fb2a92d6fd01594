"""Product precision: the level a config asks for, and exact fp32 on the card.

``ModelConfig.precision`` and ``ModelConfig.mix_precision`` name one of three
levels, as the JAX package's ``lax.Precision`` does
(``rerevst_tpu/models/layers.py:precision_for``).  On the card they mean:

* ``'highest'``: exact fp32 products (cuDNN and cuBLAS with TF32 off), the
  parity oracle;
* ``'high'``: the fp32 3x3 SAME convs as three TF32 passes on the tensor
  cores (the ``conv3x3_implicit_gemm`` kernel, fp32-accurate); every other
  fp32 product exact, since the libraries have no three-pass TF32;
* ``'default'``: the fp32 3x3 SAME convs as one TF32 pass (the same kernel
  with ``passes=1``); every other fp32 product exact, as at ``'high'``.

The levels hold in training as in inference: under autograd the kernel's
backward runs at the same level (its input gradient on the same kernel,
its weight gradient on ``conv3x3_wgrad``, three or one TF32 passes), and
the library's products, their gradients included, stay exact.

On 16-bit operands every level is the card's native 16-bit product, and on
the CPU every level computes exact fp32.

cuDNN runs fp32 convolutions as TF32 while ``torch.backends.cudnn.allow_tf32``
is True (PyTorch's default), and cuBLAS its matmuls under
``torch.backends.cuda.matmul.allow_tf32``.  Both flags are global to the
process, and a mesh runs one Python thread per shard, so exact products
take :func:`exact_products`: while any thread is inside it both flags are
False, and when the last one leaves they are put back as they were.
Nothing in the port turns TF32 on, so no thread's exact product can run
another's TF32.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator

import torch

#: The product precision levels, fastest first.
LEVELS = ("default", "high", "highest")

#: What ``ModelConfig.precision`` takes: a level, or 'auto'.
PRECISIONS = ("auto",) + LEVELS


def precision_for(dtype: torch.dtype, override: str = "auto") -> str:
    """The level of a config: ``override`` where it names one; else
    'highest' for fp32 storage (parity) and 'default' for 16-bit storage
    (``rerevst_tpu``'s ``precision_for``)."""
    if override and override != "auto":
        if override not in LEVELS:
            raise ValueError(f"unknown precision {override!r}; choose from "
                             f"{PRECISIONS}")
        return override
    return "highest" if dtype == torch.float32 else "default"


def tf32_passes(x: torch.Tensor, precision: str) -> int:
    """The TF32 passes of a 3x3 SAME conv of an fp32 `x` at `precision`: 3
    at 'high', 1 at 'default', which the ``conv3x3_implicit_gemm`` op takes
    (its plain version on the CPU, exact); 0 at 'highest' (the library's
    exact conv) and for 16-bit operands."""
    if x.dtype != torch.float32:
        return 0
    return {"high": 3, "default": 1}.get(precision, 0)


_LOCK = threading.Lock()
_depth = 0
_saved = (True, False)


@contextlib.contextmanager
def _exact_scope() -> Iterator[None]:
    global _depth, _saved
    with _LOCK:
        if _depth == 0:
            _saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1
            if _depth == 0:
                torch.backends.cudnn.allow_tf32 = _saved[0]
                torch.backends.cuda.matmul.allow_tf32 = _saved[1]


def exact_products(*tensors: torch.Tensor):
    """A context in which the library's fp32 products are exact: TF32 off
    for cuDNN and cuBLAS while any thread is inside one.  With tensors, it
    takes effect only where one of them is an fp32 CUDA tensor (elsewhere
    the flags do not matter).  Backward passes read the flags when they
    run, so a training step holds one around its forward and backward
    (:func:`exact_products_fn`)."""
    if not tensors or any(t.is_cuda and t.dtype == torch.float32
                          for t in tensors):
        return _exact_scope()
    return contextlib.nullcontext()


def exact_products_fn(fn):
    """`fn` run inside :func:`exact_products`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _exact_scope():
            return fn(*args, **kwargs)
    return wrapped
