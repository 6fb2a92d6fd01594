"""Faults that ``calibrate`` plants in the program, to read what the
comparison makes of them.  The benchmark's own runs never plant one."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def library_tf32() -> Iterator[None]:
    """The program's exact-product scopes (``ops/precision._exact_scope``)
    turned into TF32 ones inside the block: cuDNN and cuBLAS then run every
    fp32 product that the configuration states exact at one TF32 pass."""
    from rerevst_torch.ops import precision

    @contextlib.contextmanager
    def tf32_scope():
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved

    exact_scope = precision._exact_scope
    precision._exact_scope = tf32_scope
    try:
        with tf32_scope():
            yield
    finally:
        precision._exact_scope = exact_scope
