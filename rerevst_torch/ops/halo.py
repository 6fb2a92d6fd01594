"""The H-sharded execution context of Pass 2 (``parallel/spatial.py``).

Under frozen statistics every op of the global Pass 2 is H-local except a
few: the 3x3 convolutions (``layers.conv2d`` with ``padding=1``, the VGG
encoder's and the decoder's), the folded upsample conv
(``layers.upsample2x_conv3x3``, one low-resolution row each side) and the
pair-lane conv (``transformer._conv3x3``, ``vgg.vgg_features``).  The 2x2
max pools are local while a shard's row count stays even, which the spatial
gate guarantees.  While a thread runs under ``h_sharded``, those functions
read its context: they attach the neighbours' boundary rows with the
context's ``exchange_rows(x, halo)`` (zeros at the frame's edge) and convolve
without H padding, or crop the rows a SAME conv computed from the halo.
Everything else in the model runs as it does on one device.

The context is thread-local: each shard's worker thread has its own, and
every other thread sees none, so the single-device path reads one attribute
per padded conv and is otherwise unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, NamedTuple, Optional

import torch

_LOCAL = threading.local()


class HaloContext(NamedTuple):
    """`exchange_rows(x, halo)`: x [B,h,W,C] with `halo` rows of each
    neighbouring shard attached above and below (zeros at the frame's
    edge), [B,h+2 halo,W,C]."""
    exchange_rows: Callable[[torch.Tensor, int], torch.Tensor]


def current() -> Optional[HaloContext]:
    """This thread's context, or None off the H-sharded path."""
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def h_sharded(exchange_rows: Callable[[torch.Tensor, int], torch.Tensor]
              ) -> Iterator[None]:
    """Run the block as one H shard of a frame."""
    prev = current()
    _LOCAL.ctx = HaloContext(exchange_rows)
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def same_conv(conv: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """A SAME-padded 3x3 conv `conv` (a kernel that pads H with zeros
    itself) on an H shard: run it over the shard and one halo row each side,
    then drop the two rows the halo's zero padding computed."""
    ctx = current()
    if ctx is None:
        return conv(x)
    return conv(ctx.exchange_rows(x, 1))[:, 1:-1].contiguous()
