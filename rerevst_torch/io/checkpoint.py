"""Native checkpoints: flax-msgpack parameter trees, read without msgpack or flax.

``rerevst_tpu`` writes its weights with ``flax.serialization`` (see
``rerevst_tpu/io/checkpoint.py``): a msgpack map of nested string-keyed maps
whose leaves are ext-type records ``(shape, dtype-name, raw bytes)``.  The
card's machine has neither ``msgpack`` nor ``flax``, so this module decodes
the subset of msgpack that flax emits by hand, and turns each array record
into a CPU tensor (bf16 through ``torch.frombuffer``, since numpy has no
bf16).  ``load_params`` then hands the tree to ``io.convert.from_jax_params``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import torch

from rerevst_torch.io.convert import from_jax_params

#: flax.serialization's ext type codes.
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


class _Reader:
    """Cursor over one msgpack buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD9: lambda: str(self.take(self.unpack(">B")), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")), "utf-8"),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        return fixed[b]()

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            t = _array_from_record(data)
            return t if code == _EXT_NDARRAY else t.reshape(()).item()
        if code == _EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not supported")


def _array_from_record(data: bytes) -> torch.Tensor:
    """flax's array record ``(shape, dtype name, raw bytes)`` -> CPU tensor."""
    shape, name, raw = unpackb(data)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"array dtype {name!r} is not supported")
    dtype = _TORCH_DTYPES[name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(tuple(shape))


def _unchunk(tree: Any) -> Any:
    """Undo flax's chunking of arrays above 1 GiB
    (``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax emits)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read_msgpack(path: str) -> Dict:
    """The raw tree of a flax msgpack checkpoint: nested dicts of CPU tensors
    in their stored dtypes (the counterpart of ``msgpack_restore``)."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def load_params(path: str, dtype=None, device="cuda") -> Dict:
    """Load a native ``.msgpack`` checkpoint as the port's parameters, cast to
    `dtype` (None keeps the stored dtype) on `device`."""
    return from_jax_params(read_msgpack(path), dtype=dtype, device=device)
