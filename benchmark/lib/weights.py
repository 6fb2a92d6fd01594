"""Read a flax-msgpack checkpoint (the bundled ``models/*.msgpack``) into a
nested dict of CPU tensors, without msgpack or flax.

The subset of msgpack that ``flax.serialization`` writes: maps with string
keys, ints, strings, binaries, and ext records of code 1 holding an array
as ``(shape, dtype name, raw bytes)``.  Written for the benchmark so that
the weights both sides get are decoded by neither of them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import torch

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {self.value(): self.value() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num(">" + "BHI"[b - 0xC7]))
        if b in (0xCC, 0xCD, 0xCE, 0xCF):
            return self.num(">" + "BHIQ"[b - 0xCC])
        if b in (0xD0, 0xD1, 0xD2, 0xD3):
            return self.num(">" + "bhiq"[b - 0xD0])
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.num(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">" + "HI"[
                b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return {self.value(): self.value()
                    for _ in range(self.num(">" + "HI"[b - 0xDE]))}
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def ext(self, n: int) -> Any:
        code = self.num(">b")
        data = bytes(self.take(n))
        if code != 1:
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, name, raw = _Reader(data).value()
        t = torch.frombuffer(bytearray(raw), dtype=_DTYPES[name])
        return t.reshape(tuple(shape))


def read(path: str) -> Dict:
    with open(path, "rb") as f:
        return _Reader(f.read()).value()


def as_float32(tree: Any) -> Any:
    """Every floating leaf as an fp32 CPU tensor (bf16 widens exactly)."""
    if isinstance(tree, dict):
        return {k: as_float32(v) for k, v in tree.items()}
    return tree.to(torch.float32) if tree.is_floating_point() else tree
