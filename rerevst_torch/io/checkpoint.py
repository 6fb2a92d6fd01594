"""Native checkpoints: flax-msgpack parameter trees, read and written without
msgpack or flax.

``rerevst_tpu`` writes its weights with ``flax.serialization`` (see
``rerevst_tpu/io/checkpoint.py``): a msgpack map of nested string-keyed maps
whose leaves are ext-type records ``(shape, dtype-name, raw bytes)``.  The
card's machine has neither ``msgpack`` nor ``flax``, so this module decodes
the subset of msgpack that flax emits by hand, and turns each array record
into a CPU tensor (bf16 through ``torch.frombuffer``, since numpy has no
bf16).  ``load_params`` then hands the tree to ``io.convert.from_jax_params``.

``packb`` and ``save_params`` are the other direction: the bytes
``flax.serialization.to_bytes`` gives for the same tree (the smallest int,
str and bin encodings msgpack picks, maps in insertion order, arrays above
``MAX_CHUNK_SIZE`` split into flax's chunked form), from tensors (bf16
included) or numpy arrays.

The train-state half (``save_train_state`` ... ``restore_train_state``)
writes and reads the JAX package's step-tagged checkpoints,
``ckpt-step%08d.msgpack`` holding ``{"params", "opt_state"}`` with the
optimizer in the layout flax writes for optax's state
(``train.state.opt_state_tree``), so a run of either package resumes in the
other.
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
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
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

#: flax.serialization.MAX_CHUNK_SIZE: an array of more bytes is written as
#: ``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``.
MAX_CHUNK_SIZE = 2 ** 30


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
    `dtype` (None keeps the stored dtype) on `device`.

    Raises ``TypeError`` where `dtype` is neither None nor a
    ``torch.dtype``: the JAX package's ``load_params(path, like)`` takes a
    template there, which would otherwise pass silently as the dtype."""
    if dtype is not None and not isinstance(dtype, torch.dtype):
        raise TypeError(f"load_params: dtype must be None or a torch.dtype, "
                        f"not {type(dtype).__name__} (the port reads no "
                        f"flax template)")
    return from_jax_params(read_msgpack(path), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes) -> None:
    """A length header: the fix form up to `fix_max` (None: no fix form),
    then the 8-, 16- and 32-bit forms in `codes` (None where msgpack has
    none)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} is out of msgpack's range")


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_record(a) -> bytes:
    """flax's ``(shape, dtype name, raw C-order bytes)`` record of a tensor
    or a numpy array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor dtype {t.dtype} is not supported")
        name = _DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its 2-byte words
            t = t.view(torch.int16)
        raw = t.numpy().tobytes()
        shape = tuple(a.shape)
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured arrays are not supported")
        name, raw, shape = a.dtype.name, a.tobytes("C"), a.shape
    out: List[bytes] = []
    _pack(out, [list(shape), name, raw], strict=False)
    return b"".join(out)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return a.size * a.dtype.itemsize


def _chunked(a) -> Dict:
    """flax's ``_chunk``: the flattened array in MAX_CHUNK_SIZE-byte pieces."""
    item = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = a.reshape(-1)
    n = flat.numel() if isinstance(a, torch.Tensor) else flat.size
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _pack(out: List[bytes], obj: Any, strict: bool = True) -> None:
    """msgpack's encoding of `obj`, as ``msgpack.packb(obj,
    default=flax's ext packer, strict_types=strict)`` gives it: with
    `strict` a tuple is not a list, and numpy scalars become ext records."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int or (not strict and isinstance(obj, int)
                              and not isinstance(obj, np.generic)):
        _pack_int(out, int(obj))
    elif type(obj) in (bytes, bytearray):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is list or (not strict and type(obj) is tuple):
        _header(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v, strict)
    elif type(obj) is dict:
        _header(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(out, _chunked(obj), strict)
        else:
            _pack_ext(out, _EXT_NDARRAY, _array_record(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_record(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} {obj!r}")


def packb(tree: Any) -> bytes:
    """The flax-msgpack bytes of `tree` (``flax.serialization.to_bytes``):
    nested string-keyed dicts of tensors, numpy arrays and Python scalars."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


def _as_saved(node: Any) -> Any:
    """The tree as ``jax.tree.map(np.asarray, ...)`` leaves it before
    ``rerevst_tpu``'s ``save_params`` writes it: dict keys sorted, scalar
    leaves as 0-d arrays (tensors stay tensors, so bf16 keeps its bytes)."""
    if isinstance(node, dict):
        return {k: _as_saved(node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_as_saved(v) for v in node]
    if node is None or isinstance(node, (torch.Tensor, np.ndarray)):
        return node
    return np.asarray(node)


def save_params(path: str, params: Dict) -> None:
    """Write a parameter tree as a native ``.msgpack`` checkpoint, the bytes
    ``rerevst_tpu.io.checkpoint.save_params`` writes for it, atomically (a
    temporary file, then ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = packb(_as_saved(params))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # never leave a torn checkpoint


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

_STEP_RE = re.compile(r"-step(\d+)\.msgpack$")


def save_train_state(out_dir: str, step: int, params: Dict, opt_state: Dict,
                     keep: int = 3) -> str:
    """Write ``ckpt-step{step:08d}.msgpack`` (params + optimizer tree) and
    keep only the newest `keep` of them."""
    path = os.path.join(out_dir, f"ckpt-step{step:08d}.msgpack")
    save_params(path, {"params": params, "opt_state": opt_state})
    old = sorted(glob.glob(os.path.join(out_dir, "ckpt-step*.msgpack")))
    for p in old[:-keep]:
        os.remove(p)
    return path


def checkpoint_at_step(out_dir: str, step: int
                       ) -> Optional[Tuple[str, int]]:
    """A specific step's checkpoint (the reference's ``--load_epoch``)."""
    path = os.path.join(out_dir, f"ckpt-step{step:08d}.msgpack")
    return (path, step) if os.path.exists(path) else None


def latest_checkpoint(out_dir: str) -> Optional[Tuple[str, int]]:
    paths = sorted(glob.glob(os.path.join(out_dir, "ckpt-step*.msgpack")))
    if not paths:
        return None
    m = _STEP_RE.search(paths[-1])
    return paths[-1], int(m.group(1)) if m else 0


def _like(template: Any, saved: Any, path: str = "") -> Any:
    """`saved` with every leaf cast to its `template` leaf's dtype and
    device; the keys and shapes must match."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint tree differs from the model's at "
                             f"{path or '/'}")
        return {k: _like(v, saved[k], f"{path}/{k}")
                for k, v in template.items()}
    if tuple(saved.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {path}: shape "
                         f"{tuple(saved.shape)} != {tuple(template.shape)}")
    return saved.to(dtype=template.dtype, device=template.device)


def restore_train_state(path: str, params_template: Optional[Dict] = None
                        ) -> Tuple[Dict, Dict]:
    """(params, optimizer tree) of a train-state checkpoint; with a
    template, the params come in its dtypes and on its devices."""
    blob = read_msgpack(path)
    params = blob["params"]
    if params_template is not None:
        params = _like(params_template, params)
    return params, blob["opt_state"]
