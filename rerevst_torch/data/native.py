"""ctypes bindings for the native host pre/post-processing library —
``rerevst_tpu/data/native.py``.

The source is the port's own copy of the JAX package's host runtime,
``rerevst_torch/csrc/host_ops.cc``.  It is built with the host C++ compiler
at first use into ``rerevst_torch/_build/``, named by a hash of the source,
the flags and the machine, so a changed source rebuilds and an unchanged one
loads at once.  Every entry point falls back to the numpy path
(``data.transforms`` + ``ops.image.pad_reflect_multiple``) when there is no
compiler or the library does not load, as in the JAX package: this is host
code, not a device kernel.

Each entry point counts its native calls in ``calls`` (numpy fallbacks count
nothing), so a run can show that the native path is the one that ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_ops.cc"
BUILD_DIR = _PKG / "_build"
#: No -march=native: the library must run on any x86-64 host it lands on.
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + [platform.machine()]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librerevst_host_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never sees a torn file
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    lib.rerevst_preprocess.argtypes = [u8p, i, i, f32p, i, i, i]
    lib.rerevst_postprocess.argtypes = [f32p, i, i, i, u8p, i, i]
    lib.rerevst_preprocess_batch.argtypes = [u8p, i, i, i, f32p, i, i, i]
    for fn in (lib.rerevst_preprocess, lib.rerevst_postprocess,
               lib.rerevst_preprocess_batch):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_pad(h: int, w: int, out_h: int, out_w: int, pad: int) -> None:
    if pad < 0 or out_h < h + pad or out_w < w + pad:
        raise ValueError(f"cannot place a {h}x{w} frame at offset {pad} in "
                         f"{out_h}x{out_w}")


def preprocess(frame_bgr: np.ndarray, out_h: int, out_w: int,
               pad: int) -> np.ndarray:
    """BGR u8 [H,W,3] -> normalized RGB f32 [1,out_h,out_w,3], reflect-padded
    with the frame at offset (pad, pad): the fused native equivalent of
    ``bgr_to_model`` + ``pad_reflect_multiple``."""
    lib = _load()
    if lib is None:
        from rerevst_torch.data.transforms import bgr_to_model
        from rerevst_torch.ops.image import pad_reflect_multiple

        return pad_reflect_multiple(bgr_to_model(frame_bgr), pad, 1,
                                    (out_h, out_w))
    frame = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
    h, w = frame.shape[:2]
    if frame.shape != (h, w, 3):
        raise ValueError(f"expected a BGR [H,W,3] frame, got {frame.shape}")
    _check_pad(h, w, out_h, out_w, pad)
    out = np.empty((1, out_h, out_w, 3), np.float32)
    lib.rerevst_preprocess(_u8p(frame), h, w, _f32p(out), out_h, out_w, pad)
    preprocess.calls += 1
    return out


def preprocess_batch(frames_bgr: np.ndarray, out_h: int, out_w: int,
                     pad: int) -> np.ndarray:
    """[N,H,W,3] u8 -> [N,out_h,out_w,3] f32 in one native call."""
    lib = _load()
    if lib is None:
        return np.concatenate(
            [preprocess(f, out_h, out_w, pad) for f in frames_bgr])
    frames = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected BGR [N,H,W,3] frames, got {frames.shape}")
    n, h, w = frames.shape[:3]
    _check_pad(h, w, out_h, out_w, pad)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    lib.rerevst_preprocess_batch(_u8p(frames), n, h, w, _f32p(out), out_h,
                                 out_w, pad)
    preprocess_batch.calls += 1
    return out


def postprocess(x: np.ndarray, orig_h: int, orig_w: int,
                pad: int) -> np.ndarray:
    """Normalized RGB f32 [1,H,W,3] (padded) -> BGR u8 [orig_h,orig_w,3]."""
    lib = _load()
    if lib is None:
        from rerevst_torch.data.transforms import model_to_bgr

        return model_to_bgr(x[:, pad:pad + orig_h, pad:pad + orig_w, :])
    xin = np.ascontiguousarray(x[0], dtype=np.float32)
    in_h, in_w = xin.shape[:2]
    if xin.shape[-1] != 3 or in_h < orig_h + pad or in_w < orig_w + pad:
        raise ValueError(f"cannot crop {orig_h}x{orig_w} at offset {pad} "
                         f"from {xin.shape}")
    out = np.empty((orig_h, orig_w, 3), np.uint8)
    lib.rerevst_postprocess(_f32p(xin), in_h, in_w, pad, _u8p(out), orig_h,
                            orig_w)
    postprocess.calls += 1
    return out


#: Native calls so far.
preprocess.calls = 0
preprocess_batch.calls = 0
postprocess.calls = 0


def reset_calls() -> None:
    for fn in (preprocess, preprocess_batch, postprocess):
        fn.calls = 0
