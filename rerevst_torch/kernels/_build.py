"""Build and load the port's CUDA kernels.

Every ``rerevst_torch/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds and needs no ninja.
The sources compile in parallel (one ``nvcc`` each, all started together)
and link once.  The library lands in ``rerevst_torch/_build/`` (git-ignored),
named by a hash of the sources and flags, so a changed source rebuilds at
its first use and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

#: Storage dtype -> the code the C entry points take (csrc/common.cuh RrDtype;
#: 0, RR_NONE, means "no style affine" to rr_norm_affine).
DTYPE_CODES = {torch.float32: 1, torch.float16: 2, torch.bfloat16: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry point -> argtypes.  Every entry point returns cudaGetLastError()
#: after its launch (0 = cudaSuccess).
SIGNATURES = {
    # dtype, affine_dtype, leaky, x, y, rows, C, mean, rstd, xmin, xmax,
    # s, m, grid, stream
    "rr_norm_affine": [_I, _I, _I, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P,
                       _I, _P],
    # dtype, x, y, rows, f1, f2, grid, stream
    "rr_filter_pair": [_I, _P, _P, _L, _P, _P, _I, _P],
    # dtype, x, w, b (or None), y, B, H, W, C, O, rows, grid, stream
    "rr_conv3x3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, w, b (or None), y, B, H, W, O, rows, grid, stream
    "rr_conv3x3_c64": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librerevst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for src, p in zip(sorted(SRC_DIR.glob("*.cu")), procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    try:
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = so.with_suffix(f".{tag}.tmp")
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees a torn file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def ptxas_report(source: str) -> dict:
    """What ptxas says of each kernel of one source (``nvcc -Xptxas -v``):
    registers, spill stores and loads in bytes, and its performance notes
    (such as wgmma serialization), by mangled entry name."""
    obj = BUILD_DIR / f"report.{os.getpid()}.o"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(SRC_DIR / source), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}")
    out, entry = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {"notes": []})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
        m = re.search(r"\((C\d+)\) (.*) for the function '(\w+)'", line)
        if m:
            out.setdefault(m.group(3), {"notes": []})["notes"].append(
                f"{m.group(1)} {m.group(2)}")
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"(cudaError_t)")
