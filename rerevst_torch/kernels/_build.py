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
import threading
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
    # dtype, x, w, b (or None), y, ws (or None), B, H, W, C, O, rows, cols,
    # n, ks, grid, splits, passes, stream
    "rr_conv3x3": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _P],
    # dtype, x, w, b (or None), y, ws (or None), B, H, W, O, rows, cols, n,
    # ks, grid, splits, passes, stream
    "rr_conv3x3_c64": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P],
    # x, w, b (or None), y, ws, B, H, W, C, O, cols, n, ks, grid, splits,
    # passes, stream
    "rr_conv3x3_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    # x, g, dw, ws (or None), B, H, W, C, O, splits, passes, stream
    "rr_conv3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
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


def ptxas_report(source: str, src_dir: Path = SRC_DIR) -> dict:
    """What ptxas says of each kernel of one source (``nvcc -Xptxas -v``):
    registers, spill stores and loads in bytes, and its performance notes
    (such as wgmma serialization), by mangled entry name.  `src_dir`: where
    the source lies (an edited copy's directory, for a probe)."""
    obj = BUILD_DIR / (f"report.{os.getpid()}.{Path(source).stem}."
                       f"{abs(hash(str(src_dir)))}.o")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(Path(src_dir) / source), "-o", str(obj)],
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
        m = re.search(r"\((C\d+)\) (.*) (?:for|in) the function '(\w+)'",
                      line)
        if m:
            out.setdefault(m.group(3), {"notes": []})["notes"].append(
                f"{m.group(1)} {m.group(2)}")
    return out


#: Serializes the first build: a mesh's shard threads may all reach their
#: first kernel at once, and concurrent builds would share object files.
_BUILD_LOCK = threading.Lock()

#: Guards the wrappers' launch counts, which a mesh's shard threads bump
#: concurrently (a read-modify-write).
COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    with _BUILD_LOCK:
        lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


#: The ``rerevst`` operator namespace.  Each kernel module defines its op
#: here with ``define_op``.  The low-level ``torch.library.Library`` API, not
#: ``torch.library.custom_op``: custom_op wraps every kernel in
#: ``torch._disable_dynamo``, whose first call imports ``torch._dynamo``
#: (1.76 s on a CPU host, measured; PERF.md section 6, PR 12), and routes
#: each call through a Python autograd wrapper.  The ops have no autograd
#: formula of their own: where a gradient is needed, the wrapper of the
#: fp32 conv goes through ``kernels.conv3x3.Conv3x3Fn``, whose backward
#: calls the conv op again and the ``conv3x3_wgrad`` op.
LIBRARY = torch.library.Library("rerevst", "DEF")


def define_op(schema: str, cpu, cuda, fake) -> None:
    """Define ``rerevst::<name>`` from its schema, with `cpu` (the plain
    version) for CPU tensors, `cuda` (the kernel's launcher) for CUDA
    tensors and `fake` (the output's shape, dtype and strides alone, reading
    no memory) for ``torch.export`` and other tracing."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"rerevst::{name}", fake, lib=LIBRARY)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"(cudaError_t)")
