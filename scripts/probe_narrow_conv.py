#!/usr/bin/env python3
"""What bounds the port's narrow conv kernel (16-bit, 1 <= C <= 7) on an
NVIDIA H100.

    python3 scripts/probe_narrow_conv.py

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  At
VGG conv1_1 of one 16-frame batch of 640^2 ([16,640,640,3] -> 64, f16) it
times, with CUDA events over back-to-back calls queued behind a sleep
kernel:

1. the kernel as the wrapper plans it (``kernels/conv3x3.py: narrow_plan``);
2. the same launch in variants of ``csrc/conv3x3.cu``, built side by side
   from the committed source with edits into
   ``rerevst_torch/_build/probe/``:
   ``no_store`` (each warp's TMA store of its staged row skipped behind a
   condition that never holds: the halo loads, products and staging
   remain), ``store_only`` (the products and the halo loads of every tile
   after the first removed: the bias is staged and stored, so its time is
   that of the output stream through the kernel's own barriers and
   double-buffered TMA stores), ``no_fetch`` (only the halo loads removed),
   ``no_mma`` (only the products removed) and ``l2_steered`` (each TMA
   store under an evict-first L2 policy, and all of x prefetched into L2
   as evict-last before the first tile: whether keeping the input in L2
   spares the output stream);
3. ``y.zero_()`` on the same [16,640,640,64] output: one PyTorch fill, the
   card's practical rate of writing those bytes (not the same function);
4. the kernel at other grids (one to four blocks per SM; two are resident),
   through ``rr_conv3x3`` directly;
5. the kernel at C = 1 and 7 and at O = 5 (scalar stores) and 128 (two
   channel tiles) on the same 16 x 640 x 640 pixels.

Beside each it prints the byte bound (input read once, output written
once, over 3.35 TB/s) and the output bytes over the time.  Prints the
card's name and power limit, then one JSON line; the same lands in
``chiprun_out/probe_narrow_conv.json``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPE, O = (16, 640, 640, 3), 64
HBM_BYTES_PER_S = 3.35e12

_STORE = "        tma_store_4d(&ymap, smem_addr(ws), n0, u.x0, yy, u.b);\n"
_MMA = ("        mma16816<T>(acc[0][nt], a[0], b);\n"
        "        mma16816<T>(acc[1][nt], a[1], b);\n")
_FETCH = "    if (t + gridDim.x < tiles) fetch(t + gridDim.x);"
_NO_FETCH = [(_FETCH, "    if (O < 0) fetch(t + gridDim.x);")]
# L2 steering: each TMA store with an evict-first cache policy, and every
# line of x prefetched into L2 as evict-last before the first tile.
_ST = ('      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, '
       '%3, "\n      "%4, %5}], [%1];\\n"')
_ST_EF = ('      "{\\n.reg .b64 pol;\\n"\n'
          '      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n'
          '      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group'
          '.L2::cache_hint "\n'
          '      "[%0, {%2, %3, %4, %5}], [%1], pol;\\n}\\n"')
_FIRST = "  if (blockIdx.x < tiles) fetch(blockIdx.x);\n"
_PREFETCH = """  for (long long off = 128 * ((long long)blockIdx.x * kNThreads + tid);
       off < (long long)B * H * W * C * 2;
       off += 128ll * gridDim.x * kNThreads)
    asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(
        reinterpret_cast<const char*>(x) + off));
"""
VARIANTS = {
    "no_store": [(_STORE, "        if (O < 0) " + _STORE.lstrip())],
    "store_only": [(_MMA, "")] + _NO_FETCH,
    "no_fetch": _NO_FETCH,
    "no_mma": [(_MMA, "")],
    "l2_steered": [(_ST, _ST_EF), (_FIRST, _PREFETCH + _FIRST)],
}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def build_variants(build) -> dict:
    """The kernel library with each variant's edits of conv3x3.cu, the
    builds run side by side."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = build.BUILD_DIR / "probe" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        src = (build.SRC_DIR / "conv3x3.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match "
                                   f"conv3x3.cu")
            src = src.replace(old, new)
        (d / "conv3x3.cu").write_text(src)
        for header in build.SRC_DIR.glob("*.cuh"):
            shutil.copy(header, d)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(d / "conv3x3.cu"), "-o", str(d / "lib.so")]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        lib.rr_conv3x3.argtypes = build.SIGNATURES["rr_conv3x3"]
        lib.rr_conv3x3.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Milliseconds per call on the card: the calls queue behind a sleep
    kernel longer than their enqueue, so the events read device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * 20))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_narrow_conv: CUDA is not available", file=sys.stderr)
        return 2
    from rerevst_torch.kernels import _build
    from rerevst_torch.kernels import conv3x3 as K

    lib = _build.library()
    libs = build_variants(_build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(c, o):
        x = torch.randn(SHAPE[:3] + (c,), generator=gen, device="cuda").half()
        w = (torch.randn((3, 3, c, o), generator=gen, device="cuda")
             / (3 * c ** 0.5)).half()
        b = torch.randn(o, generator=gen, device="cuda").half()
        return x, w, b

    def bound_ms(x, o):
        m = x.numel() // x.shape[-1]
        return (x.numel() + 9 * x.shape[-1] * o + o + m * o) * 2 \
            / HBM_BYTES_PER_S * 1e3

    def call(lib_, x, w, b, y, o, grid):
        bsz, h, wd, c = x.shape
        err = lib_.rr_conv3x3(2, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              y.data_ptr(), None, bsz, h, wd, c, o, 0, 0,
                              K.narrow_tile_n(o), 0, grid, 1, 0, stream)
        if err:
            raise RuntimeError(f"rr_conv3x3 failed with {err}")

    x, w, b = inputs(SHAPE[-1], O)
    y = torch.empty(SHAPE[:3] + (O,), dtype=x.dtype, device="cuda")
    plan = K.narrow_plan(*SHAPE, O, sms)
    out_bytes = y.numel() * 2
    row = {"site": "VGG conv1_1", "shape": list(SHAPE), "O": O,
           "plan": {"n": plan.n, "grid": plan.grid, "tiles": plan.tiles},
           "bound_ms": bound_ms(x, O),
           "ms": device_ms(torch, lambda: K.conv3x3_implicit_gemm(x, w, b))}
    for name, lib_ in libs.items():
        row[f"{name}_ms"] = device_ms(
            torch, lambda: call(lib_, x, w, b, y, O, plan.grid))
    row["zero_fill_ms"] = device_ms(torch, lambda: y.zero_())
    for per_sm in (1, 2, 3, 4):
        row[f"grid_{per_sm}_per_sm_ms"] = device_ms(
            torch, lambda: call(lib, x, w, b, y, O, per_sm * sms))
    for key in ("ms", "store_only_ms", "zero_fill_ms"):
        row[f"{key[:-3] or 'kernel'}_out_tb_per_s"] = \
            out_bytes / row[key] / 1e9
    row["of_bound"] = row["bound_ms"] / row["ms"]
    del x, w, b, y
    others = []
    for c, o in ((1, 64), (7, 64), (3, 5), (3, 128)):
        x, w, b = inputs(c, o)
        others.append({"C": c, "O": o, "bound_ms": bound_ms(x, o),
                       "ms": device_ms(torch, lambda: K.conv3x3_implicit_gemm(
                           x, w, b))})
        del x, w, b
        torch.cuda.empty_cache()
    card = smi()
    out = {"card": card, "conv1_1": row, "other_shapes": others}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_narrow_conv.json").write_text(
        json.dumps(out, indent=1))
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
