#!/usr/bin/env python3
"""What bounds the port's filter-pair kernel on an NVIDIA H100.

    python3 scripts/probe_filter_pair.py

Runs on the card only (imports torch and ``rerevst_torch``, no JAX).  It
measures, with CUDA events over many back-to-back calls queued behind a
sleep kernel:

1. the mma.sync m16n8k8 TF32 rate of the card: 132 x 256 threads, each
   warp streaming products into 8 independent accumulators with 16
   distinct B fragments (the kernel's operand pattern), and no other work;
2. the launch floor: an empty kernel on the kernel's grid (132 x 256);
3. ``rr_filter_pair`` in f16 at 1, 3, 6, 12, 24 and 48 tiles of 16 rows
   per warp (6 is the main path's 102,400 rows), with the least-squares
   line through them: the intercept is the cost of a call that the rows do
   not scale (launch, the filter fragments each warp splits, the first
   tile's wait, the last stores), the slope the cost of each further tile;
4. ``rr_filter_pair`` at the main path's [16, 80, 80, 32] in f16, bf16 and
   fp32;
5. the f16 kernel's loop body in SASS (``cuobjdump``): its instructions and
   its HMMA among them.

Prints the card's name and power limit, then one JSON line; the same lands
in ``chiprun_out/probe_filter_pair.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256, 1) mma_stream(const uint32_t* in,
                                                     float* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t b[16][2], a[4][4];
  for (int i = 0; i < 16; ++i) {
    b[i][0] = in[i * 64 + lane];
    b[i][1] = in[i * 64 + 32 + lane];
  }
  for (int i = 0; i < 16; ++i) a[i / 4][i % 4] = in[1024 + i * 32 + lane];
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[4 * u + nb][0]), "+f"(acc[4 * u + nb][1]),
                "+f"(acc[4 * u + nb][2]), "+f"(acc[4 * u + nb][3])
              : "r"(a[kb][0]), "r"(a[kb][1]), "r"(a[kb][2]), "r"(a[kb][3]),
                "r"(b[kb * 4 + nb][0]), "r"(b[kb * 4 + nb][1]));
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void empty_kernel() {}

extern "C" int probe_mma(const void* in, void* out, int grid, int iters,
                         void* stream) {
  mma_stream<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (float*)out, iters);
  return cudaGetLastError();
}

extern "C" int probe_empty(int grid, void* stream) {
  empty_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}
"""

MMA_PER_ITER = 32        # 4 k blocks x 4 n blocks x 2 tiles
FLOP_PER_MMA = 2 * 16 * 8 * 8
MAIN_ROWS = 16 * 80 * 80


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def build_probe(build) -> ctypes.CDLL:
    src = build.BUILD_DIR / "probe_filter_pair.cu"
    so = build.BUILD_DIR / "libprobe_filter_pair.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src),
                    "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_mma.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    lib.probe_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def loop_sass(build) -> dict:
    """Instructions, and HMMA among them, of each loop (a backward branch)
    of the f16 filter pair kernel."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    loops = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if "filter_pair_kernelI6__half" not in func.split("\n", 1)[0]:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        for addr, text in ins:
            m = re.search(r"BRA\s.*0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                ops = collections.Counter(
                    re.sub(r"^@!?U?P[T0-9]\s+", "", t).split(" ")[0]
                    .split(".")[0] for t in body)
                loops.append({"instructions": len(body), "hmma": ops["HMMA"]})
    return {"f16_loops": loops}


def us_per_call(torch, fn, calls=200) -> float:
    """Device microseconds per call: the calls queue behind a sleep kernel
    longer than their enqueue, so the card runs them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        if fn() != 0:
            raise RuntimeError("launch failed")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_filter_pair: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rerevst_torch.kernels import _build
    from rerevst_torch.kernels.filter_chain import row_plan

    card = smi()
    print(card, flush=True)
    lib = _build.library()
    probe = build_probe(_build)
    st = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"card": card, "device": torch.cuda.get_device_name(0), "sms": sms}

    # 1. mma.sync TF32 rate
    inp = (torch.rand(2048, device="cuda") + 0.5).view(torch.int32)
    out = torch.empty(sms * 256, device="cuda")
    iters = 1024
    us = us_per_call(torch, lambda: probe.probe_mma(
        inp.data_ptr(), out.data_ptr(), sms, iters, st), calls=20)
    n_mma = sms * 8 * iters * MMA_PER_ITER
    res["mma_sync_tf32_tflops"] = n_mma * FLOP_PER_MMA / us / 1e6
    res["mma_sync_tf32_cycles_per_mma_per_smsp_at_1980mhz"] = \
        us * 1e-6 * 1.98e9 / (n_mma / (4 * sms))

    # 2. launch floor
    res["empty_kernel_us"] = us_per_call(
        torch, lambda: probe.probe_empty(sms, st))

    # 3. the kernel against its rows, f16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f1 = torch.randn(32, 32, generator=gen, device="cuda") * 1e3
    f2 = torch.randn(32, 32, generator=gen, device="cuda") * 1e-3
    warps = sms * 8

    def call(x, y, rows):
        return lib.rr_filter_pair(
            _build.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), rows,
            f1.data_ptr(), f2.data_ptr(), row_plan(rows, sms).grid, st)

    scaling = []
    for k in (1, 3, 6, 12, 24, 48):
        rows = 16 * warps * k if k != 6 else MAIN_ROWS
        x = torch.randn(rows, 32, generator=gen, device="cuda").half()
        y = torch.empty_like(x)
        scaling.append({"rows": rows, "tiles_per_warp": rows / 16 / warps,
                        "us": us_per_call(torch, lambda: call(x, y, rows))})
        del x, y
    n = len(scaling)
    mx = sum(s["tiles_per_warp"] for s in scaling) / n
    my = sum(s["us"] for s in scaling) / n
    slope = sum((s["tiles_per_warp"] - mx) * (s["us"] - my) for s in scaling) \
        / sum((s["tiles_per_warp"] - mx) ** 2 for s in scaling)
    res["f16_scaling"] = scaling
    res["f16_us_per_tile_per_warp"] = slope
    res["f16_us_fixed"] = my - slope * mx

    # 4. the main path's shape in each dtype
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        x = torch.randn(MAIN_ROWS, 32, generator=gen, device="cuda").to(dt)
        y = torch.empty_like(x)
        res[f"main_us_{str(dt).split('.')[-1]}"] = us_per_call(
            torch, lambda: call(x, y, MAIN_ROWS))
    res.update(loop_sass(_build))
    print(json.dumps(res), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "probe_filter_pair.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
