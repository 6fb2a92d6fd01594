#!/usr/bin/env python3
"""What a ``torch.library`` op costs the caller, by the way it is registered.

    python3 scripts/probe_op_registration.py [--device cpu|cuda]

Defines one trivial op, ``probe::twice(Tensor x) -> Tensor`` (``x * 2``),
in a fresh process per registration:

* ``custom_op``: ``torch.library.custom_op`` with ``register_kernel`` for
  CUDA and ``register_fake``;
* ``library``: ``torch.library.Library(..., "DEF")`` with ``define``,
  ``impl`` per dispatch key and ``torch.library.register_fake`` (how
  ``rerevst_torch/kernels/_build.define_op`` registers the kernels' ops).

For each: the first call's milliseconds (host clock), whether it imported
``torch._dynamo``, and the host microseconds per call over 2000 calls of
the op against the same Python function called directly, on a small tensor
of the given device.  Prints one JSON line (with the card's name where the
device is cuda).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, sys, time
import torch

how, device = sys.argv[1:3]


def twice(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def fake(x):
    return torch.empty_like(x)


if how == "custom_op":
    op = torch.library.custom_op("probe::twice", mutates_args=(),
                                 device_types="cpu")(twice)
    op.register_kernel("cuda")(twice)
    op.register_fake(fake)
else:
    lib = torch.library.Library("probe", "DEF")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", twice, "CPU")
    lib.impl("twice", twice, "CUDA")
    torch.library.register_fake("probe::twice", fake, lib=lib)
x = torch.ones(8, device=device)
op = torch.ops.probe.twice
t0 = time.perf_counter()
op(x)
first_ms = (time.perf_counter() - t0) * 1e3
per = {}
for name, fn in (("op", op), ("direct", twice), ("op2", op),
                 ("direct2", twice)):
    for _ in range(100):
        fn(x)
    t0 = time.perf_counter()
    for _ in range(2000):
        fn(x)
    per[name] = (time.perf_counter() - t0) / 2000 * 1e6
if device == "cuda":
    torch.cuda.synchronize()
print(json.dumps({
    "registration": how, "first_call_ms": first_ms,
    "imported_dynamo": "torch._dynamo" in sys.modules,
    "op_us": min(per["op"], per["op2"]),
    "direct_us": min(per["direct"], per["direct2"]),
    "dispatch_us": min(per["op"], per["op2"])
    - min(per["direct"], per["direct2"])}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args()
    out = {"device": args.device, "rows": []}
    for how in ("custom_op", "library", "custom_op", "library"):
        res = subprocess.run([sys.executable, "-c", CHILD, how, args.device],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        out["rows"].append(json.loads(res.stdout.strip().splitlines()[-1]))
    if args.device == "cuda":
        import torch

        out["card"] = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        out["nvidia_smi"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
