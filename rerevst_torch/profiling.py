"""Timing and tracing of the pipeline's entry points — what
``rerevst_tpu/profiling.py`` gives its CLI.

``PhaseTimer`` sums host wall-clock time by named phase; ``trace`` records a
``torch.profiler`` trace of the enclosed run (host and, on the card, device
activity) and writes it as a Chrome trace, viewable in Perfetto.

``rerevst_tpu``'s ``enable_compile_cache`` points JAX at its persistent
compilation cache; the port compiles its kernels once per build directory
(``kernels/_build.py``) and has no JIT cache to point anywhere, so it has no
counterpart.  ``time_fn``, a chained timer for JAX's asynchronous dispatch,
has none either: the port times the card with CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Named wall-clock phases of a pipeline run (host side)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
