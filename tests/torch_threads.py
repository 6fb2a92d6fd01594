"""One share of the host's cores for torch in each pytest-xdist worker.

The CPU tests run in several xdist workers at once (``-n 6`` in the
tier-1 command).  torch's intra-op pool starts one thread a core in every
worker, so six workers on an 8-core host run some fifty compute threads
that wait on each other: ``tests/test_torch_eval.py::
test_parity_pipeline_and_unported_flags`` took 23 s alone with torch's
default pool and 350 s among five other busy workers.  The port's CPU
test modules import this module; in an xdist worker it gives torch the
cores this process may run on divided by the workers (at least one
thread), and the subprocesses the tests start the same through
OMP_NUM_THREADS.  A run without xdist keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if WORKERS > 1:
    THREADS = max(1, len(os.sched_getaffinity(0)) // WORKERS)
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
