"""Two processes joined through ``torch.distributed`` (gloo, on the CPU):
the multi-process dry run against the same workload over two logical
shards of one process, and the train CLI's multi-process flags.

``dryrun_multichip_multiprocess(2, device="cpu")`` runs one data-parallel train step
(gradients all-reduced across the processes, each stepping its own Adam),
Pass 1 with its reductions all-reduced and Pass 2 returning each process's
own rows; the data of global shard g is seeded by g, so the single-process
mesh sees the same global batch.  Tolerances: the step's loss and
parameters to 1e-6 relative (the same sums in the same order: a + b);
statistics to 2e-4 relative (each process encodes its own frame, the CPU's
convolutions then sum a batch of 1 in another order than a batch of 2);
Pass-2 rows to 1e-5 relative.  Each process has a timeout of its own.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.io import checkpoint as ck
from rerevst_torch.parallel.dryrun import (
    dryrun_multichip,
    dryrun_multichip_multiprocess,
)
from rerevst_torch.parallel.dryrun import main as dryrun_main

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads in this process, as the ranks' OMP_NUM_THREADS
    gives them: the in-process mesh then sums as the ranks do, to the
    comparisons' rtol 1e-6."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_two_processes_match_one_process_mesh(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ranks = dryrun_multichip_multiprocess(2, device="cpu",
                                          timeout=RANK_TIMEOUT)
    one = dryrun_multichip(2, device="cpu")
    assert [r["transport"] for r in ranks] == ["gloo", "gloo"]
    assert one["transport"] == "threads"
    for r in ranks:  # the DDP step is the mesh step
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["params"], one["params"], rtol=1e-6)
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-6,
                                       atol=1e-9, err_msg=k)
        # Pass 1: every process holds the all-reduced statistics.
        np.testing.assert_allclose(r["stats"], one["stats"], rtol=2e-4,
                                   atol=2e-4)
    # Pass 2: each process returns its own rows.
    assert [len(r["pass2_rows"]) for r in ranks] == [1, 1]
    np.testing.assert_allclose([r["pass2_rows"][0] for r in ranks],
                               one["pass2_rows"], rtol=1e-5)
    assert one["spatial_vs_batch"] < 1e-4


@pytest.mark.parametrize("run", [
    lambda: dryrun_multichip(2),
    lambda: dryrun_multichip_multiprocess(2),
    lambda: dryrun_main(["2"]),
    lambda: dryrun_main(["--processes", "2"]),
], ids=["mesh", "ranks", "cli-mesh", "cli-ranks"])
def test_dry_runs_default_to_the_card(monkeypatch, run):
    """Like every entry point of the port the dry runs run on the card
    unless the caller asks for the CPU: without CUDA they raise before any
    mesh or process is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen", _no_process)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()


def _no_process(*a, **k):
    raise AssertionError("a rank was started without a card")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(world, per_rank_args):
    """Run the train CLI in `world` once per rank; (returncode, output)
    per rank.  A ``tensorboard`` package that fails to import comes first
    on the path: the chief's metrics logger then writes JSONL alone, and
    skips TensorBoard's import of TensorFlow (seconds per process)."""
    port = _free_port()
    block = world / "no_tensorboard" / "tensorboard"
    block.mkdir(parents=True, exist_ok=True)
    (block / "__init__.py").write_text("raise ImportError('not in tests')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(block.parent), str(REPO)])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rerevst_torch.train", "--num_processes", "2",
         "--coordinator", f"localhost:{port}", "--process_id", str(i)]
        + per_rank_args(i), cwd=world, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_train_cli_two_processes_and_resume_check(tmp_path):
    """``--num_processes 2 --coordinator ... --process_id i`` over gloo:
    both ranks take the step, the chief alone logs and saves (rank 1's own
    --outf and --log_dir stay empty); a resume that finds a checkpoint on
    one rank only stops both with the divergence error."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for d in ("content", "style"):
        (tmp_path / d).mkdir()
        for i in range(2):
            cv2.imwrite(str(tmp_path / d / f"{i}.jpg"),
                        (rng.random((40, 40, 3)) * 255).astype(np.uint8))
    base = ["--device", "cpu", "--batchSize", "1", "--epoches", "1",
            "--log", "1", "--num_workers", "1", "--loadSize", "40",
            "--fineSize", "32", "--content_data", "content", "--style_data",
            "style", "--valf", "none", "--max_steps", "1",
            "--dynamic_filter", "--both_sty_con", "--style_content_loss",
            "--tv_loss", "--vgg_init", "he_relu"]

    def own(i):
        return base + ["--outf", f"out{i}", "--log_dir", f"log{i}"]

    for rc, out in _ranks(tmp_path, own):
        assert rc == 0, out
    assert ck.latest_checkpoint(str(tmp_path / "out0"))[1] == 1
    assert (tmp_path / "log0").is_dir()
    assert not (tmp_path / "out1").exists()
    assert not (tmp_path / "log1").exists()

    res = _ranks(tmp_path, lambda i: own(i) + ["--continue_training"])
    for rc, out in res:
        assert rc != 0
        assert "resumed divergent states" in out, out
