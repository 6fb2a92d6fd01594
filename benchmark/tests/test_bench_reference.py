"""The reference against the program on the CPU at a tiny size, and the
inference control (the program's bf16 path) failing the limits there."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.tests.tiny import ROOT, TINY


def _cell(name, tmp_path, **traffic):
    from benchmark.drivers import clips, train

    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in b["workloads"]}[name]
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{w['config']}.json")
                     .read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json")
                    .read_text())
    tr.update(TINY[tr["kind"]], **traffic)
    if "check" in tr:
        tr["check"].update(iterations=2, frames_per_iteration=3)
    driver = {"clips": clips, "train": train}[tr["kind"]]
    cell = driver.Cell(SimpleNamespace(root=ROOT, config=cfg, traffic=tr,
                                       device="cpu"))
    cell.load(2**31 + 21)
    return cell, cfg


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tf32-global-1080"])
def test_inference_reference_matches_the_program(tmp_path, name):
    cell, cfg = _cell(name, tmp_path)
    got = cell.calibrate(2**31 + 22, cfg["model"])
    # On the CPU both sides are exact fp32: a count here and there.
    assert got["mean_abs_counts"] < cfg["limits"]["mean_abs_counts"] / 20
    assert got["worst_frame_mean_abs_counts"] < \
        cfg["limits"]["worst_frame_mean_abs_counts"] / 20


@pytest.mark.parametrize("name", ["tf32-global-1080"])
def test_inference_control_fails(tmp_path, name):
    cell, cfg = _cell(name, tmp_path)
    got = cell.calibrate(2**31 + 23, dict(cfg["model"], **cfg["control"]))
    assert any(got[k] > v for k, v in cfg["limits"].items())


def test_tf32_round_is_round_half_away_from_zero():
    from benchmark.reference.model import tf32_round

    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, -(1 + ulp / 2), 3.0e-3, 0.0])
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp),
                         float(torch.tensor(3.0e-3).view(torch.int32)
                               .add(0x1000).bitwise_and(-0x2000)
                               .view(torch.float32)), 0.0])
    assert torch.equal(tf32_round(x), want)
    r = tf32_round(torch.randn(4096, generator=torch.Generator()
                               .manual_seed(5)))
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def test_rounded_convs_round_the_3x3_same_convs_only():
    from benchmark.reference import model as ref

    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 6, 6, 4, generator=g)
    p3 = {"w": torch.randn(3, 3, 4, 5, generator=g),
          "b": torch.randn(5, generator=g)}
    p1 = {"w": torch.randn(1, 1, 4, 5, generator=g)}
    rounded = {"w": ref.tf32_round(p3["w"]), "b": p3["b"]}
    with ref.rounded_convs(1):
        assert torch.equal(ref.conv(p3, x),
                           ref.conv(rounded, ref.tf32_round(x)))
        assert not torch.equal(ref.conv(p3, x), ref.conv(p3, x, 1, True))
        assert torch.equal(ref.conv(p1, x, 0), ref.conv(p1, x, 0, True))
    assert torch.equal(ref.conv(p3, x, 1, True), ref.conv(p3, x))


def test_train_reference_matches_the_program(tmp_path):
    """Both sides exact on the CPU, the relaxed loop's iterate taken from
    the program: losses, first gradients and changes agree to what Adam's
    sign of near-zero gradients leaves (PERF.md section 2), and the
    reference's own loop lands within a few percent of the program's."""
    cell, cfg = _cell("train-high-b4", tmp_path)
    got = cell.calibrate(2**31 + 24, cfg["model"])
    assert got["loss_rel_gap"] < 5e-3
    assert got["grad_norm_gap"] < 5e-3
    assert got["change_norm_gap"] <= cfg["limits"]["change_norm_gap"]
    assert got["relaxed_loop_rel_gap"] < 0.1
    assert got["inner_loss_rel_gap"] <= cfg["limits"]["inner_loss_rel_gap"]


@pytest.mark.cuda
def test_train_control_fails_on_the_card(card, tmp_path):
    """On the card the control ('default': one TF32 pass) fails a limit at
    the cell's own size; the CPU computes every level exactly, so it runs
    there only."""
    from benchmark.drivers import train

    cfg = json.loads((ROOT / "benchmark/configs/rerevst-train-high.json")
                     .read_text())
    tr = json.loads((ROOT / "benchmark/traffic/train-b4.json").read_text())
    cell = train.Cell(SimpleNamespace(root=ROOT, config=cfg, traffic=tr,
                                      device="cuda"))
    cell.load(2**31 + 25)
    got = cell.calibrate(2**31 + 25, dict(cfg["model"], **cfg["control"]))
    assert any(got[k] > v for k, v in cfg["limits"].items())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
