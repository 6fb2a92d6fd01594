"""The harness: found by name, extended by files alone, its last line's
schema, its refusal without a card, and what it keeps out of its
process."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import BENCH, ROOT, run_cell, tiny_tree


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_has_its_file():
    b = _bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert (BENCH / "drivers" / f"{t['kind']}.py").is_file()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))


def test_no_card_no_result(tmp_path):
    cell = _bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cell = _bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(tmp_path, trace):
    tree = tiny_tree(tmp_path)
    cell = _bench()["workloads"][0]
    res = run_cell(tree, cell["name"], trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-2] == "compared" and keys[-1] == "forbidden"
    assert ("breakdown" in res) == bool(trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    b = _bench()
    want = ({m["name"] for m in b["end_to_end"]
             if cell["name"] in m.get("workloads", [cell["name"]])}
            if not trace else set())
    assert want <= set(res["metrics"])
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
    for name, v in res["compared"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    assert res["forbidden"] == []


def test_config_mix_and_metric_added_by_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, per-layer metric and cell:
    files and entries added to a copy, no file of the harness edited."""
    tree = tiny_tree(tmp_path)
    bdir = tree / "benchmark"
    before = {p: p.read_bytes() for p in bdir.rglob("*.py")}
    cfg = json.loads((bdir / "configs" / "rerevst-tf32.json").read_text())
    cfg["name"] = "extra-config"
    (bdir / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    mix = json.loads((bdir / "traffic" / "global-clip128.json").read_text())
    mix.update(frames=5, batch=2, clips=1)
    (bdir / "traffic" / "extra-mix.json").write_text(json.dumps(mix))
    (bdir / "metrics" / "frames_seen.extra.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['frames_delivered'])\n")
    b = json.loads((tree / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="extra-config",
                             file="benchmark/configs/extra-config.json"))
    b["workloads"].append({"name": "extra-cell", "config": "extra-config",
                           "traffic": "extra-mix", "chips": 1, "why": "x"})
    b["end_to_end"][0].setdefault("workloads", []).append("extra-cell")
    b["per_layer"].append({"name": "frames_seen.extra", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "session", "moves": "frames_per_s",
                           "workloads": ["extra-cell"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    res = run_cell(tree, "extra-cell", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["frames_seen.extra"]["value"] % 5 == 0
    assert res["metrics"]["frames_seen.extra"]["value"] >= 5
    res = run_cell(tree, "extra-cell", trace=0)
    assert "frames_per_s" in res["metrics"] and "setup_s" in res["metrics"]
    assert {p: p.read_bytes() for p in before} == before


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.model, benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "rerevst_tpu",
                       "rerevst_torch"}


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_a_cell_loads_no_jax(tmp_path, cell):
    """Each cell's modules, run to the end of a tiny run: no top-level name
    of ``jax``, ``jaxlib``, ``flax`` or ``rerevst_tpu`` in the process."""
    res = run_cell(tiny_tree(tmp_path), cell, trace=0)
    assert res["forbidden"] == []


@pytest.mark.parametrize("split", ["infer", "train"])
def test_idle_reader_takes_the_untraced_pace(split):
    """The traced window's busy time per unit of work, at the untraced
    window's pace: 2 s busy over 10 traced units is 0.2 s a unit, 20 units
    in 8 s untraced leave 50% idle; no trace, nothing read."""
    from types import SimpleNamespace

    from benchmark.run import load_file

    reader = load_file(BENCH / "metrics" / f"idle_pct.{split}.py")
    ctx = SimpleNamespace(trace=SimpleNamespace(busy_s=2.0, window_s=12.0),
                          traced_counters={"work": 10, "window_s": 12.0},
                          counters={"work": 20, "window_s": 8.0})
    assert reader.read(ctx) == pytest.approx(50.0)
    assert reader.read(SimpleNamespace(trace=None, traced_counters=None,
                                       counters=ctx.counters)) is None
