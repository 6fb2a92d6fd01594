"""rerevst_torch.stylize vs rerevst_tpu.stylize, end to end on the CPU.

Four 64x96 crops of the bundled ambush_4 clip, written as PNG frames, go
through both CLIs with the bundled checkpoint, in global mode and in
per-frame mode (``--no-global``), with ``--ewarp``.  The output frame and
video names and the JSON report's keys must be the same; frames within 1
uint8 count (the fp32 pipelines differ by about 1e-6 of the pixel scale);
the temporal metrics within 1% (their flows are the same Farneback flows).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from rerevst_torch import stylize
from rerevst_tpu import stylize as jax_stylize

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "models" / "demo_plum_4000.msgpack")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from rerevst_torch.data.video import read_video

    d = tmp_path_factory.mktemp("in")
    clip = d / "ambush"
    clip.mkdir()
    for i, f in enumerate(read_video(
            str(REPO / "docs" / "ReReVST-plum_flower-ambush_4.avi"), 4)):
        cv2.imwrite(str(clip / f"frame_{i + 1:04d}.png"), f[100:164, 400:496])
    style = d / "plum.jpg"
    cv2.imwrite(str(style), cv2.resize(
        cv2.imread(str(REPO / "docs" / "demo_style.jpg")), (64, 64)))
    return str(clip / "*.png"), str(style)


def _run(main, args, capsys):
    main(args)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode", ["global", "per-frame"])
def test_cli_matches_jax(inputs, tmp_path, capsys, mode):
    frames, style = inputs
    common = ["--style", style, "--frames", frames, "--checkpoint", CKPT,
              "--batch", "2", "--interval", "2", "--ewarp"]
    if mode == "per-frame":
        common.append("--no-global")
    reports, trees = {}, {}
    trace = tmp_path / "trace"
    for name, main, extra in (("port", stylize.main,
                               ["--device", "cpu", "--trace", str(trace)]),
                              ("jax", jax_stylize.main, [])):
        out, vout = tmp_path / name / "frames", tmp_path / name / "videos"
        reports[name] = _run(main, common + ["-o", str(out), "--video-out",
                                             str(vout)] + extra, capsys)
        trees[name] = (_tree(out), _tree(vout))
    port, jax = reports["port"], reports["jax"]
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert sorted(port) == sorted(jax)
    assert trees["port"] == trees["jax"]
    sub = "ReReVST-plum-ambush" + ("-no-global" if mode == "per-frame" else "")
    assert trees["port"] == ([f"{sub}/frame_{i:04d}.png" for i in range(1, 5)],
                             [f"{sub}.avi"])
    assert port["frames"] == jax["frames"] == 4 and port["pairs"] == 3
    assert port["pass1"] == jax["pass1"] == (
        "batched" if mode == "global" else None)
    for k in ("ewarp", "ewarp_control", "tssim", "tssim_control"):
        assert port[k] == pytest.approx(jax[k], rel=0.01, abs=1e-3)
    for rel in trees["port"][0]:
        a = cv2.imread(str(tmp_path / "port" / "frames" / rel))
        b = cv2.imread(str(tmp_path / "jax" / "frames" / rel))
        assert a.shape == b.shape == (64, 96, 3)
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_cli_rejects_unported_options(inputs):
    frames, style = inputs
    base = ["--style", style, "--frames", frames, "--checkpoint", CKPT,
            "--device", "cpu", "--no-video"]
    for extra, item in ((["--devices", "2"], "Queue 1 item 13"),
                        (["--tiles", "2"], "Queue 1 item 13"),
                        (["--mix", "dec"], "Queue 1 item 14")):
        with pytest.raises(NotImplementedError, match=item):
            stylize.main(base + extra)
    with pytest.raises(SystemExit):
        stylize.main(base + ["--granularity", "12"])


def test_frame_sources_match_jax(inputs):
    """Video file, frame glob and in-memory list: the same frames, count
    and sampled reads as rerevst_tpu.data.source."""
    from rerevst_torch.data import source
    from rerevst_tpu.data import source as jsource

    avi = str(REPO / "docs" / "ReReVST-plum_flower-ambush_4.avi")
    for arg in (avi, inputs[0]):
        src, jsrc = source.as_source(arg), jsource.as_source(arg)
        assert type(src).__name__ == type(jsrc).__name__
        assert len(src) == len(jsrc)
        idx = [0, 2, len(src) - 1]
        for a, b in zip(list(src.read_indices(idx)),
                        list(jsrc.read_indices(idx))):
            np.testing.assert_array_equal(a, b)
        assert sum(1 for _ in src) == len(src)
    frames = list(source.as_source(inputs[0]))
    mem = source.as_source(frames)
    assert isinstance(mem, source.ListSource) and len(mem) == 4
    assert source.as_source(mem) is mem
    with pytest.raises(ValueError, match="non-decreasing"):
        list(source.VideoSource(avi).read_indices([3, 1]))
