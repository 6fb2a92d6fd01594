"""The seeded inputs repeat by seed and differ across seeds."""

import numpy as np
import torch

from benchmark.lib import data


def test_clips_repeat_by_seed():
    a = data.clip(2**31 + 3, 1, 5, 24, 40, "cpu")
    b = data.clip(2**31 + 3, 1, 5, 24, 40, "cpu")
    c = data.clip(2**31 + 4, 1, 5, 24, 40, "cpu")
    d = data.clip(2**31 + 3, 2, 5, 24, 40, "cpu")
    assert a.dtype == np.uint8 and a.shape == (5, 24, 40, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    # The pattern moves: no two frames of a clip are equal.
    assert all(not np.array_equal(a[i], a[i + 1]) for i in range(4))


def test_clip_is_synth_clips_pattern():
    # chip_smoke.synth_clip's formula, evaluated in numpy at the same
    # parameters, within one count of the device's fp32 evaluation.
    f, ph = data._params(7, 0)
    yy, xx = np.mgrid[0:16, 0:20].astype(np.float32)
    i = 3
    want = np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                        + (yy + 2 * i) * f[c, 1] + ph[c])
                     * np.cos(yy * f[c, 0] * 0.7 - i * 0.05)
                     for c in range(3)], -1)
    got = data.clip(7, 0, 4, 16, 20, "cpu")[i].astype(np.float64)
    assert np.abs(got - np.clip(want, 0, 255).astype(np.uint8)).max() <= 1


def test_style_repeats_by_seed():
    a = data.style(5, 32, 32, "cpu")
    assert np.array_equal(a, data.style(5, 32, 32, "cpu"))
    assert not np.array_equal(a, data.style(6, 32, 32, "cpu"))


def test_train_pool_repeats_by_seed(tmp_path):
    from types import SimpleNamespace

    from benchmark.drivers import train
    from benchmark.tests.tiny import ROOT

    import json
    cfg = json.loads((ROOT / "benchmark/configs/rerevst-train-high.json")
                     .read_text())
    tr = dict(batch=2, size=32, pool=3, check_steps=3)
    cells = []
    for seed in (11, 11, 12):
        c = train.Cell(SimpleNamespace(root=ROOT, config=cfg, traffic=tr,
                                       device="cpu"))
        c.load(seed)
        cells.append(c)
    a, b, c = cells
    assert torch.equal(a.content, b.content) and torch.equal(a.style,
                                                             b.style)
    assert torch.equal(a.start["decoder"]["out"]["w"],
                       b.start["decoder"]["out"]["w"])
    assert not torch.equal(a.content, c.content)
    assert not torch.equal(a.start["decoder"]["out"]["w"],
                           c.start["decoder"]["out"]["w"])
    # Every row of the pool differs from every other.
    rows = a.content.reshape(-1, 32 * 32 * 3)
    assert torch.cdist(rows, rows).add(torch.eye(len(rows))).min() > 0
