"""A run with the timed path broken underneath reports ``correct`` false:
each fault the cell can have, planted in the program on the CPU at a tiny
size, with the rest of the run as it is (the look for a card skipped)."""

import pytest

from benchmark.tests.tiny import run_cell, tiny_tree

#: An answer altered where it is produced: each delivered frame has an
#: 8 x 8 block inverted.
ALTERED_FRAME = """
import rerevst_torch.api as api
_orig = api.model_to_bgr
def _altered(x):
    out = _orig(x).copy()
    out[:8, :8] = 255 - out[:8, :8]
    return out
api.model_to_bgr = _altered
"""

#: A step that returns its state unchanged: Pass 1 runs for the first clip
#: only, and later clips are stylized under its frozen statistics.
STALE_PASS1 = """
import rerevst_torch.api as api
_orig = api.Stylization.prepare_global
def _once(self, frames, total=None):
    if getattr(self, "_bench_done", False):
        return
    self._bench_done = True
    return _orig(self, frames, total)
api.Stylization.prepare_global = _once
api.Stylization.clean = lambda self: None
"""

#: A train step that returns its state unchanged: Adam never steps.
FROZEN_STEP = """
import rerevst_torch.train.state as st
_orig = st.init_train_state
def _frozen(params, cfg):
    s = _orig(params, cfg)
    s.optimizer.step = lambda *a, **k: None
    return s
st.init_train_state = _frozen
"""

#: Half of the batch left out, the mean taken over the rest.
HALF_BATCH = """
import rerevst_torch.train.step as ts
_orig = ts.make_train_step
def _half(cfg):
    step = _orig(cfg)
    return lambda state, c, s, gen, extra=None: step(
        state, c[:c.shape[0] // 2], s[:s.shape[0] // 2], gen, extra)
ts.make_train_step = _half
"""

#: The relaxed loop cut to half its iterations.
LOOP_CUT = """
import dataclasses
import rerevst_torch.train.step as ts
_orig = ts.relaxed_style_loss
def _cut(vp, st, fs, lc, mc, **kw):
    return _orig(vp, st, fs, dataclasses.replace(lc, flow_iter=8), mc, **kw)
ts.relaxed_style_loss = _cut
"""

#: The relaxed loop's VGG passes in bf16 (the program's own option).
LOOP_BF16 = """
import dataclasses
import rerevst_torch.train.step as ts
_orig = ts.relaxed_style_loss
def _bf16(vp, st, fs, lc, mc, **kw):
    return _orig(vp, st, fs,
                 dataclasses.replace(lc, relaxed_inner_dtype="bf16"), mc,
                 **kw)
ts.relaxed_style_loss = _bf16
"""


@pytest.mark.parametrize("cell,fault", [
    ("tf32-global-1080", ALTERED_FRAME),
    ("tf32-global-1080", STALE_PASS1),
    ("train-high-b4", FROZEN_STEP),
    ("train-high-b4", HALF_BATCH),
    ("train-high-b4", LOOP_CUT),
    ("train-high-b4", LOOP_BF16),
], ids=["global-altered-frame", "global-stale-pass1", "train-frozen-step",
        "train-half-batch", "train-loop-cut", "train-loop-bf16"])
def test_fault_is_not_correct(tmp_path, cell, fault):
    # Long enough for the window to hand over both of the tiny mix's
    # clips (about 6 s each here), so that a stale Pass 1 meets a clip it
    # was not made from.
    res = run_cell(tiny_tree(tmp_path), cell, trace=0, patch=fault,
                   seconds=8.0 if fault is STALE_PASS1 else 0.5)
    assert res["correct"] is False, res["compared"]
