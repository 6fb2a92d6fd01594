"""rerevst_torch.eval vs rerevst_tpu.eval: warps, occlusion masks, E_warp,
SSIM, their streaming accumulators and ``pixel_error``, on frames of the
bundled ambush_4 clip; then the temporal contract of the two inference
modes.

Tolerances (the port warps by exact bilinear gathers in torch, the JAX
package by ``cv2.remap``; the port blurs by a separable torch conv, the JAX
package by ``cv2.GaussianBlur``):
* integer flows: warps and masks equal exactly, E_warp to 1e-6 relative (the
  port sums in fp64, numpy in fp32);
* sub-pixel flows: warps within 1e-3 of a [0,255] pixel, masks flip on at
  most 0.1% of the pixels, E_warp within 1e-3 relative;
* SSIM maps within 2e-3, their means within 1e-5.
The temporal contract: on 9 frames of the clip (128x256 crops) with the
bundled checkpoint, the port's E_warp of each mode is within 1% of the JAX
package's, and global mode's is below 0.9x per-frame mode's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from flax import serialization

from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig
from rerevst_torch.data.video import read_video
from rerevst_torch.eval import ewarp as E
from rerevst_torch.eval import ssim as S
from rerevst_torch.eval.parity import pixel_error
from rerevst_tpu.api import Stylization as JaxStylization
from rerevst_tpu.config import InferenceConfig as JaxInferenceConfig
from rerevst_tpu.eval import ewarp as jE
from rerevst_tpu.eval import ssim as jS
from rerevst_tpu.eval.parity import pixel_error as jax_pixel_error

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
CLIP = REPO / "docs" / "ReReVST-plum_flower-ambush_4.avi"
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
INT_FLOWS = [(0, 0), (3, -2), (-5, 7), (40, 0)]


@pytest.fixture(scope="module")
def frames():
    return [f[:128, :256] for f in read_video(str(CLIP), 9)]


def _const_flow(dx, dy, h=128, w=256):
    f = np.zeros((h, w, 2), np.float32)
    f[..., 0], f[..., 1] = dx, dy
    return f


@pytest.mark.parametrize("dxy", INT_FLOWS)
def test_integer_flow_warp_and_mask_exact(frames, dxy):
    flow = _const_flow(*dxy)
    np.testing.assert_array_equal(
        E.backward_warp(frames[0], flow, "cpu").numpy(),
        jE.backward_warp(frames[0], flow))
    np.testing.assert_array_equal(
        E.occlusion_mask(frames[0], frames[1], flow, device="cpu").numpy(),
        jE.occlusion_mask(frames[0], frames[1], flow))


@pytest.mark.parametrize("kind", ["farneback", "random"])
def test_subpixel_warp_and_mask(frames, kind):
    if kind == "farneback":
        flow = jE.farneback_flow(frames[0], frames[1])
    else:
        flow = np.random.default_rng(0).uniform(-3, 3, (128, 256, 2)) \
            .astype(np.float32)
    got = E.backward_warp(frames[0], flow, "cpu").numpy()
    np.testing.assert_allclose(got, jE.backward_warp(frames[0], flow),
                               atol=1e-3, rtol=0)
    flips = (E.occlusion_mask(frames[0], frames[1], flow, device="cpu")
             .numpy() != jE.occlusion_mask(frames[0], frames[1], flow))
    assert flips.mean() <= 1e-3


@pytest.mark.parametrize("flows", ["integer", "farneback"])
def test_ewarp_and_accumulators_match_jax(frames, flows):
    styled = [np.ascontiguousarray(f[:, ::-1]) for f in frames[:5]]
    origs = frames[:5]
    if flows == "integer":
        fl = [_const_flow(1, 2)] * 4
        got = E.ewarp(styled, origs, flows=fl, device="cpu")
        want = jE.ewarp(styled, origs, flows=fl)
        rtol = 1e-6
    else:
        got = E.ewarp(styled, origs, device="cpu")
        want = jE.ewarp(styled, origs)
        rtol = 1e-3
        acc, jacc = E.EwarpAccumulator("cpu"), jE.EwarpAccumulator()
        tacc = S.TemporalSSIMAccumulator("cpu")
        for o, s in zip(origs, styled):
            acc.push(o, s)
            jacc.push(o, s)
            tacc.push(o, s)
        assert acc.result() == got  # the same sums, pair by pair
        for k in ("ewarp", "ewarp_control"):
            assert jacc.result()[k] == pytest.approx(got[k], rel=rtol)
        tss = S.temporal_ssim(styled, origs, device="cpu")
        assert tacc.result() == {k: tss[k] for k in ("tssim", "tssim_control")}
    assert got["pairs"] == want["pairs"] == 4
    for k in ("ewarp", "ewarp_control"):
        assert got[k] == pytest.approx(want[k], rel=rtol)


def test_ssim_matches_jax(frames):
    a, b = frames[0], frames[3]
    np.testing.assert_allclose(S.ssim_map(a, b, "cpu").numpy(),
                               jS.ssim_map(a, b), atol=2e-3, rtol=0)
    gray = cv2.cvtColor(a, cv2.COLOR_BGR2GRAY)
    np.testing.assert_allclose(S.ssim_map(gray, gray[::-1], "cpu").numpy(),
                               jS.ssim_map(gray, gray[::-1]), atol=2e-3,
                               rtol=0)
    mask = (np.arange(256)[None, :] < 200).astype(np.float32) \
        * np.ones((128, 1), np.float32)
    assert S.ssim(a, b, device="cpu") == pytest.approx(jS.ssim(a, b), abs=1e-5)
    assert S.ssim(a, b, mask, "cpu") == pytest.approx(jS.ssim(a, b, mask),
                                                      abs=1e-5)
    assert S.ssim(a, a, device="cpu") == pytest.approx(1.0, abs=1e-6)


def test_temporal_ssim_matches_jax(frames):
    styled = [np.ascontiguousarray(f[::-1]) for f in frames[:4]]
    fl = [_const_flow(-2, 1)] * 3
    got = S.temporal_ssim(styled, frames[:4], flows=fl, device="cpu")
    want = jS.temporal_ssim(styled, frames[:4], flows=fl)
    assert got["pairs"] == want["pairs"] == 3
    for k in ("tssim", "tssim_control"):
        assert got[k] == pytest.approx(want[k], abs=1e-5)


def test_pixel_error_identical(rng):
    a = [rng.integers(0, 256, (9, 11, 3), dtype=np.uint8) for _ in range(3)]
    b = [np.clip(x.astype(np.int16) + rng.integers(-3, 4, x.shape), 0, 255)
         .astype(np.uint8) for x in a]
    assert pixel_error(a, b) == jax_pixel_error(a, b)


def test_without_cv2_flows_must_be_given(frames, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    with pytest.raises(ImportError, match="pass the flows"):
        E.ewarp(frames[:2], frames[:2], device="cpu")
    with pytest.raises(ImportError, match="flows="):
        E.EwarpAccumulator("cpu")
    with pytest.raises(ImportError, match="flows="):
        S.TemporalSSIMAccumulator("cpu")
    fl = [_const_flow(0, 1)]
    got = E.ewarp(frames[:2], frames[:2], flows=fl, device="cpu")
    assert got["ewarp"] == got["ewarp_control"] > 0
    got = S.temporal_ssim(frames[:2], frames[:2], flows=fl, device="cpu")
    assert got["tssim"] == got["tssim_control"] < 1


def test_temporal_contract(frames):
    """Global mode beats per-frame mode on E_warp in the port as in the JAX
    package, each mode's E_warp within 1% of the JAX package's."""
    params = serialization.msgpack_restore(CKPT.read_bytes())
    style = cv2.resize(cv2.imread(str(REPO / "docs" / "demo_style.jpg")),
                       (256, 256))
    kw = dict(pad=16, granularity=32, sample_interval=4, batch_size=4)
    ew = {}
    for use_global in (True, False):
        js = JaxStylization(params=params, use_global=use_global,
                            infer=JaxInferenceConfig(use_global=use_global,
                                                     **kw))
        js.prepare_style(style)
        want = jE.ewarp(list(js.stylize_video(frames, 4)), frames)["ewarp"]
        s = Stylization(params=params, use_global=use_global,
                        infer=InferenceConfig(use_global=use_global, **kw),
                        device="cpu")
        s.prepare_style(style)
        got = E.ewarp(list(s.stylize_video(frames, 4)), frames,
                      device="cpu")["ewarp"]
        assert got == pytest.approx(want, rel=0.01)
        ew[use_global] = got
    assert ew[True] < 0.9 * ew[False]


def test_parity_pipeline_and_unported_flags(frames):
    """``run_pipeline`` renders what the JAX package's does (within 1
    count); fast-config flags the port lacks raise through ModelConfig."""
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.eval import parity
    from rerevst_tpu.config import ModelConfig as JaxModelConfig
    from rerevst_tpu.eval import parity as jparity

    params = serialization.msgpack_restore(CKPT.read_bytes())
    clip = [f[:64, :96] for f in frames[:3]]
    style = frames[8][:64, :64]
    got = parity.run_pipeline(params, ModelConfig(), clip, style, 2, 2,
                              device="cpu")
    want = jparity.run_pipeline(params, JaxModelConfig(), clip, style, 2, 2)
    err = parity.pixel_error(got, want)
    assert err["n_frames"] == 3 and err["max_counts"] <= 1
    for flags, item in ((["--fast_packed"], "item 14"),
                        (["--fast_tail", "out"], "item 14"),
                        (["--fast_precision", "high"], "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            parity.main(flags + ["--device", "cpu"])
