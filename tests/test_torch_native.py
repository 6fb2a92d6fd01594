"""rerevst_torch.data.native (the port's copy of the host runtime, built with
the host C++ compiler) against the numpy path and rerevst_tpu.data.native.

Tolerances: preprocess within 1e-6 of the numpy path and of the JAX
package's library (one fused multiply-add order against another, on values
of order 1: a few fp32 ulps); postprocess within 1 uint8 count (rounding
by +0.5 and truncation against rint); the batch call equal to single-frame
calls exactly (the same code per frame).
"""

import numpy as np
import pytest
import torch

from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.api import Stylization
from rerevst_torch.data import native
from rerevst_torch.data.transforms import bgr_to_model, model_to_bgr
from rerevst_torch.ops.image import pad_reflect_multiple, padded_size
from rerevst_tpu.data import native as jax_native

GEOMETRIES = [(37, 53, 8, 16), (64, 112, 64, 64), (20, 24, 8, 8),
              (1, 5, 0, 8)]


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("no C++ compiler: the native library cannot build")


def _frames(rng, n, h, w):
    return (rng.random((n, h, w, 3)) * 255).astype(np.uint8)


def test_library_builds_into_build_dir():
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "rerevst_torch"
    assert native.SOURCE.name == "host_ops.cc"
    assert native.SOURCE.parent.name == "csrc"


@pytest.mark.parametrize("h,w,pad,gran", GEOMETRIES)
def test_preprocess_matches_numpy(rng, h, w, pad, gran):
    frame = _frames(rng, 1, h, w)[0]
    th, tw = padded_size(h, w, pad, gran)
    got = native.preprocess(frame, th, tw, pad)
    want = pad_reflect_multiple(bgr_to_model(frame), pad, gran, (th, tw))
    assert got.shape == want.shape == (1, th, tw, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("h,w,pad,gran", GEOMETRIES)
def test_batch_equals_single_frames(rng, h, w, pad, gran):
    frames = _frames(rng, 3, h, w)
    th, tw = padded_size(h, w, pad, gran)
    got = native.preprocess_batch(frames, th, tw, pad)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], native.preprocess(frames[i], th, tw, pad)[0])


@pytest.mark.parametrize("h,w,pad", [(16, 24, 4), (64, 112, 0), (5, 7, 2)])
def test_postprocess_matches_numpy(rng, h, w, pad):
    x = rng.standard_normal((1, h + 2 * pad + 3, w + 2 * pad + 1, 3)) \
        .astype(np.float32)
    got = native.postprocess(x, h, w, pad)
    want = model_to_bgr(x[:, pad:pad + h, pad:pad + w, :])
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_roundtrip_within_one_count(rng):
    frame = _frames(rng, 1, 30, 40)[0]
    back = native.postprocess(native.preprocess(frame, 48, 56, 4), 30, 40, 4)
    assert np.abs(back.astype(int) - frame.astype(int)).max() <= 1


def test_reflect_is_edge_inclusive():
    """cv2.BORDER_REFLECT repeats the edge pixel (abc -> b a|abc|c b)."""
    frame = np.zeros((2, 3, 3), np.uint8)
    frame[0, 0] = (255, 255, 255)
    out = native.preprocess(frame, 4, 5, pad=1)
    white = (1.0 - 0.485) / 0.229
    assert abs(out[0, 0, 0, 0] - white) < 1e-5


def test_matches_jax_native(rng):
    if not jax_native.available():
        pytest.skip("rerevst_tpu's host runtime did not build")
    frames = _frames(rng, 4, 64, 112)
    th, tw = padded_size(64, 112)
    np.testing.assert_allclose(native.preprocess_batch(frames, th, tw, 64),
                               jax_native.preprocess_batch(frames, th, tw, 64),
                               atol=1e-6, rtol=0)
    x = rng.standard_normal((1, th, tw, 3)).astype(np.float32)
    got = native.postprocess(x, 64, 112, 64)
    want = jax_native.postprocess(x, 64, 112, 64)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_bad_geometry_raises(rng):
    with pytest.raises(ValueError, match="cannot place"):
        native.preprocess(_frames(rng, 1, 10, 10)[0], 12, 30, 4)
    with pytest.raises(ValueError, match="cannot crop"):
        native.postprocess(np.zeros((1, 8, 8, 3), np.float32), 8, 8, 2)


def test_calls_counted_and_numpy_fallback(rng, monkeypatch):
    frames = _frames(rng, 2, 20, 24)
    native.reset_calls()
    a = native.preprocess_batch(frames, 40, 48, 8)
    assert (native.preprocess_batch.calls, native.preprocess.calls) == (1, 0)
    # Without the library every entry point takes the numpy path and
    # counts nothing.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    b = native.preprocess_batch(frames, 40, 48, 8)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    x = rng.standard_normal((1, 40, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.postprocess(x, 20, 24, 8),
                                  model_to_bgr(x[:, 8:28, 8:32]))
    assert native.preprocess_batch.calls == 1
    assert native.postprocess.calls == 0


def test_session_uses_native(rng):
    """Stylization's batch prep and its transfer post-processing go through
    the library; stylize_video's drain keeps model_to_bgr."""
    from pathlib import Path

    ckpt = Path(__file__).resolve().parent.parent / "models" / \
        "demo_plum_4000.msgpack"
    s = Stylization(params=serialization.msgpack_restore(ckpt.read_bytes()),
                    device="cpu", use_global=False)
    s.prepare_style(_frames(rng, 1, 64, 64)[0])
    frames = list(_frames(rng, 2, 64, 112))
    native.reset_calls()
    xs = s._prep_batch_host(frames)
    np.testing.assert_array_equal(
        xs, native.preprocess_batch(np.stack(frames), 192, 256, 64))
    assert native.preprocess_batch.calls == 2
    out = s.transfer_batch(frames)
    assert native.postprocess.calls == 2 and out[0].shape == (64, 112, 3)
    with torch.inference_mode():
        list(s.stylize_video(frames, batch_size=2))
    assert native.postprocess.calls == 2
