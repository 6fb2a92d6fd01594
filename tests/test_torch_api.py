"""rerevst_torch.api.Stylization vs rerevst_tpu.api.Stylization.

The whole two-pass pipeline — style prep, Pass 1 on the sampled unpadded
frames, Pass 2 on reflect-padded batches with a ragged last batch — runs on
a seeded 9-frame 64x112 clip (padded to 192x256) with the bundled checkpoint
in fp32 through both sessions.  Tolerance: uint8 frames within 1 count
everywhere (the ROADMAP's end-to-end bar): the fp32 pipelines differ by
about 1e-6 of the pixel scale, which flips an occasional rounding.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from flax import serialization

from rerevst_torch import kernels
from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig
from rerevst_tpu.api import Stylization as JaxStylization

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"


def _clip(n=9, h=64, w=112, seed=0):
    """A smooth pattern that moves a few pixels per frame (BGR uint8)."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(n):
        img = np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                           + (yy + i) * f[c, 1] + c)
                        for c in range(3)], -1)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def _style(seed=1, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 5 + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1)
    img += rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    return serialization.msgpack_restore(CKPT.read_bytes())


@pytest.fixture(scope="module")
def jax_frames(params):
    s = JaxStylization(params=params)
    s.prepare_style(_style())
    return list(s.stylize_video(_clip(), batch_size=4))


@pytest.fixture
def session(params):
    s = Stylization(params=params, device="cpu")
    s.prepare_style(_style())
    return s


def test_stylize_video_matches_jax(session, jax_frames):
    got = list(session.stylize_video(_clip(), batch_size=4))
    assert len(got) == len(jax_frames) == 9
    for a, b in zip(got, jax_frames):
        assert a.shape == b.shape == (64, 112, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1
    assert np.stack(got).std() > 1.0  # not a constant image
    assert session.pass1_mode == "batched"


def test_from_checkpoint_path_equals_from_params(session):
    s = Stylization(str(CKPT), device="cpu")
    s.prepare_style(_style())
    clip = _clip(n=3)
    a = list(s.stylize_video(clip, batch_size=2))
    b = list(session.stylize_video(clip, batch_size=2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_uploads_fetches_and_geometry(session):
    """Pass-1 frames go up unpadded in one upload per chunk; Pass-2 batches
    go up padded to the locked geometry, one upload per batch (the ragged
    tail padded to the batch shape); every fetch is cropped on the device
    to the real frames."""
    ups, fetches = [], []
    up, fetch = session._upload, session._fetch
    session._upload = lambda x: ups.append(x.shape) or up(x)
    session._fetch = lambda x, *ready: (fetches.append(tuple(x.shape))
                                        or fetch(x, *ready))
    kernels.reset_launches()
    out = list(session.stylize_video(_clip(), batch_size=4))
    assert len(out) == 9
    # sampled frames 0 and 8, raw geometry
    assert ups[0] == (2, 64, 112, 3)
    assert ups[1:] == [(4, 192, 256, 3)] * 3
    assert fetches == [(4, 64, 112, 3), (4, 64, 112, 3), (1, 64, 112, 3)]
    assert session._pad_hw == (192, 256)
    assert kernels.launch_counts() == {"norm_affine_clamp": 0,
                                       "dynamic_filter_pair": 0,
                                       "conv3x3_implicit_gemm": 0,
                                       "conv3x3_pairlane": 0}


def test_first_frame_locks_geometry(session):
    clip = _clip(n=3)
    for f in clip:
        session.add(f)
    session.compute()
    out = session.transfer(clip[0])
    assert out.shape == (64, 112, 3) and session._pad_hw == (192, 256)
    # A later, smaller frame is padded to the LOCKED geometry.
    small = clip[1][:60, :100]
    session.transfer_batch([small])
    assert session._pad_hw == (192, 256)
    # clean() re-locks on the next clip's first frame.
    session.clean()
    assert session._pad_hw is None


def test_reference_surface_equals_batched(session):
    clip = _clip()
    batched = list(session.stylize_video(clip, batch_size=4))
    session.clean()
    for i in (0, 8):
        session.add(clip[i])
    session.compute()
    for i in (0, 5):
        d = np.abs(session.transfer(clip[i]).astype(np.int16)
                   - batched[i].astype(np.int16))
        assert d.max() <= 1
    pair = session.transfer_batch(clip[:2], pad_to=4)
    assert len(pair) == 2


def test_too_many_samples_raises(session, monkeypatch):
    """Above STREAMING_THRESHOLD sampled frames Pass 1 no longer raises: it
    spills to the host spool and streams the statistics, in stylize_video
    and in an add() session (the threshold lowered to 2 to keep the clip
    small; tests/test_torch_streaming.py runs 65 samples)."""
    monkeypatch.setattr(Stylization, "STREAMING_THRESHOLD", 2)
    clip = _clip(n=1) * (8 * 3 + 1)  # 4 sampled frames
    out = list(session.stylize_video(clip, batch_size=4))
    assert len(out) == len(clip) and session.pass1_mode == "streaming-spill"
    session.clean()
    frame = _clip(n=1)[0]
    for _ in range(Stylization.STREAMING_THRESHOLD):
        session.add(frame)
    assert session._patch_spill is None
    session.add(frame)
    assert session._patch_spill is not None and not session._patches
    session.compute()
    assert session.pass1_mode == "streaming-spill"
    assert session._patch_spill is None


def test_default_device_raises_without_cuda(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Stylization(params=params)


@pytest.mark.parametrize("call,match", [
    (lambda p: Stylization(params=p, mesh=object(), device="cpu"),
     "Queue 1 item 7"),
    (lambda p: Stylization(params=p, device="cpu").use_aot("x.rvaot"),
     "Queue 1 item 7"),
    (lambda p: Stylization(params=p, device="cpu").prepare_global(
        iter(_clip(n=2))), None),
])
def test_later_slices_raise(params, call, match):
    """The mesh and AOT bundles raise, naming their ROADMAP item; an unsized
    iterable passed to prepare_global (once a raise, now ported) spills and
    streams instead."""
    if match is None:
        s = Stylization(params=params, device="cpu")
        s.prepare_style(_style())
        s.prepare_global(iter(_clip(n=2)))
        assert s.pass1_mode == "streaming-spill"
        assert set(s.stats.norms) == {"pre", "ada4", "ada3", "ada2", "ada1",
                                      "res4a", "res4b", "res3a", "res3b",
                                      "res2a", "res2b"}
        return
    with pytest.raises(NotImplementedError, match=match):
        call(params)


def test_file_inputs_and_order_raise(session, tmp_path):
    with pytest.raises(FileNotFoundError, match="no frames match"):
        list(session.stylize_video(str(tmp_path / "clip" / "*.png")))
    fresh = Stylization(params={"decoder": {}}, device="cpu",
                        infer=InferenceConfig())
    with pytest.raises(RuntimeError, match="prepare_style"):
        fresh.compute()


def test_top_level_surface():
    """The JAX package's top-level names resolve in the port; importing the
    package loads neither cv2 nor JAX (a fresh process)."""
    import subprocess
    import sys

    import rerevst_torch
    from rerevst_torch.models.transformer import TransformerNet
    from rerevst_torch.multistyle import MultiStylization

    assert rerevst_torch.Stylization is Stylization
    assert rerevst_torch.MultiStylization is MultiStylization
    assert rerevst_torch.TransformerNet is TransformerNet
    assert rerevst_torch.__version__ == "0.1.0"
    assert rerevst_torch.LossConfig().gan_mode == "lsgan"
    assert rerevst_torch.TrainConfig().batch_size == 4
    with pytest.raises(AttributeError):
        rerevst_torch.NoSuchThing  # noqa: B018
    code = ("import sys, rerevst_torch; rerevst_torch.InferenceConfig; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'jax', 'jaxlib', 'flax', 'rerevst_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("global_stats", [False, True],
                         ids=["per_frame", "global"])
def test_transformer_net_stylize_matches_jax(params, global_stats):
    """``TransformerNet``'s methods against the JAX class's on the same
    fp32 weights: ``stylize`` (desaturate, encode, then ``decode``, or
    ``decode_global`` under the statistics that ``collect`` freezes over
    three encoded frames) within 1 uint8 count."""
    import jax
    import jax.numpy as jnp

    from rerevst_torch import TransformerNet
    from rerevst_torch.data.transforms import bgr_to_model
    from rerevst_torch.io.convert import from_jax_params
    from rerevst_torch.ops.image import to_uint8
    from rerevst_tpu.models.transformer import TransformerNet as JNet
    from rerevst_tpu.ops.image import to_uint8 as jto_uint8

    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tp = from_jax_params(jax.tree.map(np.array, jp), device="cpu")
    frames = np.concatenate([bgr_to_model(f)
                             for f in _clip(n=3, h=64, w=64)])
    style = bgr_to_model(_style())
    net, jnet = TransformerNet(), JNet()
    with torch.no_grad():
        sf = net.encode_style(tp, torch.from_numpy(style))
        stats = None
        if global_stats:
            feats = net.encode_content(tp, torch.from_numpy(frames))
            stats = net.collect(tp, feats, sf)
        got = to_uint8(net.stylize(tp, torch.from_numpy(frames[:1]), sf,
                                   stats)).numpy()
    jsf = jnet.encode_style(jp, jnp.asarray(style))
    jstats = jnet.collect(jp, jnet.encode_content(jp, jnp.asarray(frames)),
                          jsf) if global_stats else None
    want = np.asarray(jto_uint8(jnet.stylize(jp, jnp.asarray(frames[:1]),
                                             jsf, jstats)))
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert net.init_params(torch.Generator().manual_seed(0),
                           with_loss_net=False).keys() == {
        "encoder", "encoder_style", "decoder"}


def test_bf16_checkpoint_statistics_match_jax_session(params, session,
                                                      jax_frames):
    """The bundled checkpoint's bf16 weights as both sessions keep them:
    the statistics Pass 1 freezes over five frames match the JAX session's
    at rtol = atol = 2e-4 (the JAX package's streamed-against-batched bar).
    The decoder's upsample convs sum their 3x3 taps in the weights' bf16,
    as the JAX package's ``upsample2x_conv3x3`` does; summed in fp32 the
    statistics leave this bar from res4a on (``scripts/probe_bf16_fold.py``
    prints where).  The frames of ``jax_frames`` came from the same JAX
    session kind."""
    assert session.params["decoder"]["res4"]["conv1"]["w"].dtype == \
        torch.bfloat16
    js = JaxStylization(params=params)
    js.prepare_style(_style())
    clip = _clip()
    session.clean()
    for f in clip[:5]:
        session.add(f)
        js.add(f)
    session.compute()
    js.compute()
    for key, st in js.stats.norms.items():
        for field in st._fields:
            np.testing.assert_allclose(
                getattr(session.stats.norms[key], field).numpy(),
                np.asarray(getattr(st, field)), rtol=2e-4, atol=2e-4,
                err_msg=f"{key}.{field}")
    for key, f in js.stats.filters.items():
        np.testing.assert_allclose(session.stats.filters[key].numpy(),
                                   np.asarray(f), rtol=2e-4, atol=2e-4,
                                   err_msg=key)
