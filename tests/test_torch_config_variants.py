"""The config variants of rerevst_torch vs rerevst_tpu: the product
``precision``, the six ``fp32_mix`` regions with ``mix_precision``, the luma
fold and ``parity_packed``; their AOT bundles and a train step.

* ``fp32_mix`` (out, res2, dec, enc, full, body) in f16 and bf16 sessions,
  through Pass 1 + ``decode_global`` and through the per-frame ``decode``,
  each side on its own statistics: the output dtype is JAX's, the values
  agree within the tolerances below (normalized units, outputs of scale
  about 3), each region's output is finite and differs from the port's
  'none' run.  f16: mean |d| <= 2e-3 and max |d| <= 1.5e-2; bf16: mean |d|
  <= 1.5e-2 and max |d| <= 0.1 (the port computes its norms in fp32, the
  JAX package bf16 ones in bf16: a recorded difference).  f16 'full' (fp32
  encoder and decoder) also gives uint8 frames within 1 count.
* ``precision`` default / high / highest in fp32 ``Stylization`` sessions
  (global and per-frame) against the JAX package's functions at the same
  precision on the same inputs: within 1e-4 of the output's scale and uint8
  frames within 1 count (on the CPU every level computes exact fp32 in both
  packages).  The route: at 'high' and 'default' every 3x3 SAME conv site
  reaches ``rerevst::conv3x3_implicit_gemm`` with ``passes`` 3 and 1, and
  no 3x3 SAME library conv is left; at 'highest' no site reaches the op.
* The luma fold: ``rgb_to_luma01`` and ``encode_luma`` against JAX (fp32
  to 1e-5 of the scale, f16 to 2e-2 of it); the gate; an H-sharded session
  on a logical 4-shard CPU mesh against the unsharded one (f16, 1e-2 of
  the scale: a border map cut at the shard edges is off by O(1)).
* ``parity_packed``: against the JAX package's packed route (fp32, 1e-4 of
  the scale: reassociation), and the port's frames bit-equal to its own
  session with pair-lane, tiles and the luma fold off.
* AOT bundles refuse sessions of another ``fp32_mix``, and an 'out' bundle
  serves its fp32 frames as eager does.
* One train step at ``precision='high'`` (64x64, flow_iter 2) against the
  JAX step at the same config: metrics to 1e-4 relative, gradients to 1e-3
  of each tensor's max-abs (``tests/test_torch_train_step.py``'s bars).
* Sessions: f16 'body' and 'out' on a logical 2-shard CPU mesh against one
  device (uint8 within 1 count), the streamed Pass 1 of a 'body' session
  against the batched one (rtol = atol = 2e-4, the streaming bar), and
  variant sessions end to end.
"""

import collections
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.api import Stylization
from rerevst_torch.config import (
    InferenceConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from rerevst_torch.data.transforms import bgr_to_model, model_to_bgr
from rerevst_torch.io import aot as A
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import layers as L
from rerevst_torch.models import transformer as T
from rerevst_torch.models import vgg
from rerevst_torch.ops.image import crop_back, rgb_to_luma01
from rerevst_torch.parallel import frame_mesh
from rerevst_torch.parallel.spatial import stylize_spatial_sharded
from rerevst_torch.train.state import init_train_state, tree_leaves
from rerevst_torch.train.step import compute_losses
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import ModelConfig as JModelConfig
from rerevst_tpu.config import TrainConfig as JTrainConfig
from rerevst_tpu.models import transformer as jT
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.ops import image as jimage
from rerevst_tpu.ops.warp import flow_warp as jflow_warp
from rerevst_tpu.train.step import compute_losses as jcompute_losses

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
REGIONS = ("out", "res2", "dec", "enc", "full", "body")
DTYPES = {"f16": (torch.float16, jnp.float16),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
#: (mean, max) |port - JAX| of the normalized outputs, per storage dtype.
TOL = {"f16": (2e-3, 1.5e-2), "bf16": (1.5e-2, 0.1)}


def _smooth_images(rng, n, h, w):
    """Smooth seeded images, ImageNet-normalized NHWC fp32."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.03, 0.2, (3, 2))
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([0.5 + 0.4 * np.sin(xx * f[c, 0] + yy * f[c, 1] + ph[c])
                        for c in range(3)], -1)
        out.append((img - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225])
    return np.stack(out).astype(np.float32)


def _bgr(h, w, seed):
    """A smooth seeded BGR uint8 image."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx * f[c, 0] + yy * f[c, 1] + c)
                    for c in range(3)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _counts(a, b):
    return np.abs(model_to_bgr(np.asarray(a, np.float32)).astype(np.int16)
                  - model_to_bgr(np.asarray(b, np.float32)).astype(np.int16))


@pytest.fixture(scope="module")
def data():
    """The bundled checkpoint as stored (bf16) and upcast to fp32, a seeded
    64x64 style and two 64x64 frames (normalized)."""
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    rng = np.random.default_rng(5)
    return {"tree": tree, "jp": jp, "tp": from_jax_params(jp, device="cpu"),
            "style": _smooth_images(rng, 1, 64, 64),
            "frames": _smooth_images(rng, 2, 64, 64)}


def _jax_run(d, jcfg, glob):
    js = jT.encode_style(d["jp"], jnp.asarray(d["style"]), jcfg)
    f = jT.encode_content(d["jp"], jnp.asarray(d["frames"]), jcfg)
    if glob:
        st = jT.collect_stats(d["jp"]["decoder"], f, js, jcfg)
        return np.asarray(jT.decode_global(d["jp"]["decoder"], f, js, st,
                                           jcfg))
    return np.asarray(jT.decode(d["jp"]["decoder"], f, js, jcfg))


def _port_run(d, cfg, glob):
    with torch.no_grad():
        s = T.encode_style(d["tp"], torch.from_numpy(d["style"]), cfg)
        f = T.encode_content(d["tp"], torch.from_numpy(d["frames"]), cfg)
        if glob:
            st = T.collect_stats(d["tp"]["decoder"], f, s, cfg)
            return T.decode_global(d["tp"]["decoder"], f, s, st, cfg)
        return T.decode(d["tp"]["decoder"], f, s, cfg)


@pytest.fixture(scope="module")
def mix_runs(data):
    """Every (dtype, region, graph): JAX's output and the port's; and the
    port's 'none' runs."""
    out = {}
    for dt, (tdt, jdt) in DTYPES.items():
        for glob in (True, False):
            out[dt, "none", glob] = (None, _port_run(
                data, ModelConfig(dtype=tdt), glob))
            for region in REGIONS:
                out[dt, region, glob] = (
                    _jax_run(data, JModelConfig(dtype=jdt, fp32_mix=region),
                             glob),
                    _port_run(data, ModelConfig(dtype=tdt, fp32_mix=region),
                              glob))
    return out


@pytest.mark.parametrize("graph", ["global", "per_frame"])
@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fp32_mix_region_matches_jax(mix_runs, dt, region, graph):
    want, got = mix_runs[dt, region, graph == "global"]
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert got.dtype == (torch.float32 if region in ("out", "res2", "dec",
                                                     "full")
                         else DTYPES[dt][0])
    g = got.float().numpy()
    assert np.isfinite(g).all()
    err = np.abs(g - np.asarray(want, np.float32))
    mean_tol, max_tol = TOL[dt]
    assert err.mean() <= mean_tol and err.max() <= max_tol, \
        (err.mean(), err.max())
    none = mix_runs[dt, "none", graph == "global"][1].float().numpy()
    assert not np.array_equal(g, none)  # the region took effect
    if dt == "f16" and region == "full":
        assert _counts(g, want).max() <= 1


def test_fp32_mix_inactive_in_fp32_sessions(data):
    """A region is active only in a 16-bit session: fp32 frames equal the
    plain fp32 session's, as in the JAX package."""
    ref = _port_run(data, ModelConfig(), True)
    for region in ("out", "full", "body"):
        assert torch.equal(_port_run(data, ModelConfig(fp32_mix=region),
                                     True), ref)


class _CountConvs(TorchDispatchMode):
    """Counts ``rerevst::conv3x3_implicit_gemm`` calls by ``passes``,
    ``rerevst::conv3x3_wgrad`` calls, and the library's 3x3 SAME convs
    (stride 1, padding 1, no groups) that ran outside them."""

    def __init__(self):
        super().__init__()
        self.op = collections.Counter()
        self.wgrad = 0
        self.library_3x3 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.rerevst.conv3x3_implicit_gemm.default:
            self.op[args[3] if len(args) > 3 else kwargs.get("passes", 3)] \
                += 1
        elif func is torch.ops.rerevst.conv3x3_wgrad.default:
            self.wgrad += 1
        elif func in (torch.ops.aten.conv2d.default,
                      torch.ops.aten.convolution.default):
            # conv2d(x, w, b, stride, padding, dilation, groups) under
            # inference mode, convolution(.., transposed, output_padding,
            # groups) otherwise.
            g = 8 if func is torch.ops.aten.convolution.default else 6
            arg = dict(zip(("stride", "padding"), args[3:5]), **kwargs)
            stride = list(arg.get("stride", [1, 1]))
            pad = list(arg.get("padding", [0, 0]))
            groups = args[g] if len(args) > g else kwargs.get("groups", 1)
            if tuple(args[1].shape[-2:]) == (3, 3) and stride in ([1], [1, 1]) \
                    and pad in ([1], [1, 1]) and groups == 1:
                self.library_3x3 += 1
        return func(*args, **kwargs)


PREC_FRAMES = [_bgr(64, 112, s) for s in (10, 11, 12)]
PREC_STYLE = _bgr(64, 64, 13)


def _session_run(tree, cfg, glob):
    """A CPU session over PREC_FRAMES: (its Pass-2 output on the prepped
    batch, the prepped batch, the convs it ran)."""
    counter = _CountConvs()
    with counter:
        s = Stylization(params=tree, cfg=cfg, device="cpu", use_global=glob)
        s.prepare_style(PREC_STYLE)
        if glob:
            for f in PREC_FRAMES:
                s.add(f)
            s.compute()
        x = torch.from_numpy(s._prep_batch_host(PREC_FRAMES[:2]))
        y = s._stylize(x)
    return y, x, counter


@pytest.fixture(scope="module")
def prec_runs(data):
    """The port's fp32 sessions and the JAX package's functions on the same
    inputs (the stored bf16 weights on both sides), per precision and
    graph."""
    jp = data["tree"]
    out = {}
    for prec in ("highest", "high", "default"):
        jcfg = JModelConfig(precision=prec)
        for glob in (True, False):
            y, x, counter = _session_run(data["tree"],
                                         ModelConfig(precision=prec), glob)
            js = jT.encode_style(jp, jnp.asarray(bgr_to_model(PREC_STYLE)),
                                 jcfg)
            f = jT.encode_content(jp, jnp.asarray(x.numpy()), jcfg)
            if glob:
                pass1 = jT.encode_content(jp, jnp.asarray(np.concatenate(
                    [bgr_to_model(fr) for fr in PREC_FRAMES])), jcfg)
                st = jT.collect_stats(jp["decoder"], pass1, js, jcfg)
                want = jT.decode_global(jp["decoder"], f, js, st, jcfg)
            else:
                want = jT.decode(jp["decoder"], f, js, jcfg)
            out[prec, glob] = (y.numpy(), np.asarray(want), counter)
    return out


@pytest.mark.parametrize("graph", ["global", "per_frame"])
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
def test_precision_session_matches_jax(prec_runs, prec, graph):
    got, want, _ = prec_runs[prec, graph == "global"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    g = crop_back(got, 64, 112)
    w = crop_back(want, 64, 112)
    assert _counts(g, w).max() <= 1


@pytest.mark.parametrize("graph", ["global", "per_frame"])
def test_precision_route_by_passes(prec_runs, graph):
    """'high' and 'default' send every 3x3 SAME conv site to the op with
    passes 3 and 1 (as many sites as 'highest' runs through the library);
    'highest' sends none."""
    glob = graph == "global"
    sites = prec_runs["highest", glob][2].library_3x3
    assert sites == (76 if glob else 40)  # the sites of _session_run
    assert not prec_runs["highest", glob][2].op
    for prec, passes in (("high", 3), ("default", 1)):
        c = prec_runs[prec, glob][2]
        assert dict(c.op) == {passes: sites} and c.library_3x3 == 0


def test_kernel_route_differentiates():
    """A 'high' fp32 conv on a tensor that needs a gradient differentiates
    through the kernel route (``Conv3x3Fn``: its input gradient on the conv
    op, its weight gradient on the wgrad op), with the gradients of the
    library's exact conv; under ``no_grad`` it is the op alone."""
    p = {"w": torch.randn(3, 3, 4, 5, requires_grad=True),
         "b": torch.zeros(5, requires_grad=True)}
    x = torch.randn(1, 6, 7, 4, requires_grad=True)
    g = torch.randn(1, 6, 7, 5)
    with _CountConvs() as c:
        y = L.conv2d(p, x, padding=1, precision="high")
        got = torch.autograd.grad(y, (x, p["w"], p["b"]), g)
    assert dict(c.op) == {3: 2} and c.wgrad == 1 and c.library_3x3 == 0
    want = torch.autograd.grad(L.conv2d(p, x, padding=1),
                               (x, p["w"], p["b"]), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        y = L.conv2d(p, x, padding=1, precision="high")
    assert y.grad_fn is None
    torch.testing.assert_close(y, L.conv2d(p, x.detach(), padding=1),
                               rtol=1e-5, atol=1e-5)


def test_precision_for_and_flags():
    """``precision_for`` as the JAX package's; the exact-products scope
    keeps both TF32 flags off while any thread is inside it and leaves them
    as it found them, nested and across 16 threads switching every
    microsecond."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from rerevst_torch.ops import precision as P

    assert P.precision_for(torch.float32) == "highest"
    assert P.precision_for(torch.bfloat16) == "default"
    assert P.precision_for(torch.float16, "high") == "high"
    assert L.precision_for is P.precision_for
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)

    def inside(_):
        seen = set()
        for _ in range(50):
            with P.exact_products():
                with P.exact_products():
                    seen.add((torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            seen = set().union(*ex.map(inside, range(64), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert seen == {(False, False)}
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


# ---------------------------------------------------------------------------
# The luma fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "f16"])
def test_encode_luma_matches_jax(data, dt):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "f16": (torch.float16, jnp.float16)}[dt]
    frames = data["frames"]
    luma = rgb_to_luma01(torch.from_numpy(frames))
    jluma = jimage.rgb_to_luma01(jnp.asarray(frames))
    np.testing.assert_allclose(luma.numpy(), np.asarray(jluma), rtol=0,
                               atol=1e-6)
    with torch.no_grad():
        got = vgg.encode_luma(data["tp"]["encoder"], luma.to(tdt))
    want = np.asarray(jV.encode_luma(data["jp"]["encoder"],
                                     jluma.astype(jdt)), np.float32)
    assert got.dtype == tdt
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    # The fold is the encoder of the desaturated frame, reassociated.
    with torch.no_grad():
        plain = vgg.encode(data["tp"]["encoder"], T.rgb_to_luma_reversed(
            torch.from_numpy(frames)).to(tdt))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=tol * np.abs(want).max())


def test_luma_fold_gate(data, monkeypatch):
    """As ``tests/test_luma_fold.py``'s gate: fp32 never folds, f16 folds
    when asked, and an fp32 region, the packed and the pair-lane routes and
    colour (training) input close the gate."""
    calls = []
    orig = vgg.encode_luma
    monkeypatch.setattr(vgg, "encode_luma",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    img = torch.from_numpy(data["frames"][:1, :16, :16])

    def folds(**kw):
        calls.clear()
        with torch.no_grad():
            T.encode_content(data["tp"], img, ModelConfig(**kw))
        return bool(calls)

    assert not folds(dtype=torch.float32, luma_fold=True)
    assert folds(dtype=torch.float16, luma_fold=True)
    assert folds(dtype=torch.bfloat16, luma_fold=True)
    assert folds(dtype=torch.float16, luma_fold=True, spatial_tiles=2)
    assert not folds(dtype=torch.float16)
    assert not folds(dtype=torch.float16, luma_fold=True, fp32_mix="out")
    assert not folds(dtype=torch.float16, luma_fold=True, parity_packed=True)
    assert not folds(dtype=torch.float16, luma_fold=True, pairlane=True)
    calls.clear()
    with torch.no_grad():
        T.encode_content(data["tp"], img,
                         ModelConfig(dtype=torch.float16, luma_fold=True),
                         desaturate=False)
    assert not calls
    for kw in ({}, {"fp32_mix": "out"}, {"parity_packed": True}):
        jcfg = JModelConfig(dtype=jnp.float16, luma_fold=True, **kw)
        assert T.luma_fold_on(ModelConfig(dtype=torch.float16,
                                          luma_fold=True, **kw)) == \
            (jcfg.fp32_mix == "none" and not jcfg.parity_packed)


def test_luma_fold_h_sharded_matches_unsharded(data):
    """The fold on a logical 4-shard CPU mesh (16 rows a shard): the border
    map is the whole frame's, so the sharded Pass 2 equals the unsharded
    one."""
    cfg = ModelConfig(dtype=torch.float16, luma_fold=True)
    tp = data["tp"]
    frames = torch.from_numpy(data["frames"][:1])
    with torch.no_grad():
        s = T.encode_style(tp, torch.from_numpy(data["style"]), cfg)
        st = T.collect_stats(tp["decoder"],
                             T.encode_content(tp, frames, cfg), s, cfg)
        ref = T.stylize(tp, frames, s, cfg, st).float().numpy()
    mesh = frame_mesh(4, devices=["cpu"] * 4)
    try:
        with torch.inference_mode():
            got = stylize_spatial_sharded(tp, frames, s, st, cfg, mesh)
    finally:
        mesh.close()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# parity_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["global", "per_frame"])
def test_parity_packed_matches_jax_packed_route(data, graph):
    glob = graph == "global"
    want = _jax_run(data, JModelConfig(parity_packed=True), glob)
    got = _port_run(data, ModelConfig(parity_packed=True), glob).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert _counts(got, want).max() <= 1


def test_parity_packed_is_the_plain_route(data):
    """f16 with the packed flag and pair-lane, tiles and the luma fold all
    asked for: the packed route closes all three, so the frames are
    bit-equal to the session with them off."""
    packed = dict(dtype=torch.float16, parity_packed=True, pairlane=True,
                  spatial_tiles=2, luma_fold=True)
    plain = ModelConfig(dtype=torch.float16)
    for glob in (True, False):
        assert torch.equal(_port_run(data, ModelConfig(**packed), glob),
                           _port_run(data, plain, glob))


# ---------------------------------------------------------------------------
# AOT bundles
# ---------------------------------------------------------------------------

def test_aot_bundles_refuse_another_fp32_mix(tmp_path):
    """A bundle exported under fp32_mix='out' is refused by a 'none'
    session and the reverse; the 'out' bundle serves its own session's
    fp32 frames as eager computes them."""
    frame = _bgr(64, 64, 20)
    sessions, paths = {}, {}
    for mix in ("out", "none"):
        s = Stylization(checkpoint=str(CKPT), device="cpu",
                        cfg=ModelConfig(dtype=torch.float16, fp32_mix=mix))
        s.prepare_style(_bgr(64, 64, 21))
        s.add(frame)
        s.compute()
        paths[mix] = str(tmp_path / f"{mix}.rvaot")
        A.save_bundle(paths[mix], s, (64, 64), batches=(1,),
                      platforms=("cpu",))
        sessions[mix] = s
    for mix, other in (("out", "none"), ("none", "out")):
        with pytest.raises(ValueError, match="model switches"):
            sessions[other].use_aot(paths[mix])
    s = sessions["out"]
    x = torch.from_numpy(bgr_to_model(frame))  # the bundle's 64x64 input
    eager = s._stylize(x)
    s.use_aot(paths["out"])
    got = s._stylize(x)
    assert s.pass2_mode == "aot" and got.dtype == torch.float32
    assert torch.equal(got, eager)


# ---------------------------------------------------------------------------
# Training at precision 'high'
# ---------------------------------------------------------------------------

def test_train_step_at_high_precision_matches_jax(data):
    """One step's losses and gradients at ``precision='high'``, both
    packages at HIGH (which the CPU computes exactly): the port's step
    reaches the conv op with three passes, forward and for the input
    gradients, and the wgrad op for the weight gradients, and its relaxed
    loss runs the library's exact convs, as JAX pins it to HIGHEST."""
    jp = jax.tree.map(np.array, data["jp"])
    jp["vgg_loss"] = jax.tree.map(np.asarray, jV.init_vgg_params(
        jax.random.PRNGKey(0), scheme="he_relu"))
    rng = np.random.default_rng(5)
    content = _smooth_images(rng, 2, 64, 64)
    style = _smooth_images(rng, 2, 64, 64)
    flow = (rng.standard_normal((2, 64, 64, 2)) * 2).astype(np.float32)
    second = np.asarray(jflow_warp(jnp.asarray(content), jnp.asarray(flow),
                                   mode="nearest"))
    extra = {"Second": second, "FakeFlow": flow}
    lcfg = dict(flow_iter=2, data_sigma=False)
    jcfg = JTrainConfig(model=JModelConfig(precision="high"),
                        loss=JLossConfig(**lcfg))

    def loss_fn(p):
        total, (metrics, _) = jcompute_losses(
            p, jnp.asarray(content), jnp.asarray(style),
            jax.random.PRNGKey(0), jcfg,
            {k: jnp.asarray(v) for k, v in extra.items()})
        return total, metrics

    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    cfg = TrainConfig(model=ModelConfig(precision="high"),
                      loss=LossConfig(**lcfg))
    state = init_train_state(from_jax_params(jax.tree.map(np.array, jp),
                                             device="cpu"), cfg)
    with _CountConvs() as fwd:
        total, (metrics, _) = compute_losses(
            state.params, torch.from_numpy(content), torch.from_numpy(style),
            None, cfg, {k: torch.from_numpy(np.array(v))
                        for k, v in extra.items()})
    assert set(fwd.op) == {3} and fwd.op[3] > 0 and fwd.wgrad == 0
    assert fwd.library_3x3 > 0  # the relaxed loss's VGG, exact
    for k, v in jmetrics.items():
        got = float(metrics[k].detach())
        rel = abs(got - float(v)) / max(abs(float(v)), 1e-12)
        assert rel < 1e-4, (k, got, float(v))
    sites = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
             ("encoder", "conv4_1", "w")]
    leaves = dict(((k,) + p, leaf) for k in state.params
                  for p, leaf in tree_leaves(state.params[k]))
    with _CountConvs() as bwd:
        grads = torch.autograd.grad(total, [leaves[s] for s in sites])
    assert set(bwd.op) == {3} and bwd.op[3] > 0 and bwd.wgrad > 0
    for site, g in zip(sites, grads):
        want = jgrads
        for k in site:
            want = want[k]
        want = np.asarray(want)
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-3, (site, err)


def test_model_config_variant_cells_run_end_to_end(data):
    """Every variant of the config runs a session end to end (global and
    per-frame) and gives uint8 frames of the input's shape."""
    frames = [_bgr(64, 112, s) for s in (30, 31)]
    for cfg in (ModelConfig(dtype=torch.bfloat16, fp32_mix="body",
                            mix_precision="high"),
                ModelConfig(dtype=torch.float16, luma_fold=True,
                            parity_packed=True),
                ModelConfig(precision="default", spatial_tiles=2)):
        for glob in (True, False):
            s = Stylization(params=data["tree"], cfg=cfg, device="cpu",
                            use_global=glob,
                            infer=InferenceConfig(batch_size=2))
            s.prepare_style(_bgr(64, 64, 32))
            out = list(s.stylize_video(frames))
            assert len(out) == 2 and out[0].shape == (64, 112, 3) \
                and out[0].dtype == np.uint8


@pytest.mark.parametrize("mix", ["body", "out"])
def test_mesh_session_with_mix_region(data, mix):
    """A 16-bit session with an fp32 region on a logical 2-shard CPU mesh
    (sharded Pass 1 on the features' dtype, frame-sharded Pass 2): the
    frames of the session without the mesh."""
    frames = [_bgr(64, 112, s) for s in (40, 41, 42)]
    cfg = ModelConfig(dtype=torch.float16, fp32_mix=mix)
    out = {}
    mesh = frame_mesh(2, devices=["cpu"] * 2)
    try:
        for name, m in (("one", None), ("mesh", mesh)):
            s = Stylization(params=data["tree"], cfg=cfg, device="cpu",
                            mesh=m, infer=InferenceConfig(sample_interval=2,
                                                          batch_size=2))
            s.prepare_style(_bgr(64, 64, 43))
            out[name] = list(s.stylize_video(frames))
            if m is not None:
                assert s.pass1_mode == "sharded"
    finally:
        mesh.close()
    for a, b in zip(out["mesh"], out["one"]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_streaming_pass1_keeps_fp32_region_features(data):
    """The streamed Pass 1 of a 16-bit 'body' session runs on the fp32
    features ``encode_content`` gives, as the batched one does: its
    statistics match within the streaming bar (rtol = atol = 2e-4)."""
    from rerevst_torch.parallel.streaming import collect_stats_streaming

    cfg = ModelConfig(dtype=torch.float16, fp32_mix="body")
    tp = data["tp"]
    with torch.no_grad():
        s = T.encode_style(tp, torch.from_numpy(data["style"]), cfg)
        f = T.encode_content(tp, torch.from_numpy(data["frames"]), cfg)
        want = T.collect_stats(tp["decoder"], f, s, cfg)
    assert f.dtype == torch.float32
    got = collect_stats_streaming(tp["decoder"], f.numpy(), s, cfg,
                                  chunk_size=1)
    for k, st in want.norms.items():
        for a, b in zip(got.norms[k], st):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    for k, v in want.filters.items():
        torch.testing.assert_close(got.filters[k], v, rtol=2e-4, atol=2e-4)


def test_mix_cfg_is_jax_mix_cfg():
    """``_mix_cfg`` and the region switch as the JAX package's."""
    for mix in REGIONS:
        cfg = ModelConfig(dtype=torch.bfloat16, fp32_mix=mix,
                          mix_precision="high")
        m = T._mix_cfg(cfg)
        assert m.dtype == torch.float32 and m.precision == "high"
        assert T._tail(cfg) == mix
        assert T._tail(dataclasses.replace(cfg, dtype=torch.float32)) \
            == "none"
        assert T.content_dtype(cfg) == (
            torch.float32 if mix in ("full", "body") else torch.bfloat16)
