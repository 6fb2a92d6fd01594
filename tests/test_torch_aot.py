"""rerevst_torch.io.aot: AOT Pass-2 bundles (``torch.export``) vs eager and vs
rerevst_tpu.

The port's counterparts of ``tests/test_aot.py`` on synthesized frames: a
bundle's round trip is bit-equal to the eager path on the CPU at batches 1
and 2; a style of another geometry runs through the symbolic style dims;
the session's AOT path, its eager fallback on geometry, and the bundle
dropped (with a warning) on statistics of another structure; a dtype
mismatch refused at ``use_aot``; ``convert --export-aot`` from the CLI;
garbage and a JAX ``RVAOT001`` bundle refused by their magic.  Beside them:
the AOT frames against ``rerevst_tpu``'s ``_stylize`` on the same inputs
(uint8 within 1 count: the fp32 pipelines differ by about 1e-6 of the pixel
scale); the exported graph's kernel nodes (11 ``rerevst::norm_affine_clamp``
and 3 ``rerevst::dynamic_filter_pair``; 3 ``rerevst::conv3x3_pairlane`` on
the pair-lane route); the graph run with cuDNN's and cuBLAS's TF32 off,
as the eager fp32 products are; a CPU bundle refused by a session on a
device the bundle has no graph for; and ``torch.library.opcheck`` of each kernel op's
CPU implementation and fake at small shapes.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import convert
from rerevst_torch.api import Stylization
from rerevst_torch.config import ModelConfig
from rerevst_torch.data.transforms import bgr_to_model, model_to_bgr
from rerevst_torch.io import aot as A

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
OPS = ("norm_affine_clamp", "dynamic_filter_pair", "conv3x3_implicit_gemm",
       "conv3x3_pairlane")


def _image(h, w, seed):
    """A smooth seeded BGR uint8 image."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx * f[c, 0] + yy * f[c, 1] + c)
                    for c in range(3)], -1)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree():
    """The bundled checkpoint upcast to fp32 (numpy)."""
    t = serialization.msgpack_restore(CKPT.read_bytes())
    return jax.tree.map(lambda a: np.asarray(a, np.float32), t)


@pytest.fixture(scope="module")
def session(tree):
    sess = Stylization(params=tree, cfg=ModelConfig(dtype=torch.float32),
                       device="cpu")
    frame = _image(128, 96, seed=0)
    sess.prepare_style(_image(64, 64, seed=1))
    sess.clean()
    sess.add(frame[:64, :64])
    sess.compute()
    return sess, frame


@pytest.fixture(scope="module")
def bundle(session, tmp_path_factory):
    """A CPU bundle of the session's Pass 2 at 64x64, batches 1 and 2."""
    sess, _ = session
    path = str(tmp_path_factory.mktemp("aot") / "pass2.rvaot")
    meta = A.save_bundle(path, sess, (64, 64), batches=(1, 2),
                         platforms=("cpu",))
    return path, meta


def _x(frame):
    return torch.from_numpy(bgr_to_model(frame))


def _kernel_nodes(ep):
    names = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return {op: names.count(f"rerevst.{op}.default") for op in OPS}


def test_bundle_roundtrip_matches_eager(session, bundle):
    sess, frame = session
    path, meta = bundle
    assert meta["hw"] == [64, 64] and meta["batches"] == [1, 2]
    assert meta["platforms"] == ["cpu"] and meta["dtype"] == "float32"
    with open(path, "rb") as f:
        assert f.read(8) == A.MAGIC == b"RVTAOT01"
    # The weights are arguments: the bundle holds graphs, not weights.
    assert os.path.getsize(path) < 8 << 20

    aot = A.load_bundle(path)
    assert aot.batches() == [1, 2] and aot.platforms() == ["cpu"]
    x1 = _x(frame[:64, :64])
    x2 = torch.cat([x1, _x(frame[64:128, :64])])
    for x in (x1, x2):
        want = sess._stylize(x)
        with torch.inference_mode():
            got = aot(sess.params, x, sess.style, sess.stats)
        assert torch.equal(want, got)

    # The relu4_1 style map's H and W are symbolic: a style of another
    # geometry runs.
    with torch.inference_mode():
        from rerevst_torch.models.transformer import encode_style

        st2 = encode_style(sess.params, _x(frame[:96, :80]), sess.cfg)
        assert st2.map.shape[1:3] != sess.style.map.shape[1:3]
        assert aot(sess.params, x1, st2, sess.stats).shape == x1.shape

        # Shapes outside the bundle raise KeyError (the session runs eager).
        with pytest.raises(KeyError):
            aot(sess.params, torch.cat([x1] * 3), sess.style, sess.stats)
        with pytest.raises(KeyError):
            aot(sess.params, torch.zeros((1, 128, 64, 3)), sess.style,
                sess.stats)


def test_exported_graph_holds_the_kernel_ops(bundle, tree):
    """Every norm site and filter pair of the global graph is one node of
    its op; on the pair-lane route (bf16 here) the three full-resolution
    64-channel convs are conv3x3_pairlane nodes."""
    aot = A.load_bundle(bundle[0])
    for b in (1, 2):
        assert _kernel_nodes(aot.program(b, "cpu")) == {
            "norm_affine_clamp": 11, "dynamic_filter_pair": 3,
            "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 0}
    pl = Stylization(params=tree, cfg=ModelConfig(dtype=torch.bfloat16,
                                                  pairlane=True),
                     device="cpu")
    ep = A.export_pass2(pl, (64, 64), 1, ("cpu",))["cpu"]
    assert _kernel_nodes(ep) == {
        "norm_affine_clamp": 11, "dynamic_filter_pair": 3,
        "conv3x3_implicit_gemm": 0, "conv3x3_pairlane": 3}


def test_aot_matches_jax_stylize(session, bundle, tree):
    """AOT frames against rerevst_tpu's session on the same weights, style
    and Pass-1 frame: uint8 within 1 count."""
    from rerevst_tpu.api import Stylization as JaxStylization
    from rerevst_tpu.data.transforms import bgr_to_model as jbgr_to_model

    sess, frame = session
    js = JaxStylization(params=tree)
    js.prepare_style(_image(64, 64, seed=1))
    js.clean()
    js.add(frame[:64, :64])
    js.compute()
    aot = A.load_bundle(bundle[0])
    x = frame[:64, :64]
    want = np.asarray(js._stylize(jax.numpy.asarray(jbgr_to_model(x))))
    with torch.inference_mode():
        got = aot(sess.params, _x(x), sess.style, sess.stats).numpy()
    counts = np.abs(model_to_bgr(got).astype(np.int16)
                    - model_to_bgr(want).astype(np.int16))
    assert counts.max() <= 1


def test_bundle_graph_runs_with_tf32_off(session, bundle):
    """An exported graph's library convs and matmuls carry no precision of
    their own: the bundle runs them with cuDNN's and cuBLAS's TF32 flags
    off, as the eager path's fp32 products run, and puts the flags back
    after the call."""
    sess, frame = session
    aot = A.load_bundle(bundle[0])
    x1 = _x(frame[:64, :64])
    key = (1, "cpu")
    seen = []

    class Recorder(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, *args):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return self.inner(*args)

    aot._modules[key] = Recorder(aot.program(*key).module())
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = aot(sess.params, x1, sess.style, sess.stats)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    assert seen == [(False, False)]
    assert after == (True, True)
    assert torch.equal(got, sess._stylize(x1))


def test_session_aot_path_and_fallback(session, bundle):
    sess, frame = session
    x1 = _x(frame[:64, :64])
    want = sess._stylize(x1)
    assert sess.pass2_mode == "global"
    sess.use_aot(bundle[0])
    try:
        assert torch.equal(sess._stylize(x1), want)
        assert sess.pass2_mode == "aot"
        # Batch 3 is not in the bundle: the eager path serves it.
        y3 = sess._stylize(torch.cat([x1] * 3))
        assert y3.shape == (3, 64, 64, 3) and sess.pass2_mode == "global"
        assert sess._aot is not None and not sess._aot_warned
    finally:
        sess._aot = None


def test_aot_dropped_on_stats_structure_drift(session, bundle, capsys):
    """Statistics of another dtype (or structure) than the export's: the
    bundle rejects the call with ValueError, and the session drops it, warns
    once, serves eager, and re-arms on use_aot()."""
    sess, frame = session
    x1 = _x(frame[:64, :64])
    orig = sess.stats
    sess.use_aot(bundle[0])
    try:
        sess.stats = orig._replace(
            filters={k: v.to(torch.bfloat16) for k, v in orig.filters.items()})
        out = sess._stylize(x1)
        assert sess._aot_warned and sess._aot is None
        assert sess.pass2_mode == "global" and out.shape == x1.shape
        assert "AOT bundle rejected the call" in capsys.readouterr().err
        sess.stats = orig._replace(norms={k: v for k, v in orig.norms.items()
                                          if k != "pre"})
        sess.use_aot(bundle[0])
        with pytest.raises(ValueError, match="tree structure"):
            sess._aot(sess.params, x1, sess.style, sess.stats)
        sess.stats = orig
        sess._stylize(x1)
        assert sess.pass2_mode == "aot" and not sess._aot_warned
    finally:
        sess.stats = orig
        sess._aot = None


def test_use_aot_rejects_dtype_mismatch(session, bundle, tree):
    other = Stylization(params=tree, cfg=ModelConfig(dtype=torch.bfloat16),
                        device="cpu")
    with pytest.raises(ValueError, match="exported for dtype"):
        other.use_aot(bundle[0])
    tiled = Stylization(params=tree, cfg=ModelConfig(dtype=torch.float32,
                                                     spatial_tiles=2),
                        device="cpu")
    with pytest.raises(ValueError, match="model switches"):
        tiled.use_aot(bundle[0])


def test_use_aot_refuses_bundle_without_the_sessions_device(
        session, bundle, monkeypatch):
    """A CUDA session must never run a CPU-exported graph: a bundle with no
    graph for the session's device raises at use_aot."""
    sess, _ = session
    monkeypatch.setattr(sess, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="none for the session's device"):
        sess.use_aot(bundle[0])
    assert sess._aot is None


def test_convert_cli_export_aot(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "cli.rvaot")
    convert.main([str(CKPT), out, "--export-aot", "--hw", "64x64",
                  "--batches", "1,2", "--dtype", "f32", "--platforms", "cpu"])
    assert "AOT bundle" in capsys.readouterr().out
    aot = A.load_bundle(out)
    assert aot.hw == (64, 64) and aot.batches() == [1, 2]
    assert aot.meta["platforms"] == ["cpu"]
    assert aot.meta["model"] == {
        "pairlane": False, "spatial_tiles": 1, "precision": "auto",
        "fp32_mix": "none", "mix_precision": "default", "luma_fold": False,
        "parity_packed": False}
    # The default platforms include cuda, which needs a card to export.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    other = str(tmp_path / "default.rvaot")
    with pytest.raises(RuntimeError, match="needs a card"):
        convert.main([str(CKPT), other, "--export-aot", "--hw", "64x64"])
    assert not os.path.exists(other) and not os.path.exists(other + ".tmp")


def test_load_bundle_rejects_garbage_and_jax_bundles(tmp_path):
    junk = tmp_path / "junk.rvaot"
    junk.write_bytes(b"NOTABUNDLE")
    with pytest.raises(ValueError, match="not an AOT bundle"):
        A.load_bundle(str(junk))
    # The JAX package's layout: its magic, a u32 length and JSON meta.
    head = json.dumps({"hw": [64, 64], "batches": [1], "platforms": ["cpu"],
                       "dtype": "float32", "entries": []}).encode()
    jaxb = tmp_path / "jax.rvaot"
    jaxb.write_bytes(b"RVAOT001" + np.uint32(len(head)).tobytes() + head)
    with pytest.raises(ValueError, match="not an AOT bundle"):
        A.load_bundle(str(jaxb))


def _op_cases():
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x8 = t(2, 4, 6, 8)
    vec = lambda b=1: [t(b, 1, 1, 8), t(b, 1, 1, 8).abs() + 0.5,  # noqa: E731
                       -t(b, 1, 1, 8).abs() - 1, t(b, 1, 1, 8).abs() + 1]
    x32 = t(2, 3, 5, 32)
    return [
        ("norm_affine_clamp", (x8, *vec(), None, None, False)),
        ("norm_affine_clamp", (x8, *vec(), t(1, 1, 1, 8), t(1, 1, 1, 8),
                               True)),
        ("norm_affine_clamp", (x8.to(torch.bfloat16), *vec(2),
                               t(2, 1, 1, 8), t(2, 1, 1, 8), True)),
        ("dynamic_filter_pair", (x32, t(1, 32, 32), t(1, 32, 32))),
        ("dynamic_filter_pair", (x32.to(torch.bfloat16), t(2, 32, 32),
                                 t(2, 32, 32))),
        ("conv3x3_implicit_gemm", (t(2, 5, 7, 3), t(3, 3, 3, 4), t(4))),
        ("conv3x3_implicit_gemm", (t(1, 4, 6, 8), t(3, 3, 8, 5), None)),
        ("conv3x3_pairlane", (t(1, 4, 6, 64), t(3, 3, 64, 3), t(3))),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_opcheck_kernel_ops(case):
    """Each rerevst:: op's schema, CPU implementation and fake (shape,
    dtype and strides) agree, as torch.library.opcheck checks them."""
    name, args = _op_cases()[case]
    op = getattr(torch.ops.rerevst, name).default
    torch.library.opcheck(op, args)
