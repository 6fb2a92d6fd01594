"""rerevst_torch.parallel.spatial (H-sharded Pass 2 with a hand-written halo
exchange) vs rerevst_tpu.parallel.spatial (GSPMD).

The port's mesh is logical shards of the CPU; the JAX side runs on its
virtual 8-device CPU mesh.  Weights: the bundled checkpoint upcast to fp32;
64x96 frames (``tests/test_spatial.py``'s geometry) under the JAX package's
statistics, fed to both sides.  Tolerances: pixels 1e-5 of the output's
scale (each shard's convs sum over its slab in another order than the whole
frame's); session frames within 1 uint8 count; the pair-lane route in bf16
within 2 bf16 ulps of the output's scale (the slab convs round the same
fp32 sums, but the rounding of a tie may flip).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from jax.sharding import Mesh as JMesh

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig, ModelConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import transformer as T
from rerevst_torch.models import vgg
from rerevst_torch.multistyle import MultiStylization
from rerevst_torch.parallel import frame_mesh
from rerevst_torch.parallel.spatial import (
    multistyle_decode_spatial,
    spatial_feats_ok,
    spatial_ok,
    stylize_spatial_sharded,
)
from rerevst_tpu.config import ModelConfig as JModelConfig
from rerevst_tpu.models import transformer as jT
from rerevst_tpu.parallel import spatial as jspatial

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
CFG = ModelConfig()
JCFG = JModelConfig()


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_t(v) for v in tree]
        cls = {"StyleFeatures": T.StyleFeatures, "NormStats": T.NormStats,
               "SeqStats": T.SeqStats}.get(type(tree).__name__)
        return cls(*out) if cls else type(tree)(out)
    return torch.from_numpy(np.array(tree, np.float32))


def _close(got, want, scale_atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale_atol * np.abs(want).max())


@pytest.fixture(scope="module")
def mesh8():
    mesh = frame_mesh(8, devices=["cpu"] * 8)
    yield mesh
    mesh.close()


@pytest.fixture(scope="module")
def jmesh8():
    return JMesh(np.array(jax.devices()[:8]), ("data",))


@pytest.fixture(scope="module")
def setup(jmesh8):
    """Params, 4 frames, two styles and their JAX statistics; the JAX
    package's H-sharded pixels at batch 1, 2 and 4 and its multi-style
    spatial decodes (shared and per-frame blends)."""
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jp = jax.tree.map(jnp.asarray, jparams)
    rng = np.random.default_rng(3)
    frames = (rng.standard_normal((4, 64, 96, 3)) * 0.5).astype(np.float32)
    styles = [(rng.standard_normal((1, 64, 64, 3)) * 0.5).astype(np.float32)
              for _ in range(2)]
    enc_s = jax.jit(lambda p, s: jT.encode_style(p, s, JCFG))
    feats = jax.jit(lambda p, f: jT.encode_content(p, f, JCFG))(jp, frames)
    coll = jax.jit(lambda d, f, s: jT.collect_stats(d, f, s, JCFG))
    sfs = [enc_s(jp, s) for s in styles]
    stats = [coll(jp["decoder"], feats, sf) for sf in sfs]
    out = {b: np.asarray(jspatial.stylize_spatial_sharded(
        jp, frames[:b], sfs[0], stats[0], JCFG, jmesh8)) for b in (1, 2, 4)}
    # 8 feature rows: 4 shards keep the 2 rows per shard the gate asks.
    jmesh4 = JMesh(np.array(jax.devices()[:4]), ("data",))
    rows = np.asarray([[0.3, 0.7], [0.9, 0.1]], np.float32)
    ms = {"shared": np.asarray(jspatial.multistyle_decode_spatial(
              jp, feats[:1], sfs, stats, [0.25, 0.75], JCFG, jmesh4)),
          "per-frame": np.asarray(jspatial.multistyle_decode_spatial(
              jp, feats[:2], sfs, stats, rows, JCFG, jmesh4))}
    return {"params": from_jax_params(jparams, device="cpu"),
            "frames": torch.from_numpy(frames), "feats": _t(feats),
            "styles": [_t(sf) for sf in sfs], "stats": [_t(s) for s in stats],
            "out": out, "ms": ms, "rows": rows, "tree": tree}


@pytest.mark.parametrize("batch,h,n", [
    (1, 64, 8), (2, 64, 8), (4, 64, 8), (8, 64, 8), (3, 64, 8), (1, 63, 8),
    (1, 32, 8), (1, 192, 8), (2, 96, 8), (1, 72, 8), (1, 48, 4), (1, 64, 1),
    (3, 96, 6)])
def test_gates_match_jax(batch, h, n):
    """The port's gates against the JAX package's.  One deliberate
    difference, asserted here: the port also asks for a multiple of 8 rows
    per H shard (whole relu4_1 rows for a hand-written halo), so (1, 72)
    on 8 shards (9 rows each) and (3, 96, 6) (48 rows each: passes) differ
    only where the JAX gate admits a shard of 8k + r rows."""
    ours = frame_mesh(n, devices=["cpu"] * n)
    theirs = JMesh(np.array(jax.devices()[:n]), ("data",))
    want = jspatial.spatial_ok(batch, h, theirs)
    rows_each = h // max(n // batch, 1)
    if want and rows_each % 8:
        assert not spatial_ok(batch, h, ours)  # the deliberate difference
    else:
        assert spatial_ok(batch, h, ours) == want
    assert spatial_feats_ok(batch, h // 8, ours) == \
        jspatial.spatial_feats_ok(batch, h // 8, theirs)
    ours.close()


def test_gate_difference_at_16_shards():
    """h = 576 over 16 shards: 36 rows each, 4.5 after the encoder's pools.
    The JAX gate admits it (GSPMD pads); the port's refuses, so a batch of
    1 runs on one device and a larger batch batch-sharded."""
    mesh = frame_mesh(16, devices=["cpu"] * 16)
    assert not spatial_ok(1, 576, mesh)
    assert spatial_ok(1, 640, mesh)  # 40 rows each
    rows = 576 // 16
    assert 576 % 16 == 0 and rows >= 8  # JAX's own gate holds
    mesh.close()


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_h_sharded_matches_jax(setup, mesh8, batch):
    """Pure H sharding (batch 1: 8 rows per shard) through hybrid batch x H
    (batch 4: 32 rows): the JAX package's GSPMD pixels, and the port's
    unsharded Pass 2."""
    x = setup["frames"][:batch]
    with torch.inference_mode():
        got = stylize_spatial_sharded(setup["params"], x, setup["styles"][0],
                                      setup["stats"][0], CFG, mesh8)
        ref = T.stylize(setup["params"], x, setup["styles"][0], CFG,
                        setup["stats"][0])
    _close(got, setup["out"][batch])
    _close(got, ref.numpy())


def test_tiles_dropped_under_sharding(setup, mesh8):
    cfg = dataclasses.replace(CFG, spatial_tiles=2)
    with torch.inference_mode():
        got = stylize_spatial_sharded(setup["params"], setup["frames"][:1],
                                      setup["styles"][0], setup["stats"][0],
                                      cfg, mesh8)
    _close(got, setup["out"][1])


@pytest.mark.parametrize("blend", ["shared", "per-frame"])
def test_multistyle_spatial_matches_jax(setup, blend):
    """A one-blend decode of one frame (2 feature rows per shard) and a
    per-frame-blend decode of two (hybrid 2 x 2) on 4 shards."""
    n = 1 if blend == "shared" else 2
    w = [0.25, 0.75] if blend == "shared" else setup["rows"]
    mesh = frame_mesh(4, devices=["cpu"] * 4)
    assert spatial_feats_ok(n, setup["feats"].shape[1], mesh)
    with torch.inference_mode():
        got = multistyle_decode_spatial(
            setup["params"], setup["feats"][:n], setup["styles"],
            setup["stats"], w, CFG, mesh)
    mesh.close()
    _close(got, setup["ms"][blend])


def _clip(n, h, w):
    rng = np.random.default_rng(0)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


def _style():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    return np.clip(np.stack([128 + 90 * np.sin(xx / 5 + c) * np.cos(yy / 7 - c)
                             for c in range(3)], -1), 0, 255).astype(np.uint8)


def test_session_routing(setup, mesh8):
    """A mesh session of unpadded 64x64 frames (``pad=0``) routes batch 1
    and batch 4 H-sharded (8 and 32 rows per shard), batch 8 and batch 3
    batch-sharded; on 16 shards a 192-row frame (12 rows each: the JAX gate
    admits it, the port's refuses) runs on the session's device.  Frames
    within 1 count of the unmeshed session's."""
    infer = InferenceConfig(pad=0)
    mesh16 = frame_mesh(16, devices=["cpu"] * 16)
    for mesh, clip, batches in ((mesh8, _clip(8, 64, 64),
                                 ((1, "spatial-sharded"),
                                  (4, "spatial-sharded"),
                                  (8, "batch-sharded"),
                                  (3, "batch-sharded"))),
                                (mesh16, _clip(2, 192, 64),
                                 ((1, "global"),))):
        plain = Stylization(params=setup["tree"], infer=infer, device="cpu")
        s = Stylization(params=setup["tree"], infer=infer, mesh=mesh,
                        device="cpu")
        for sess in (plain, s):
            sess.prepare_style(_style())
            sess.prepare_global(clip)
        assert s.pass1_mode == "sharded"
        want = plain.transfer_batch(clip)
        for n, mode in batches:
            got = s.transfer_batch(clip[:n])
            assert s.pass2_mode == mode, (n, mesh.size)
            for a, b in zip(got, want):
                assert np.abs(a.astype(np.int16)
                              - b.astype(np.int16)).max() <= 1
    assert jspatial.spatial_ok(1, 192, JMesh(np.array(jax.devices()[:8]),
                                             ("data",)))
    mesh16.close()


def test_multistyle_session_routing(setup):
    """MultiStylization on 4 shards (64x64 frames, 8x8 features): a
    one-frame decode H-shards the feature map (2 rows per shard), a
    per-frame-blend decode of 4 frames is split over the shards; both give
    the unmeshed session's frames."""
    infer = InferenceConfig(sample_interval=2, pad=0)
    styles = [_style(), _style()[::-1].copy()]
    mesh = frame_mesh(4, devices=["cpu"] * 4)
    clip = _clip(4, 64, 64)
    rows = [[i / 3, 1 - i / 3] for i in range(4)]
    outs = []
    for m in (mesh, None):
        ms = MultiStylization(params=setup["tree"], infer=infer, mesh=m,
                              device="cpu")
        ms.prepare_styles(styles)
        feats = ms.encode_frames(clip)
        ms.prepare_global(feats)
        assert feats.shape[1] == 8
        outs.append([ms.transfer(feats[:1], [0.4, 0.6])]
                    + ms.transfer_batch(feats, rows))
    mesh.close()
    assert spatial_feats_ok(1, 8, mesh) and not spatial_feats_ok(4, 8, mesh)
    for a, b in zip(*outs):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_pairlane_runs_on_halo_slabs(setup, monkeypatch):
    """The bf16 pair-lane route H-sharded over 4 shards of a 64-row frame:
    every ``conv3x3_pairlane`` call (the encoder's conv1_2, the decoder's
    res2.conv2 and out conv, all at full resolution) sees a slab of
    h_local + 2 = 18 rows, and the frame matches the unsharded pair-lane
    Pass 2."""
    cfg = ModelConfig(dtype=torch.bfloat16, pairlane=True)
    params = setup["params"]
    heights = []
    real = T.conv3x3_pairlane

    def spy(x, w, b=None):
        heights.append(x.shape[1])
        return real(x, w, b)

    monkeypatch.setattr(T, "conv3x3_pairlane", spy)
    monkeypatch.setattr(vgg, "conv3x3_pairlane", spy)
    mesh = frame_mesh(4, devices=["cpu"] * 4)
    x = setup["frames"][:1, :, :64]
    with torch.inference_mode():
        sf = T.encode_style(params, torch.from_numpy(np.zeros(
            (1, 64, 64, 3), np.float32)) + x[:, :, :64].mean(), cfg)
        st = T.collect_stats(params["decoder"],
                             T.encode_content(params, x, cfg), sf, cfg)
        heights.clear()
        ref = T.stylize(params, x, sf, cfg, st).float()
        assert heights == [64, 64, 64]
        heights.clear()
        got = stylize_spatial_sharded(params, x, sf, st, cfg, mesh).float()
    mesh.close()
    assert heights == [18] * 12
    ulp = 2.0 ** -7
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=2 * ulp * float(ref.abs().max()))
