"""rerevst_torch.ops.tiling and the tiled model regions vs rerevst_tpu.

The port's counterparts of ``tests/test_tiling.py``: overlap-and-discard
H-tiling of an H-local region must give the untiled values, for an
identity, a conv stack, a downscaling (pool) and an upscaling (the folded
upsample conv) region, with the shifted edge slabs; the ``can_tile_h``
gates; Pass 2 (the encoder's conv1 block and the decoder's tail) at 2 and 4
tiles; an indivisible geometry that runs untiled.  Then the port's tiled
Pass 2 against ``rerevst_tpu``'s tiled Pass 2 with the same weights (the
bundled checkpoint upcast to fp32) and frames, and ``stylize --tiles 2``
against ``--tiles 1``.

Inputs are seeded numpy arrays or smooth seeded images; fp32 on the CPU.
Tolerance: 1e-5 of the output's scale (the slabs' convs may sum in another
order than the whole map's); uint8 frames within 1 count.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.config import ModelConfig
from rerevst_torch.data.transforms import model_to_bgr
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.models import transformer as T
from rerevst_torch.models import vgg
from rerevst_torch.models.layers import (
    conv2d,
    max_pool_2x2,
    upsample2x_conv3x3,
)
from rerevst_torch.ops.tiling import can_tile_h, tiled_over_h
from rerevst_tpu.config import ModelConfig as JaxModelConfig
from rerevst_tpu.models import transformer as jT
from rerevst_tpu.ops import tiling as jtiling

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
CFG = ModelConfig()


def _close(got, want, scale_atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _w(shape, seed, scale=0.3):
    return _x(shape, seed) * scale


class TestTiledOverH:
    def test_identity_region(self):
        x = _x((2, 32, 16, 4))
        fn = lambda v: v * 2.0 + 1.0  # noqa: E731
        assert torch.equal(tiled_over_h(fn, x, 4, 2), fn(x))

    def test_conv_stack_region(self):
        """Two SAME convs: receptive field 2, so halo 2 must reproduce the
        untiled map, the shifted edge slabs included; and the JAX package's
        tiling of the same region on the same inputs agrees."""
        p1, p2 = {"w": _w((3, 3, 4, 8), 1)}, {"w": _w((3, 3, 8, 4), 2)}

        def fn(v):
            return conv2d(p2, torch.tanh(conv2d(p1, v, padding=1)),
                          padding=1)

        def jfn(v):
            from rerevst_tpu.models.layers import conv2d as jconv2d

            jp1 = {"w": jnp.asarray(p1["w"].numpy())}
            jp2 = {"w": jnp.asarray(p2["w"].numpy())}
            return jconv2d(jp2, jnp.tanh(jconv2d(jp1, v, padding=1)),
                           padding=1)

        x = _x((2, 40, 12, 4))
        for t in (2, 4, 5):
            got = tiled_over_h(fn, x, t, 2)
            _close(got, fn(x))
            _close(got, jtiling.tiled_over_h(jfn, jnp.asarray(x.numpy()),
                                             t, 2))

    def test_downscaling_region(self):
        """conv + 2x2 pool (the encoder head's shape): scale (1, 2)."""
        p = {"w": _w((3, 3, 4, 4), 3)}

        def fn(v):
            return max_pool_2x2(torch.relu(conv2d(p, v, padding=1)))

        x = _x((1, 48, 8, 4))
        _close(tiled_over_h(fn, x, 3, 2, scale=(1, 2)), fn(x))

    def test_upscaling_region(self):
        """The folded upsample2x-conv3x3 (the decoder tail's shape): scale
        (2, 1).  Its four output parities interleave with a stack, which a
        slab must give as the whole map does."""
        p = {"w": _w((3, 3, 4, 4), 4), "b": torch.zeros(4)}

        def fn(v):
            return upsample2x_conv3x3(p, v)

        x = _x((2, 24, 8, 4))
        _close(tiled_over_h(fn, x, 4, 2, scale=(2, 1)), fn(x))

    def test_can_tile_h_gates(self):
        assert can_tile_h(64, 4, 4, (1, 2), align=2)
        assert not can_tile_h(64, 3, 4, (1, 1))      # 64 % 3
        assert not can_tile_h(16, 4, 4, (1, 1))      # th < 2*halo
        assert not can_tile_h(64, 4, 3, (1, 1), align=2)  # halo not aligned
        assert can_tile_h(64, 1, 4, (1, 1)) is False  # n_tiles <= 1
        for h in (16, 24, 40, 64, 152, 1216):
            for n in (1, 2, 3, 4, 5, 7, 8):
                for halo, scale, align in ((4, (1, 2), 2), (2, (2, 1), 1),
                                           (3, (1, 1), 1), (2, (1, 2), 2)):
                    assert can_tile_h(h, n, halo, scale, align) == \
                        jtiling.can_tile_h(h, n, halo, scale, align)
        with pytest.raises(ValueError, match="cannot tile"):
            tiled_over_h(lambda v: v, _x((1, 16, 4, 2)), 4, 4)


def _smooth_images(rng, n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.03, 0.2, (3, 2))
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([0.5 + 0.4 * np.sin(xx * f[c, 0] + yy * f[c, 1] + ph[c])
                        for c in range(3)], -1)
        out.append((img - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225])
    return np.stack(out).astype(np.float32)


def _to_port_stats(jst):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.SeqStats({k: T.NormStats(*map(t, v))
                       for k, v in jst.norms.items()},
                      {k: t(v) for k, v in jst.filters.items()})


def _to_port_style(js):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.StyleFeatures(t(js.map), tuple(map(t, js.means)),
                           tuple(map(t, js.stds)))


@pytest.fixture(scope="module")
def setup():
    """The bundled checkpoint upcast to fp32 on both sides, a seeded style
    and two 64x96 frames, and the JAX package's Pass-1 statistics (given to
    both decoders)."""
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(5)
    style = _smooth_images(rng, 1, 64, 64)
    frames = _smooth_images(rng, 2, 64, 96)
    jcfg = JaxModelConfig()
    js = jT.encode_style(jp, jnp.asarray(style), jcfg)
    feats = jT.encode_content(jp, jnp.asarray(frames), jcfg)
    jst = jT.collect_stats(jp["decoder"], feats, js, jcfg)
    return jp, tp, frames, js, jst


def _pass2(tp, frames, style, stats, cfg):
    with torch.no_grad():
        f = T.encode_content(tp, torch.from_numpy(frames), cfg)
        return T.decode_global(tp["decoder"], f, style, stats, cfg)


def _counting(monkeypatch):
    """Count the calls of the norm kernel's wrapper in the decoder and of
    the encoder's conv1 block (once per slab when tiled)."""
    calls = {"norm": 0, "head": 0}
    norm, head = T.norm_affine_clamp, vgg._head

    def counted_norm(*a, **k):
        calls["norm"] += 1
        return norm(*a, **k)

    def counted_head(*a, **k):
        calls["head"] += 1
        return head(*a, **k)

    monkeypatch.setattr(T, "norm_affine_clamp", counted_norm)
    monkeypatch.setattr(vgg, "_head", counted_head)
    return calls


class TestModelTiling:
    @pytest.mark.parametrize("tiles", [2, 4])
    def test_pass2_tiled_matches_untiled(self, setup, tiles, monkeypatch):
        """Encoder head + decoder tail tiled: the Pass-2 pixels equal the
        untiled ones, the tail's four norm sites run once per slab (7 + 4
        T calls) and the head once per slab."""
        _, tp, frames, js, jst = setup
        style, stats = _to_port_style(js), _to_port_stats(jst)
        ref = _pass2(tp, frames, style, stats, CFG)
        calls = _counting(monkeypatch)
        got = _pass2(tp, frames, style, stats,
                     dataclasses.replace(CFG, spatial_tiles=tiles))
        assert calls == {"norm": 7 + 4 * tiles, "head": tiles}
        _close(got, ref)

    def test_encoder_tiled_matches_untiled(self, setup):
        _, tp, frames, *_ = setup
        from rerevst_torch.ops.image import rgb_to_luma_reversed

        x = rgb_to_luma_reversed(torch.from_numpy(frames))
        with torch.no_grad():
            ref = vgg.encode(tp["encoder"], x)
            got = vgg.encode(tp["encoder"], x, head_tiles=2)
        _close(got, ref)

    def test_indivisible_geometry_falls_back(self, setup, monkeypatch):
        """H not divisible by the tile count: the untiled graph runs (the
        JAX semantics), with the same output and 11 norm calls."""
        _, tp, frames, js, jst = setup
        style, stats = _to_port_style(js), _to_port_stats(jst)
        ref = _pass2(tp, frames, style, stats, CFG)
        calls = _counting(monkeypatch)
        got = _pass2(tp, frames, style, stats,
                     dataclasses.replace(CFG, spatial_tiles=7))  # 64 % 7
        assert calls == {"norm": 11, "head": 0}
        assert torch.equal(got, ref)

    @pytest.mark.parametrize("tiles", [2, 4])
    def test_pass2_tiled_matches_jax_tiled(self, setup, tiles):
        """The port's tiled Pass 2 against rerevst_tpu's tiled Pass 2 under
        the same statistics: within 1e-5 of the output's scale, and uint8
        frames within 1 count."""
        jp, tp, frames, js, jst = setup
        jcfg = JaxModelConfig(spatial_tiles=tiles)
        jf = jT.encode_content(jp, jnp.asarray(frames), jcfg)
        want = np.asarray(jT.decode_global(jp["decoder"], jf, js, jst, jcfg))
        got = _pass2(tp, frames, _to_port_style(js), _to_port_stats(jst),
                     dataclasses.replace(CFG, spatial_tiles=tiles)).numpy()
        _close(got, want)
        counts = np.abs(model_to_bgr(got).astype(np.int16)
                        - model_to_bgr(want).astype(np.int16))
        assert counts.max() <= 1


def test_stylize_cli_tiles_matches_untiled(tmp_path, capsys):
    """``stylize --tiles 2`` on the CPU gives the frames of ``--tiles 1``
    (64x96 crops of the bundled clip, padded to 192x256: both regions
    tile)."""
    cv2 = pytest.importorskip("cv2")
    from rerevst_torch import stylize
    from rerevst_torch.data.video import read_video

    clip = tmp_path / "in" / "ambush"
    clip.mkdir(parents=True)
    for i, f in enumerate(read_video(
            str(REPO / "docs" / "ReReVST-plum_flower-ambush_4.avi"), 3)):
        cv2.imwrite(str(clip / f"frame_{i + 1:04d}.png"), f[100:164, 400:496])
    style = tmp_path / "in" / "plum.jpg"
    cv2.imwrite(str(style), cv2.resize(
        cv2.imread(str(REPO / "docs" / "demo_style.jpg")), (64, 64)))
    frames = {}
    for tiles in (1, 2):
        out = tmp_path / f"t{tiles}"
        stylize.main(["--style", str(style), "--frames", str(clip / "*.png"),
                      "--checkpoint", str(CKPT), "--device", "cpu",
                      "--no-video", "--batch", "2", "--interval", "2",
                      "--tiles", str(tiles), "-o", str(out)])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["frames"] == 3
        frames[tiles] = [cv2.imread(str(p)) for p in
                         sorted((out / "ReReVST-plum-ambush").glob("*.png"))]
    assert len(frames[1]) == len(frames[2]) == 3
    for a, b in zip(frames[1], frames[2]):
        assert a.shape == (64, 96, 3)
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
