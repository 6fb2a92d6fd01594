"""rerevst_torch.io.torch_compat vs rerevst_tpu.io.torch_compat: the reference
``.pth`` state_dict schema in both directions, and a ``.pth`` session.

Both readers and both writers only re-lay and cast weights, so they are held
to each other exactly, leaf for leaf, on the bundled checkpoint (bf16) and on
the two ablation trees (no ``filter*``; style-only predictors).  A session
built from a ``.pth`` written by the port is bit-equal to the ``.msgpack``
session in fp32.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.api import Stylization
from rerevst_torch.io import torch_compat as tc
from rerevst_torch.io.checkpoint import read_msgpack
from rerevst_torch.io.convert import from_jax_params
from rerevst_tpu.config import ModelConfig as JaxModelConfig
from rerevst_tpu.io import torch_compat as jtc
from rerevst_tpu.models.transformer import init_decoder_params

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def trees():
    """{name: numpy parameter tree}: the bundled checkpoint (bf16) and two
    ablation trees (the JAX init of the ablated decoder, fp32)."""
    out = {"demo": serialization.msgpack_restore(CKPT.read_bytes())}
    for name, kw in (("no_filter", {"dynamic_filter": False}),
                     ("style_only", {"both_sty_con": False})):
        dec = init_decoder_params(jax.random.PRNGKey(1), JaxModelConfig(**kw))
        out[name] = {"decoder": jax.tree.map(np.asarray, dec)}
    return out


@pytest.mark.parametrize("name", ["demo", "no_filter", "style_only"])
def test_reader_matches_jax_reader(trees, name):
    sd = jtc.to_reference_state_dict(trees[name])
    want = _flatten(jax.tree.map(np.asarray, jtc.from_reference_state_dict(sd)))
    got = _flatten(tc.from_reference_state_dict(sd))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape, k
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)
    if name == "style_only":
        assert tuple(got["decoder/filter1/p1/fc/w"].shape) == (32, 9 * 32 * 32)


@pytest.mark.parametrize("name", ["demo", "no_filter", "style_only"])
def test_writer_matches_jax_writer(trees, name):
    want = jtc.to_reference_state_dict(trees[name])
    got = tc.to_reference_state_dict(from_jax_params(trees[name],
                                                     device="cpu"))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k]
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == a.shape, k
        assert t.is_contiguous()
        np.testing.assert_array_equal(_f32(t), _f32(a), err_msg=k)


def test_round_trip_keeps_stored_dtype():
    raw = read_msgpack(str(CKPT))
    back = tc.from_reference_state_dict(tc.to_reference_state_dict(raw),
                                        dtype=None)
    a, b = _flatten(raw), _flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == a[k].dtype == torch.bfloat16, k
        assert torch.equal(a[k], b[k]), k


def _clip(n=3, h=64, w=112):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * 0.11
                                                 + yy * 0.07 + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


def test_pth_session_bit_equal_to_msgpack(tmp_path):
    path = tmp_path / "style_net.pth"
    torch.save(tc.to_reference_state_dict(read_msgpack(str(CKPT))), path)
    style = _clip(n=1, h=64, w=64)[0]
    outs = []
    for ckpt in (str(path), str(CKPT)):
        s = Stylization(ckpt, device="cpu")
        s.prepare_style(style)
        outs.append(list(s.stylize_video(_clip(), batch_size=2)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
