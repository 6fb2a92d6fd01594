"""rerevst_torch.convert and the port's flax-msgpack writer against the JAX
package's converter and ``flax.serialization``.

The writer (``io.checkpoint.packb``/``save_params``) must give the bytes flax
gives; the CLI must give byte-equal ``.msgpack`` files and tensor-equal
``.pth`` files against ``rerevst_tpu.convert`` on the same command lines.
The fp32 tree is the bundled checkpoint upcast to fp32 (the ROADMAP rule),
with a loss net (a copy of the style encoder, the same VGG schema) so that
``--no-loss-net`` has something to drop.
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flax import serialization

from rerevst_torch import convert
from rerevst_torch.io import checkpoint as ck
from rerevst_tpu import convert as jax_convert
from rerevst_tpu.io.checkpoint import save_params as jax_save_params

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


def _raw(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _mixed_tree():
    """fp32, int and 0-d leaves, Python and numpy scalars, and every
    length form of msgpack's maps, strings, bins and exts."""
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
        "a_long_key_name_past_thirty_one_chars": {
            "ids": np.array([1, -2, 300, -70000], np.int32),
            "i64": np.arange(7, dtype=np.int64),
            "zero_d_f32": np.array(0.5, np.float32),
            "zero_d_int": np.array(-3, np.int64),
            "np_scalar": np.float32(2.25),
            "u8": np.arange(16, dtype=np.uint8).reshape(4, 4),
        },
        "ints": {"small": 5, "neg": -7, "u8": 200, "i8": -100, "u16": 60000,
                 "i16": -30000, "u32": 70000, "i32": -70000,
                 "u64": 2 ** 40, "i64": -2 ** 40},
        "scalars": {"f": 0.25, "t": True, "n": None, "s": "x" * 40},
        "wide_map": {f"k{i:02d}": np.full(2, i, np.float16)
                     for i in range(20)},
        "bin16": rng.standard_normal((8, 40)).astype(np.float32),
        "bin32": rng.standard_normal((130, 130)).astype(np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


@pytest.fixture(scope="module")
def bundled_tree():
    return serialization.msgpack_restore(CKPT.read_bytes())


@pytest.fixture(scope="module")
def fp32_ckpt(tmp_path_factory, bundled_tree):
    """The bundled checkpoint upcast to fp32, plus a loss net."""
    tree = {k: _cast(v) for k, v in bundled_tree.items()}
    tree["vgg_loss"] = _cast(bundled_tree["encoder_style"])
    path = tmp_path_factory.mktemp("conv") / "fp32.msgpack"
    jax_save_params(str(path), tree)
    return path


def _cast(node):
    if isinstance(node, dict):
        return {k: _cast(v) for k, v in node.items()}
    return np.asarray(node, np.float32)


@pytest.mark.parametrize("which", ["bundled_bf16", "mixed"])
def test_packb_matches_flax(bundled_tree, which):
    tree = bundled_tree if which == "bundled_bf16" else _mixed_tree()
    want = serialization.to_bytes(tree)
    got = ck.packb(tree)
    assert got == want
    if which == "bundled_bf16":
        assert got == CKPT.read_bytes()
    # The reader takes the writer's bytes back to the same leaves.
    back = _flatten(ck.unpackb(got))
    ref = _flatten(serialization.msgpack_restore(want))
    assert sorted(back) == sorted(ref)
    for k, a in ref.items():
        b = back[k]
        if isinstance(b, torch.Tensor):
            assert tuple(b.shape) == a.shape, k
            assert _raw(b) == np.ascontiguousarray(a).tobytes(), k
        else:
            assert b == a, k


def test_packb_takes_tensors(bundled_tree):
    """The port's own tree (tensors, bf16 included) packs to the file it
    was read from."""
    tree = ck.read_msgpack(str(CKPT))
    assert ck.packb(tree) == CKPT.read_bytes()


def test_chunked_arrays_round_trip(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE take flax's chunked form (a small chunk
    size stands in for flax's 1 GiB)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((5, 11)).astype(np.float32),
            "small": np.arange(4, dtype=np.float32),
            "sub": {"big16": rng.standard_normal(100).astype(np.float16)}}
    blob = ck.packb(tree)
    assert blob == serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    back = ck.unpackb(blob)
    assert "__msgpack_chunked_array__" in back["big"]  # raw decode: chunked
    got = _flatten(ck._unchunk(back))
    for k, a in _flatten(tree).items():
        np.testing.assert_array_equal(got[k].numpy(), a)
    # A bf16 tensor (no numpy counterpart) chunks and comes back too.
    t = torch.randn(3, 50, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    out = ck._unchunk(ck.unpackb(ck.packb({"t": t})))
    assert out["t"].dtype == torch.bfloat16
    assert torch.equal(out["t"], t)


def test_save_params_matches_jax_save_params(tmp_path):
    """Sorted keys and scalars as 0-d arrays, as ``jax.tree.map(np.asarray,
    ...)`` leaves the tree; the write leaves no temporary file."""
    tree = {"z": {"b": np.ones(3, np.float32), "a": 1.5}, "a": 7,
            "m": {"y": np.arange(4, dtype=np.int32)}}
    jax_save_params(str(tmp_path / "jax.msgpack"), tree)
    ck.save_params(str(tmp_path / "sub" / "port.msgpack"), tree)
    assert ((tmp_path / "sub" / "port.msgpack").read_bytes()
            == (tmp_path / "jax.msgpack").read_bytes())
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == [
        "port.msgpack"]


def _options(main, capsys, monkeypatch):
    monkeypatch.setattr("rerevst_tpu.profiling.enable_compile_cache",
                        lambda: None)
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"^\s+(--[a-z][a-z-]*)", capsys.readouterr().out,
                          re.M))


def test_cli_parser_matches_jax(capsys, monkeypatch):
    port = _options(convert.main, capsys, monkeypatch)
    jax = _options(jax_convert.main, capsys, monkeypatch)
    assert port == jax and "--no-loss-net" in port


def _run(main, argv, monkeypatch):
    monkeypatch.setattr("rerevst_tpu.profiling.enable_compile_cache",
                        lambda: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _load_pth(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _pth_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def pths(tmp_path_factory, fp32_ckpt):
    """``.msgpack -> .pth`` of the fp32 tree by both CLIs, with and without
    the loss net: {(cli, no_loss_net): (path, report line)}."""
    d = tmp_path_factory.mktemp("pth")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, main in (("port", convert.main), ("jax", jax_convert.main)):
            for nl in (False, True):
                dst = d / f"{name}_{int(nl)}.pth"
                argv = [str(fp32_ckpt), str(dst)] + (
                    ["--no-loss-net"] if nl else [])
                out[name, nl] = (dst, _run(main, argv, mp).replace(str(dst), "DST"))
    finally:
        mp.undo()
    return out


def test_cli_msgpack_to_pth_matches_jax(pths):
    port, jax = _load_pth(pths["port", False][0]), _load_pth(
        pths["jax", False][0])
    _pth_equal(port, jax)
    assert any(k.startswith("Vgg19.") for k in port)
    assert pths["port", False][1] == pths["jax", False][1]
    assert "(decoder, encoder, encoder_style, vgg_loss)" in \
        pths["port", False][1]


def test_cli_pth_to_msgpack_matches_jax(pths, tmp_path, monkeypatch):
    src = str(pths["jax", False][0])
    port, jax = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    r1 = _run(convert.main, [src, str(port)], monkeypatch)
    r2 = _run(jax_convert.main, [src, str(jax)], monkeypatch)
    assert port.read_bytes() == jax.read_bytes()
    assert r1.replace(str(port), "D") == r2.replace(str(jax), "D")


def test_cli_no_loss_net_matches_jax(pths, tmp_path, monkeypatch):
    port, jax = _load_pth(pths["port", True][0]), _load_pth(
        pths["jax", True][0])
    _pth_equal(port, jax)
    assert not any(k.startswith("Vgg19.") for k in port)
    assert "vgg_loss" not in pths["port", True][1]
    # .pth -> .msgpack without the loss net: byte-equal too.
    src = str(pths["jax", False][0])
    a, b = tmp_path / "a.msgpack", tmp_path / "b.msgpack"
    _run(convert.main, [src, str(a), "--no-loss-net"], monkeypatch)
    _run(jax_convert.main, [src, str(b), "--no-loss-net"], monkeypatch)
    assert a.read_bytes() == b.read_bytes()
    assert "vgg_loss" not in ck.read_msgpack(str(a))


@pytest.mark.parametrize("flag,item", [("--train-export", "item 6"),
                                       ("--train-import", "item 6"),
                                       ("--export-aot", "item 7")])
def test_cli_unported_options_raise(tmp_path, flag, item):
    # Only --export-aot is unported (item 7).  The train-state modes take
    # --netd now: a missing discriminator file is an error of the file,
    # not of the port.
    if flag == "--export-aot":
        with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
            convert.main([str(CKPT), str(tmp_path / "out"), flag])
        return
    with pytest.raises(FileNotFoundError):
        convert.main([str(CKPT), str(tmp_path / "out"), flag, "--netd",
                      str(tmp_path / "netD.pth")])


def test_bf16_checkpoint_converts_to_pth(tmp_path, monkeypatch, bundled_tree):
    """The bundled bf16 checkpoint converts to a ``.pth`` of bf16 tensors
    bit-equal to its leaves; the JAX CLI raises on it (``torch.from_numpy``
    takes no bf16 array), a deliberate difference."""
    dst = tmp_path / "bf16.pth"
    _run(convert.main, [str(CKPT), str(dst)], monkeypatch)
    sd = _load_pth(dst)
    leaf = bundled_tree["decoder"]["res4"]["conv1"]["w"]   # HWIO
    t = sd["Decoder.slice4.conv1.weight"]                   # OIHW
    assert t.dtype == torch.bfloat16
    assert _raw(t.permute(2, 3, 1, 0)) == np.ascontiguousarray(
        leaf).tobytes()
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    with pytest.raises(TypeError):
        _run(jax_convert.main, [str(CKPT), str(tmp_path / "jax.pth")],
             monkeypatch)


def test_serve_and_convert_import_no_jax():
    code = ("import sys, rerevst_torch.serve, rerevst_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'msgpack', 'rerevst_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
