"""rerevst_torch: checkpoint reader, weight conversion, config, and the
package's independence from JAX.

The port reads flax-msgpack checkpoints with its own pure-Python decoder (the
GPU machine has no msgpack or flax); these tests hold it to
``flax.serialization.msgpack_restore`` byte for byte.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.config import InferenceConfig, ModelConfig, resolve_device
from rerevst_torch.io.checkpoint import load_params, read_msgpack, unpackb
from rerevst_torch.io.convert import from_jax_params

REPO = Path(__file__).resolve().parent.parent
CHECKPOINTS = ["demo_plum_4000.msgpack", "demo_multi_4500.msgpack"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes, bf16 included (numpy has no bf16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_reader_matches_flax(name):
    path = REPO / "models" / name
    ref = _flatten(serialization.msgpack_restore(path.read_bytes()))
    got = _flatten(read_msgpack(str(path)))
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, k
        assert _raw(t) == np.ascontiguousarray(a).tobytes(), k


def test_decoder_covers_flax_subset():
    """Every msgpack form flax can emit, packed by the real msgpack."""
    import msgpack

    obj = {
        "fixmap": {"a": 1, "b": -3, "c": None, "d": True, "e": False},
        "map16": {f"k{i}": i for i in range(20)},
        "s8": "x" * 40, "s16": "y" * 300, "s32": "z" * 70000,
        "b8": b"\x01" * 10, "b16": b"\x02" * 300, "b32": b"\x03" * 70000,
        "arr": [1, 2, 3], "arr16": list(range(20)),
        "ints": [127, 128, 255, 256, 65535, 65536, 2**32, -1, -33, -129,
                 -32769, -2**31 - 1],
        "f64": 0.1, "nested": {"x": {"y": [1.5, "s"]}},
    }
    obj["map32"] = {str(i): i for i in range(70000)}
    obj["arr32"] = list(range(70000))
    blob = msgpack.packb(obj, use_bin_type=True)
    assert unpackb(blob) == msgpack.unpackb(blob, raw=False)
    f32 = msgpack.packb(1.25, use_single_float=True)
    assert unpackb(f32) == 1.25
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):  # fixext*, ext8/16/32
        ext = msgpack.packb(msgpack.ExtType(5, b"\x07" * n))
        with pytest.raises(ValueError, match="ext type 5"):
            unpackb(ext)


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_from_jax_params_round_trips(dtype):
    tree = serialization.msgpack_restore(
        (REPO / "models" / CHECKPOINTS[0]).read_bytes())
    port = from_jax_params(tree, dtype=dtype, device="cpu")
    ref, got = _flatten(tree), _flatten(port)
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        t = got[k]
        assert tuple(t.shape) == a.shape
        if dtype is None:
            assert _raw(t) == np.ascontiguousarray(a).tobytes(), k
        else:
            assert t.dtype == dtype
            np.testing.assert_array_equal(t.numpy(), np.asarray(a, np.float32))
    # ... and what jax.tree.map(np.asarray, params) gives converts alike.
    params = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.float32),
                          tree)
    again = _flatten(from_jax_params(jax.tree.map(np.asarray, params),
                                     device="cpu"))
    for k, a in ref.items():
        np.testing.assert_array_equal(again[k].numpy(),
                                      np.asarray(a, np.float32))


def test_load_params_goes_through_convert():
    p = load_params(str(REPO / "models" / CHECKPOINTS[0]),
                    dtype=torch.float16, device="cpu")
    w = p["decoder"]["res4"]["conv1"]["w"]
    assert w.dtype == torch.float16 and tuple(w.shape) == (3, 3, 512, 256)


@pytest.mark.parametrize("second", ["template", {"decoder": {}}, 16,
                                    np.float32])
def test_load_params_rejects_a_template_as_dtype(second):
    """A JAX-style ``load_params(path, like)`` (a flax template, or any
    second argument that is not a torch dtype) raises TypeError before the
    file is read, where it used to pass silently as the dtype."""
    with pytest.raises(TypeError, match="torch.dtype"):
        load_params(str(REPO / "models" / "does-not-exist.msgpack"), second,
                    device="cpu")


def test_from_jax_params_rejects_bad_weight_rank():
    with pytest.raises(ValueError, match="HWIO"):
        from_jax_params({"conv": {"w": np.zeros((3, 3, 4))}}, device="cpu")


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, rerevst_torch\n"
        "for m in pkgutil.walk_packages(rerevst_torch.__path__, "
        "'rerevst_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'rerevst_tpu', 'msgpack', 'cv2')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_FORBIDDEN = {"jax", "jaxlib", "flax", "rerevst_tpu", "msgpack", "cv2",
              "PIL", "optax"}


def _imported_roots(path: Path, in_functions: bool):
    """Root modules imported at module level, or (`in_functions`) inside
    function bodies."""
    tree = ast.parse(path.read_text(), filename=str(path))
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inner = {id(n) for f in funcs for n in ast.walk(f) if n is not f}
    for node in ast.walk(tree):
        if (id(node) in inner) != in_functions:
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports_anywhere():
    """Nothing of JAX, flax or the JAX package, anywhere.  cv2 (absent on
    the card's machine) only inside the functions that read and write image
    files (frame files; the training images, validation grid and
    diagnostic dumps), so importing the package, running in-memory clips
    and taking train steps never need it."""
    files = sorted((REPO / "rerevst_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    cv2_users = []
    for f in files:
        bad = _FORBIDDEN.intersection(_imported_roots(f, False))
        inner = set(_imported_roots(f, True))
        bad |= _FORBIDDEN.intersection(inner) - {"cv2"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
        if "cv2" in inner:
            cv2_users.append(f.relative_to(REPO).as_posix())
    assert cv2_users == ["rerevst_torch/data/datasets.py",
                         "rerevst_torch/data/video.py",
                         "rerevst_torch/train/loop.py"]


@pytest.mark.parametrize("kw", [
    {"parity_packed": True}, {"luma_fold": True},
    {"fp32_mix": "body"}, {"fp32_mix": "dec"}, {"fp32_mix": "out"},
    {"precision": "default"}, {"precision": "high"},
    {"fp32_mix": "full", "mix_precision": "highest"},
    {"fp32_mix": "res2", "mix_precision": "auto"},
])
def test_config_accepts_variant_switches(kw):
    """Every config variant of the JAX package is a valid port config with
    the same fields (tests/test_torch_config_variants.py runs them)."""
    from rerevst_tpu.config import ModelConfig as JaxModelConfig

    cfg = ModelConfig(**kw)
    jcfg = JaxModelConfig(**kw)
    for k in kw:
        assert getattr(cfg, k) == getattr(jcfg, k) == kw[k]


@pytest.mark.parametrize("kw,field", [
    ({"precision": "fast"}, "precision"),
    ({"mix_precision": "bf16x3"}, "mix_precision"),
    ({"fp32_mix": "tail"}, "fp32_mix"),
])
def test_config_rejects_unknown_variant_values(kw, field):
    """An unknown level or region raises, where the JAX package would run
    an unknown region as 'none' (a recorded difference)."""
    with pytest.raises(ValueError, match=f"unknown {field}"):
        ModelConfig(**kw)


@pytest.mark.parametrize("tiles", [1, 2, 4, 7])
def test_config_takes_spatial_tiles(tiles):
    """Spatial H-tiling is ported (ops/tiling.py): any tile count is a
    valid config; a geometry it cannot tile runs untiled."""
    assert ModelConfig(spatial_tiles=tiles).spatial_tiles == tiles


def test_config_defaults_and_outpairs():
    assert ModelConfig(outpairs="on").outpairs == "on"  # accepted, ignored
    assert ModelConfig().with_dtype(torch.float16).dtype == torch.float16
    assert InferenceConfig().sample_interval == 8


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        from_jax_params({"b": np.zeros(3)})
