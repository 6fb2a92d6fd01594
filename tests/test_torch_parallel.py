"""rerevst_torch.parallel (the mesh, its collectives, sharded Pass 1 and the
frame-sharded Pass 2) and the data-parallel train step vs rerevst_tpu.

The port's mesh here is logical shards of the CPU (``frame_mesh(n,
devices=['cpu'] * n)``); the JAX side runs on its virtual 8-device CPU mesh
(``tests/conftest.py``), each sharded JAX function jitted once per module.
Weights: the bundled checkpoint upcast to fp32; Pass 1 runs on seeded
healthy relu4_1 features (every channel alive, as in
``tests/test_parallel.py``).  Tolerances: statistics rtol = atol = 2e-4
(the JAX package's bar: the shards sum in another order); frame-sharded
pixels 1e-5 of the output's scale; the sharded train step against the
single step (``LossConfig(relax_style=False, temporal_loss=False)``, whose
losses are per-sample means) metrics rtol 5e-4, atol 5e-6, parameters
atol 2.5e-4 (the first Adam step is about lr sign(g), which flips where
|g| is at noise scale).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.config import LossConfig, ModelConfig, TrainConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.losses.temporal import generate_fake_data
from rerevst_torch.models import transformer as T
from rerevst_torch.parallel import (
    Mesh,
    collect_stats_sharded,
    frame_mesh,
    lift_local,
    local_device_count_in,
    mesh_process_count,
    pad_to_multiple,
    run_sharded,
    stylize_frames_sharded,
)
from rerevst_torch.parallel.streaming import collect_stats_streaming
from rerevst_torch.train.state import init_train_state, tree_leaves
from rerevst_torch.train.step import (
    make_sharded_train_step,
    make_train_step,
    shard_generator,
)
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import ModelConfig as JModelConfig
from rerevst_tpu.config import TrainConfig as JTrainConfig
from rerevst_tpu.models import transformer as jT
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.parallel import mesh as jmesh
from rerevst_tpu.parallel import (
    collect_stats_sharded as jcollect_stats_sharded,
    stylize_frames_sharded as jstylize_frames_sharded,
)
from rerevst_tpu.train import state as jstate
from rerevst_tpu.train.step import make_train_step as jmake_train_step

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
CFG = ModelConfig()
JCFG = JModelConfig()
TRAIN_LOSS = dict(relax_style=False, temporal_loss=False)


def _cpu_mesh(n):
    return frame_mesh(n, devices=["cpu"] * n)


def _t(tree):
    """A JAX tree (NamedTuples, dicts, arrays) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [_t(v) for v in tree]
        cls = {"StyleFeatures": T.StyleFeatures, "NormStats": T.NormStats,
               "SeqStats": T.SeqStats}.get(type(tree).__name__)
        return cls(*out) if cls else tuple(out)
    return torch.from_numpy(np.array(tree, np.float32))


def _leaves(tree):
    if isinstance(tree, torch.Tensor) or hasattr(tree, "shape"):
        return [np.asarray(tree, np.float32)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _stats_close(got, want, rtol=2e-4, atol=2e-4):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) == 11 * 4 + 6
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jparams():
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup(jparams):
    """Style features, 5 healthy feature maps, 3 frames, and the JAX
    package's sharded Pass 1 (2 and 8 devices) and frame-sharded Pass 2."""
    rng = np.random.default_rng(2)
    style = (rng.random((1, 64, 64, 3), np.float32) - 0.5) * 2
    feats = (np.abs(rng.standard_normal((5, 8, 8, 512))).astype(np.float32)
             * (0.5 + rng.random(512, dtype=np.float32)))
    frames = (rng.standard_normal((3, 64, 64, 3)) * 0.5).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, jparams)
    sf = jax.jit(lambda p, s: jT.encode_style(p, s, JCFG))(jp, style)
    jstats = {}
    for n in (2, 8):
        mesh = jmesh.frame_mesh(n)
        jstats[n] = jax.jit(lambda d, f, s, m=mesh: jcollect_stats_sharded(
            d, f, s, JCFG, m))(jp["decoder"], feats, sf)
    pass2 = jstylize_frames_sharded(jp, frames, sf, jstats[2], JCFG,
                                    jmesh.frame_mesh(2))
    return {"params": from_jax_params(jparams, device="cpu"),
            "style": _t(sf), "feats": torch.from_numpy(feats),
            "frames": torch.from_numpy(frames),
            "jstats": {n: _t(s) for n, s in jstats.items()},
            "pass2": np.asarray(pass2), "pass2_stats": _t(jstats[2])}


# --- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("n,mult", [(5, 2), (5, 8), (8, 4), (1, 3)])
def test_pad_to_multiple_matches_jax(n, mult):
    x = np.random.default_rng(n).standard_normal((n, 3, 2)).astype(np.float32)
    want, wmask = jmesh.pad_to_multiple(x, mult)
    got, mask = pad_to_multiple(x, mult)
    assert isinstance(got, np.ndarray) and isinstance(mask, np.ndarray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mask, wmask)
    tgot, tmask = pad_to_multiple(torch.from_numpy(x), mult, axis=0)
    assert isinstance(tgot, torch.Tensor) and tmask.dtype == torch.float32
    np.testing.assert_array_equal(tgot.numpy(), want)
    np.testing.assert_array_equal(tmask.numpy(), wmask)


def test_mesh_helpers_match_jax():
    for n in (1, 2, 8):
        ours, theirs = _cpu_mesh(n), jmesh.frame_mesh(n)
        assert ours.size == theirs.devices.size == n
        assert mesh_process_count(ours) == jmesh.mesh_process_count(theirs)
        assert local_device_count_in(ours) == \
            jmesh.local_device_count_in(theirs)
        assert ours.transport == "threads"
        ours.close()
    # One device per process in a multi-process mesh (a deliberate
    # difference: JAX allows several).
    with pytest.raises(ValueError, match="one device per process"):
        Mesh((torch.device("cpu"),) * 2, None, 0, 2)
    # Without devices named, the mesh needs that many visible cards.
    with pytest.raises((ValueError, RuntimeError)):
        frame_mesh(2)
    # lift_local keeps JAX's divisibility check, text and pad-and-mask.
    two = Mesh((torch.device("cpu"),), None, 0, 2)
    x = torch.arange(3.0).reshape(3, 1)
    assert lift_local(two, x) is x
    xp, m = lift_local(two, x, pad=True)
    assert xp.shape[0] == 3 and m.tolist() == [1, 1, 1]
    wide = Mesh((torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="multi-host content batch must be "
                       "divisible by this process's 2 mesh devices; got 3"):
        lift_local(wide, x, what="content batch")


def test_collectives_are_deterministic_under_stress():
    """16 shards (more than the cores) psum, pmin and exchange rows 40
    times with a 1 us switch interval: every shard gets the same bits, in
    shard order, and the halo rows of its neighbours."""
    mesh = _cpu_mesh(16)
    xs = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        (1, 4, 3, 2)).astype(np.float32)) for i in range(16)]
    want_sum = xs[0].clone()
    for x in xs[1:]:
        want_sum = want_sum + x
    want_min = torch.stack(xs).amin(0)

    def fn(comm, x):
        outs = []
        for _ in range(40):
            outs.append((comm.psum(x), comm.pmin([x])[0],
                         comm.exchange_rows(x, 1)))
        return outs

    workers = mesh.workers()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = run_sharded(fn, mesh, xs, h_shards=4)
    finally:
        sys.setswitchinterval(old)
        mesh.close()
    assert not any(t.is_alive() for t in workers._threads)
    for k, outs in enumerate(res):
        for s, m, ex in outs:
            assert torch.equal(s, want_sum) and torch.equal(m, want_min)
            top = xs[k - 1][:, -1:] if k % 4 else torch.zeros(1, 1, 3, 2)
            bot = xs[k + 1][:, :1] if k % 4 < 3 else torch.zeros(1, 1, 3, 2)
            assert torch.equal(ex, torch.cat([top, xs[k], bot], 1))


def test_a_failing_shard_releases_the_others():
    mesh = _cpu_mesh(4)

    def fn(comm, x):
        if comm.index == 2:
            raise KeyError("shard 2")
        return comm.psum(x)

    with pytest.raises(KeyError, match="shard 2"):
        run_sharded(fn, mesh, [torch.ones(1)] * 4)
    assert run_sharded(lambda comm, x: comm.psum(x), mesh,
                       [torch.ones(1)] * 4)[0].item() == 4.0
    mesh.close()


def test_imports_leave_jax_out():
    code = ("import sys, rerevst_torch.parallel, "
            "rerevst_torch.parallel.dryrun, rerevst_torch.train, "
            "rerevst_torch.train.__main__, rerevst_torch.api; "
            "print('jax' in sys.modules, 'rerevst_tpu' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# --- Pass 1 -----------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_collect_matches_jax_and_unsharded(setup, ndev):
    """5 frames over 2 and 8 shards (1 and 3 pad frames, masked)."""
    dec = setup["params"]["decoder"]
    mesh = _cpu_mesh(ndev)
    with torch.inference_mode():
        got = collect_stats_sharded(dec, setup["feats"], setup["style"], CFG,
                                    mesh)
        single = T.collect_stats(dec, setup["feats"], setup["style"], CFG)
    mesh.close()
    _stats_close(got, setup["jstats"][ndev])
    _stats_close(got, single)


def test_masked_collect_equals_unpadded(setup):
    """The mask alone (no mesh): a pad frame changes nothing; without
    either argument the collection is the unsharded code, bit for bit."""
    dec, sf, feats = setup["params"]["decoder"], setup["style"], \
        setup["feats"]
    with torch.inference_mode():
        plain = T.collect_stats(dec, feats, sf, CFG)
        padded = torch.cat([feats, feats[-1:] * 7.0])
        mask = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32)
        masked = T.collect_stats(dec, padded, sf, CFG, mask=mask)
        again = T.collect_stats(dec, feats, sf, CFG, None, None)
    _stats_close(masked, plain)
    for a, b in zip(_leaves(again), _leaves(plain)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndev", [2, 3])
def test_sharded_streaming_matches_batched(setup, ndev):
    """Chunks of 2 (raised to the shard count: 5 frames in chunks of 3 and
    2 over 3 shards), padded and masked per chunk, against the batched
    collection."""
    dec, sf, feats = setup["params"]["decoder"], setup["style"], \
        setup["feats"]
    mesh = _cpu_mesh(ndev)
    with torch.inference_mode():
        batched = T.collect_stats(dec, feats, sf, CFG)
    streamed = collect_stats_streaming(dec, feats.numpy(), sf, CFG,
                                       chunk_size=2, mesh=mesh)
    mesh.close()
    _stats_close(streamed, batched)


def test_replica_cache():
    """``Mesh.replica`` makes a replica once per tree and device, keeps it
    while `fresh` says so, and makes it anew when `fresh` says it fell
    behind (the train step's replicas of a state that steps)."""
    mesh = _cpu_mesh(2)
    dev = torch.device("cpu")
    tree = {"w": torch.ones(3), "b": (torch.zeros(2),)}
    copy = mesh.replica(tree, dev)
    assert copy is mesh.replica(tree, dev) and copy["w"] is tree["w"]
    state = {"step": 0}
    made = []

    def make(t, d):
        made.append(d)
        return {"step": t["step"]}

    def rep():
        return mesh.replica(state, dev, make=make,
                            fresh=lambda r: r["step"] == state["step"])

    first = rep()
    assert rep() is first and made == [dev]
    state["step"] = 1
    again = rep()
    assert again is not first and again["step"] == 1 and len(made) == 2
    mesh.close()


# --- Pass 2 -----------------------------------------------------------------

def test_frame_sharded_pass2_matches_jax(setup):
    """3 frames over 2 shards (one pad frame, cropped) with the JAX
    statistics: the JAX package's frame-sharded pixels to 1e-5."""
    mesh = _cpu_mesh(2)
    with torch.inference_mode():
        got = stylize_frames_sharded(setup["params"], setup["frames"],
                                     setup["style"], setup["pass2_stats"],
                                     CFG, mesh)
        # The replicas are the session's own tensors on a one-device mesh.
        assert mesh.replica(setup["params"], torch.device("cpu")) is \
            mesh.replica(setup["params"], torch.device("cpu"))
    mesh.close()
    want = setup["pass2"]
    assert got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --- the data-parallel train step --------------------------------------------

@pytest.fixture(scope="module")
def train_setup(jparams):
    tree = dict(jparams)
    tree["vgg_loss"] = jax.tree.map(np.asarray, jV.init_vgg_params(
        jax.random.PRNGKey(0), scheme="he_relu"))
    rng = np.random.default_rng(7)
    content = (rng.random((4, 32, 32, 3), np.float32) - 0.5) * 3
    style = (rng.random((4, 32, 32, 3), np.float32) - 0.5) * 3
    jcfg = JTrainConfig(loss=JLossConfig(**TRAIN_LOSS))
    jp = jax.tree.map(jnp.asarray, tree)
    s1, m1 = jmake_train_step(jcfg, jp)(jstate.init_train_state(jp, jcfg),
                                        jnp.asarray(content),
                                        jnp.asarray(style),
                                        jax.random.PRNGKey(11))
    return tree, content, style, ({k: float(v) for k, v in m1.items()},
                                  jax.tree.map(np.asarray, s1.params))


def _port_state(tree, cfg):
    # A copy: from_jax_params shares numpy's memory; Adam updates in place.
    return init_train_state(from_jax_params(
        jax.tree.map(np.array, tree), device="cpu"), cfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_step_matches_single_steps(train_setup, accum):
    """One step over 2 logical shards (with grad_accum 1 or 2 inside each
    shard) against the port's single step and the JAX package's single
    step on the same batch."""
    tree, content, style, (jmetrics, jparams_after) = train_setup
    cfg = TrainConfig(batch_size=4, grad_accum=accum,
                      loss=LossConfig(**TRAIN_LOSS))
    scfg = TrainConfig(loss=LossConfig(**TRAIN_LOSS))
    single, m1 = make_train_step(scfg)(
        _port_state(tree, scfg), torch.from_numpy(content),
        torch.from_numpy(style), None)
    mesh = _cpu_mesh(2)
    state = _port_state(tree, cfg)
    state, m2 = make_sharded_train_step(cfg, mesh)(
        state, torch.from_numpy(content), torch.from_numpy(style), None)
    mesh.close()
    assert state.step == 1
    for k in m1:
        for want in (float(m1[k]), jmetrics[k]):
            np.testing.assert_allclose(float(m2[k]), want, rtol=5e-4,
                                       atol=5e-6, err_msg=k)
    before = dict(tree_leaves(_port_state(tree, cfg).params))
    moved = 0
    for path, leaf in tree_leaves(state.params):
        got = leaf.detach().numpy()
        want = jparams_after
        for k in path:
            want = want[k]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2.5e-4,
                                   err_msg=str(path))
        np.testing.assert_allclose(got, dict(tree_leaves(single.params))[
            path].detach().numpy(), rtol=0, atol=2.5e-4, err_msg=str(path))
        moved += int(not np.array_equal(got, before[path].detach().numpy()))
    assert moved > 0  # the step updated something


def test_per_shard_generators_draw_distinct_flows():
    """Each shard's fake motion comes from its own generator: the same
    seed and shard index repeat, other shards differ."""
    content = torch.zeros(1, 32, 32, 3)
    lcfg = LossConfig()

    def flow(seed, index):
        return generate_fake_data(shard_generator(seed, index, "cpu"),
                                  content, lcfg)[1]

    assert torch.equal(flow(5, 0), flow(5, 0))
    assert not torch.equal(flow(5, 0), flow(5, 1))
    assert not torch.equal(flow(5, 1), flow(6, 1))


def test_indivisible_batch_raises(train_setup):
    tree, content, style, _ = train_setup
    cfg = TrainConfig(loss=LossConfig(**TRAIN_LOSS))
    mesh = _cpu_mesh(2)
    step = make_sharded_train_step(cfg, mesh)
    with pytest.raises(ValueError, match=r"sharded train step needs batch "
                       r"divisible by the mesh \(2 devices\); got content "
                       r"batch 3, style batch 3. Pick batch_size = k \* 2."):
        step(_port_state(tree, cfg), torch.from_numpy(content[:3]),
             torch.from_numpy(style[:3]), None)
    mesh.close()
