"""rerevst_torch's training loop, CLI, data loader and train-state files
vs rerevst_tpu.

* ``train()`` for two steps on jpgs written by cv2 (logs, checkpoints,
  validation grid, diagnostics), resume and ``load_step``, the crash flush,
  and ``python -m rerevst_torch.train --device cpu`` (32x32 crops), as
  ``tests/test_train_loop.py`` drives the JAX package's loop;
* ``FrameDataset``/``Loader`` batches bit-equal to the JAX package's at one
  reader thread;
* a ``ckpt-step*.msgpack`` written by either package resumed by the other:
  the port rewrites the JAX file byte for byte, and the loss after one more
  step on each side agrees to 1e-4 relative;
* ``export_train_checkpoint``/``import_train_checkpoint`` and ``convert
  --train-export/--train-import`` against ``rerevst_tpu.convert``.

fp32 on the CPU, at 64x64 crops (32x32 for the cross-package steps, with a
loss set that skips the relaxed loop: what is checked there is the state).
"""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rerevst_torch.config import LossConfig, ModelConfig, TrainConfig
from rerevst_torch.io import checkpoint as ck
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.train.state import (
    init_train_state,
    load_train_state,
    opt_state_tree,
    tree_leaves,
)
from rerevst_torch.train.step import make_train_step

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The test workers share the machine's cores: two torch threads each,
    or the workers' thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



@pytest.fixture()
def tiny_world(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    for d, n, size in (("content", 4, 80), ("style", 4, 80),
                       ("val/content", 2, 64), ("val/style", 2, 64)):
        (tmp_path / d).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(tmp_path / d / f"{i}.jpg"),
                        (rng.random((size, size, 3)) * 255).astype(np.uint8))
    return tmp_path


def _cfg(tmp_path, **kw) -> TrainConfig:
    return TrainConfig(
        batch_size=2, epochs=1, log_every=2, scalar_every=1, num_workers=1,
        load_size=72, fine_size=64, seed=0,
        content_data=str(tmp_path / "content"),
        style_data=str(tmp_path / "style"),
        out_dir=str(tmp_path / "out"), val_dir=str(tmp_path / "val"),
        log_dir=str(tmp_path / "log"), model=ModelConfig(),
        loss=LossConfig(flow_iter=1), **kw)


def test_train_two_steps_logs_and_checkpoints(tiny_world):
    from rerevst_torch.train.loop import train

    cfg = _cfg(tiny_world)
    state = train(cfg, max_steps=2, device="cpu")
    assert state.step == 2
    lines = open(os.path.join(cfg.log_dir, "scalars.jsonl")).readlines()
    assert len(lines) == 2
    rec = json.loads(lines[-1])
    assert rec["step"] == 2 and np.isfinite(rec["total"])
    assert set(rec) >= {"content", "new_style", "old_style", "recon", "tv",
                        "temporal", "temporal_gt", "total"}
    assert ck.latest_checkpoint(cfg.out_dir) == (
        os.path.join(cfg.out_dir, "ckpt-step00000002.msgpack"), 2)
    assert glob.glob(os.path.join(cfg.out_dir, "Epoch[[]1[]]-validation.png"))
    assert os.path.exists(os.path.join(cfg.out_dir,
                                       "1_RelaxedStyledFirstFrame.png"))


def _cfg_no_val(tmp_path, **kw) -> TrainConfig:
    import dataclasses

    return dataclasses.replace(_cfg(tmp_path, **kw),
                               val_dir=str(tmp_path / "none"))


def test_resume_and_load_step(tiny_world):
    from rerevst_torch.train.loop import train

    cfg = _cfg_no_val(tiny_world)
    train(cfg, max_steps=2, device="cpu")
    state = train(cfg, max_steps=1, resume=True, device="cpu")
    assert state.step == 3
    assert ck.latest_checkpoint(cfg.out_dir)[1] == 3
    state = train(cfg, max_steps=1, resume=True, load_step=2, device="cpu")
    assert state.step == 3
    with pytest.raises(FileNotFoundError, match="step 9"):
        train(cfg, max_steps=1, resume=True, load_step=9, device="cpu")


def test_crash_mid_loop_still_checkpoints(tiny_world, monkeypatch):
    import dataclasses

    from rerevst_torch.train import loop as loop_mod

    cfg = dataclasses.replace(_cfg_no_val(tiny_world), log_every=100,
                              epochs=10)
    calls = {"n": 0}
    real_log = loop_mod.MetricsLogger.log

    def bomb(self, step, metrics):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simulated loader/device death")
        return real_log(self, step, metrics)

    monkeypatch.setattr(loop_mod.MetricsLogger, "log", bomb)
    with pytest.raises(RuntimeError, match="simulated"):
        loop_mod.train(cfg, max_steps=50, device="cpu")
    assert ck.latest_checkpoint(cfg.out_dir)[1] == 2


def test_metrics_logger_without_tensorboard(tmp_path, monkeypatch):
    from rerevst_torch.train.loop import MetricsLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path))
    assert log.tb is None
    log.log(3, {"total": torch.tensor(1.5)})
    log.close()
    assert json.loads(open(tmp_path / "scalars.jsonl").read()) == {
        "step": 3, "total": 1.5}


def test_cli_trains_on_cpu(tiny_world, monkeypatch):
    """``python -m rerevst_torch.train --device cpu``: one step of the
    proposed model from the bundled checkpoint; then, in process, a resume,
    a resume with the adversarial loss (a fresh D, saved beside the
    generator), and the refusal of multi-process training."""
    from rerevst_torch.train.__main__ import main

    args = ["--device", "cpu", "--batchSize", "1", "--epoches", "1",
            "--log", "1", "--num_workers", "1", "--loadSize", "40",
            "--fineSize", "32", "--content_data", "content",
            "--style_data", "style", "--outf", "out", "--valf", "none",
            "--log_dir", "log", "--max_steps", "1", "--dynamic_filter",
            "--both_sty_con", "--style_content_loss", "--recon_loss",
            "--tv_loss", "--temporal_loss", "--relax_style", "--data_sigma",
            "--data_w", "--pretrained",
            str(REPO / "models" / "demo_plum_4000.msgpack"),
            "--vgg_init", "he_relu"]
    res = subprocess.run([sys.executable, "-m", "rerevst_torch.train"] + args,
                         cwd=tiny_world, capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO),
                              "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "(stage: subtree)" in res.stdout  # the loss net is regenerated
    assert ck.latest_checkpoint(str(tiny_world / "out"))[1] == 1
    monkeypatch.chdir(tiny_world)
    main(args + ["--continue_training"])
    assert ck.latest_checkpoint("out")[1] == 2
    main(args + ["--continue_training", "--adaversarial_loss",
                 "--gan_mode", "vanilla", "--ganWeight", "0.5",
                 "--init_type", "orthogonal"])
    assert ck.latest_checkpoint("out")[1] == 3
    assert [os.path.basename(p) for p in glob.glob("out/netD-step*")] == [
        "netD-step00000001.msgpack"]
    with pytest.raises(NotImplementedError, match="item 7"):
        main(args + ["--num_processes", "2"])


def test_loader_batches_match_jax(tiny_world):
    from rerevst_torch.data.datasets import get_loader
    from rerevst_tpu.data.datasets import get_loader as jget_loader

    kw = dict(batch_size=2, load_size=72, fine_size=64, flip=True,
              content_path=str(tiny_world / "content"),
              style_path=str(tiny_world / "style"), num_workers=1, seed=3)
    ours, theirs = get_loader(**kw), jget_loader(**kw)
    for _ in range(2):  # two epochs: the shuffle advances with the epoch
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"Content", "Style"}
            for k in g:
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_loader(**kw, use_mpi=True, use_video=True)
    with pytest.raises(FileNotFoundError):  # no video_data.pickle here
        get_loader(**kw, use_video=True,
                   video_pickle=str(tiny_world / "video_data.pickle"))


# --- train state across the two packages ------------------------------------

CROSS_LOSS = dict(relax_style=False, recon_loss=False, temporal_loss=False)


@pytest.fixture(scope="module")
def cross():
    """A JAX train state, its jitted step, the port's twin of both, and
    a fixed 32x32 batch."""
    from rerevst_tpu.config import LossConfig as JLossConfig
    from rerevst_tpu.config import TrainConfig as JTrainConfig
    from rerevst_tpu.models.transformer import init_transformer_params
    from rerevst_tpu.train.state import init_train_state as jinit
    from rerevst_tpu.train.step import make_train_step as jmake

    jcfg = JTrainConfig(loss=JLossConfig(**CROSS_LOSS))
    params = init_transformer_params(jax.random.PRNGKey(1), jcfg.model,
                                     with_loss_net=True, vgg_scheme="he_relu")
    params["decoder"] = jax.tree.map(lambda a: a * 5.0, params["decoder"])
    rng = np.random.default_rng(9)
    content = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    style = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    return {"jcfg": jcfg, "jstep": jmake(jcfg, params), "jinit": jinit,
            "params": jax.tree.map(np.asarray, params),
            "cfg": TrainConfig(loss=LossConfig(**CROSS_LOSS)),
            "content": content, "style": style}


def _jax_steps(cross, state, n):
    c, s = jnp.asarray(cross["content"]), jnp.asarray(cross["style"])
    for _ in range(n):
        state, metrics = cross["jstep"](state, c, s, jax.random.PRNGKey(0))
    return state, float(metrics["total"])


def _port_state(cross):
    return init_train_state(
        from_jax_params(jax.tree.map(np.array, cross["params"]),
                        device="cpu"), cross["cfg"])


def _port_steps(cross, state, n):
    step = make_train_step(cross["cfg"])
    c, s = (torch.from_numpy(cross[k]) for k in ("content", "style"))
    for _ in range(n):
        state, metrics = step(state, c, s, None)
    return state, float(metrics["total"])


def test_jax_checkpoint_resumes_in_the_port(cross, tmp_path):
    from rerevst_tpu.io.checkpoint import save_train_state as jsave

    jst, _ = _jax_steps(cross, cross["jinit"](cross["params"], cross["jcfg"]),
                        1)
    path = jsave(str(tmp_path / "jax"), 1, jst.params, jst.opt_state)
    state = _port_state(cross)
    p, o = ck.restore_train_state(path, state.params)
    load_train_state(state, p, o, 1)
    # The port writes the JAX package's file byte for byte.
    again = ck.save_train_state(str(tmp_path / "port"), 1, state.params,
                                opt_state_tree(state))
    assert Path(again).read_bytes() == Path(path).read_bytes()
    # One more step on each side (the restored moments at work), then the
    # loss of the next.
    _, want = _jax_steps(cross, jst, 2)
    _, got = _port_steps(cross, state, 2)
    assert abs(got - want) / abs(want) < 1e-4, (got, want)


def test_port_checkpoint_resumes_in_jax(cross, tmp_path):
    from rerevst_tpu.io.checkpoint import restore_train_state as jrestore
    from rerevst_tpu.train.state import TrainState as JTrainState

    state, _ = _port_steps(cross, _port_state(cross), 1)
    path = ck.save_train_state(str(tmp_path), 1, state.params,
                               opt_state_tree(state))
    j0 = cross["jinit"](cross["params"], cross["jcfg"])
    p, o = jrestore(path, j0.params, j0.opt_state)
    jst = JTrainState(p, o, jnp.asarray(1, jnp.int32))
    _, want = _jax_steps(cross, jst, 2)
    _, got = _port_steps(cross, state, 2)
    assert abs(got - want) / abs(want) < 1e-4, (got, want)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_train_export_import_against_jax(tmp_path, monkeypatch):
    """convert --train-export of one JAX checkpoint by both CLIs gives equal
    reference files; --train-import of them by both gives equal native
    checkpoints; the port's functions round-trip the state."""
    import optax

    from rerevst_torch import convert
    from rerevst_torch.io.torch_compat import (
        export_train_checkpoint,
        import_train_checkpoint,
        reference_trainable_param_order,
    )
    from rerevst_tpu import convert as jconvert
    from rerevst_tpu.config import TrainConfig as JTrainConfig
    from rerevst_tpu.io.checkpoint import save_train_state as jsave
    from rerevst_tpu.models.transformer import init_transformer_params
    from rerevst_tpu.train.state import init_train_state as jinit
    from rerevst_tpu.train.state import make_optimizer

    monkeypatch.chdir(tmp_path)
    jcfg = JTrainConfig()
    params = init_transformer_params(jax.random.PRNGKey(0), jcfg.model)
    st = jinit(params, jcfg)
    grads = jax.tree.map(lambda p: jax.random.normal(
        jax.random.PRNGKey(7), np.shape(p)) * 0.01, params)
    upd, opt_state = make_optimizer(jcfg, params).update(grads, st.opt_state,
                                                         params)
    params = optax.apply_updates(params, upd)
    src = jsave(str(tmp_path / "native"), 7, params, opt_state)

    convert.main([src, "port_out", "--train-export"])
    jconvert.main([src, "jax_out", "--train-export"])
    for name in ("style_net-epoch-7.pth", "optimizer-epoch-7.pth"):
        got, want = _load(f"port_out/{name}"), _load(f"jax_out/{name}")
        if name.startswith("style_net"):
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
        else:
            assert got["param_groups"] == want["param_groups"]
            assert len(got["state"]) == len(reference_trainable_param_order())
            for i, w in want["state"].items():
                for k in ("step", "exp_avg", "exp_avg_sq"):
                    assert torch.equal(got["state"][i][k], w[k]), (i, k)

    pth = ["port_out/style_net-epoch-7.pth", "--train-import", "--optimizer",
           "port_out/optimizer-epoch-7.pth"]
    convert.main([pth[0], "port_in"] + pth[1:])
    jconvert.main([pth[0], "jax_in"] + pth[1:])
    # Both name the file by the optimizer's step count (one update).
    got = Path("port_in/ckpt-step00000001.msgpack").read_bytes()
    assert got == Path("jax_in/ckpt-step00000001.msgpack").read_bytes()
    assert got == Path(src).read_bytes()

    # The functions alone: export, then import into a fresh template.
    p, o = ck.restore_train_state(src)
    out = export_train_checkpoint(str(tmp_path / "fn"), 7, p, o)
    tmpl = from_jax_params(init_transformer_params(
        jax.random.PRNGKey(3), jcfg.model), device="cpu")
    p2, o2, step, d = import_train_checkpoint(
        out["style_net"], tmpl, opt_state_tree(
            init_train_state(tmpl, TrainConfig())),
        optimizer_pth=out["optimizer"])
    assert step == 1 and d is None
    again = ck.save_train_state(str(tmp_path / "fn2"), 7, p2, o2)
    assert Path(again).read_bytes() == Path(src).read_bytes()


def test_training_modules_import_no_jax():
    code = ("import sys, rerevst_torch.train.loop, rerevst_torch.train."
            "__main__, rerevst_torch.losses, rerevst_torch.ops.warp, "
            "rerevst_torch.data.datasets; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'rerevst_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("stage", ["direct", "subtree", "legacy"])
def test_pretrained_graft_matches_jax(cross, stage, tmp_path):
    """The reference's three-stage LoadPretrained, on a ``.pth`` and (its
    first two stages) on a ``.msgpack``: the same stage and the same tree
    as the JAX package's, onto the same template."""
    from rerevst_torch.io.torch_compat import (
        graft_pretrained_state_dict,
        load_pretrained,
    )
    from rerevst_tpu.io.checkpoint import save_params as jsave_params
    from rerevst_tpu.io.torch_compat import (
        graft_pretrained_state_dict as jgraft,
    )
    from rerevst_tpu.io.torch_compat import load_pretrained as jload
    from rerevst_tpu.io.torch_compat import to_reference_state_dict

    template = cross["params"]
    src = jax.tree.map(lambda a: np.asarray(a) * 0.5, template)
    if stage != "direct":  # a flags-off checkpoint: no filters, no loss net
        src = {k: v for k, v in src.items() if k != "vgg_loss"}
        src["decoder"] = {k: v for k, v in src["decoder"].items()
                          if not k.startswith("filter")}
    sd = to_reference_state_dict(src)
    if stage == "legacy":
        sd["Decoder.conv_kernel.weight"] = np.zeros((512, 512, 1, 1),
                                                    np.float32)
        sd["Decoder.conv_kernel.bias"] = np.zeros(512, np.float32)
    port_tmpl = from_jax_params(jax.tree.map(np.array, template),
                                device="cpu")
    results = [(jgraft(sd, template), graft_pretrained_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        port_tmpl))]
    if stage != "legacy":
        path = str(tmp_path / "src.msgpack")
        jsave_params(path, src)
        results.append((jload(path, template), load_pretrained(path,
                                                               port_tmpl)))
    for (want, wstage), (got, gstage) in results:
        assert gstage == wstage == stage
        for k, sub in got.items():
            for p, leaf in tree_leaves(sub):
                w = want[k]
                for key in p:
                    w = w[key]
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))
