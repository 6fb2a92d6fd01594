"""rerevst_torch's adversarial path vs rerevst_tpu: the PatchGAN
discriminator, ``gan_loss``, the init schemes, one adversarial train step in
each ``gan_mode``, the ``netD-step*.msgpack`` files across the two packages,
the loop's discriminator save and resume, and the ``netD-epoch-N.pth``
interop (``torch_compat`` and ``convert --netd``).

fp32 on the CPU.  The generator is the bundled ``demo_plum_4000.msgpack``
upcast to fp32 with the JAX package's ``init_vgg_params(PRNGKey(0),
scheme='he_relu')`` as its loss network; the discriminator is the JAX
package's ``init_discriminator_params`` (ndf 8; 'kaiming' in the step)
passed across as arrays.
Tolerances: the discriminator to 1e-5 of the output's max-abs; ``gan_loss``
to 1e-6 of the larger of the loss and the mean |logit|; in the step, every metric to 1e-4 relative and the
gradients (every D leaf, selected G leaves) to 1e-3 of each tensor's
max-abs, the bars of ``tests/test_torch_train_step.py``.  After the step's
first Adam update a parameter moves by about +-lr wherever its gradient
is not tiny, so where the JAX gradient is above 1e-3 of the tensor's
max-abs the two packages' parameters agree to 1e-6 of the tensor's
max-abs, and everywhere to within 2 lr (a tiny gradient's sign may
differ).  The JAX step's gradients are read by wrapping its two
optimizers (in the test) so that their states keep the last gradients.
"""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from rerevst_torch.config import LossConfig, TrainConfig
from rerevst_torch.io import checkpoint as ck
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.losses.gan import gan_loss
from rerevst_torch.models.discriminator import (
    discriminator,
    init_conv_weight,
    init_discriminator_params,
)
from rerevst_torch.train.state import (
    d_opt_state_tree,
    init_d_state,
    init_train_state,
    tree_leaves,
)
from rerevst_torch.train.step import make_adversarial_train_step
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import TrainConfig as JTrainConfig
from rerevst_tpu.losses.gan import gan_loss as jgan_loss
from rerevst_tpu.losses.temporal import generate_fake_data as jfake_data
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.models.discriminator import discriminator as jdiscriminator
from rerevst_tpu.models.discriminator import (
    init_discriminator_params as jinit_d,
)
from rerevst_tpu.train import state as jstate
from rerevst_tpu.train import step as jstep

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
MODES = ["lsgan", "vanilla", "wgangp"]
LCFG = dict(flow_iter=1, data_sigma=False, adversarial_loss=True)
G_SITES = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
           ("decoder", "filter1", "p1", "fc", "w"),
           ("encoder", "conv4_1", "w"), ("encoder_style", "conv1_1", "w")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The test workers share the machine's cores: two torch threads each,
    or the workers' thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port(tree):
    # A copy: from_jax_params shares numpy's memory, and Adam updates the
    # leaves in place.
    return from_jax_params(jax.tree.map(np.array, tree), device="cpu")


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


@pytest.fixture(scope="module")
def d_params():
    return jax.tree.map(np.asarray, jinit_d(jax.random.PRNGKey(1), ndf=8))


# --- the discriminator, the loss, the init ----------------------------------

@pytest.mark.parametrize("hw", [32, 33, 70])
def test_discriminator_matches_jax(d_params, hw):
    """Batch 2 through both packages' PatchGAN (train-mode BN): the same
    logits shape (hw -> hw/2 -> hw/4 -> hw/8 -> -1 -> -1, floors) and
    values to 1e-5 of their max-abs."""
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)) \
        .astype(np.float32)
    want = np.asarray(jdiscriminator(d_params, jnp.asarray(x)))
    got = discriminator(_port(d_params), torch.from_numpy(x)).numpy()
    side = hw // 8 - 2
    assert got.shape == want.shape == (2, side, side, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", MODES)
def test_gan_loss_matches_jax(mode):
    """Both targets, on logits with entries of +-30 (the vanilla form's
    exp must not overflow).  The bar is relative to the larger of the loss
    and the mean |logit|: wgangp's mean cancels, and the two packages sum
    in other orders."""
    pred = np.random.default_rng(2).standard_normal((2, 5, 5, 1)) \
        .astype(np.float32)
    pred[0, 0, 0, 0], pred[1, 4, 4, 0] = 30.0, -30.0
    for real in (True, False):
        want = float(jgan_loss(jnp.asarray(pred), real, mode))
        got = float(gan_loss(torch.from_numpy(pred), real, mode))
        assert np.isfinite(got)
        bar = 1e-6 * max(abs(want), float(np.abs(pred).mean()))
        assert abs(got - want) <= bar, (mode, real, got, want)
    with pytest.raises(NotImplementedError):
        gan_loss(torch.from_numpy(pred), True, "hinge")


@pytest.mark.parametrize("scheme", ["normal", "xavier", "kaiming",
                                    "orthogonal"])
def test_init_scheme_statistics(scheme):
    """The std of each scheme against torch.nn.init's on the same shape
    (within 15%, as ``tests/test_gan_datasets.py`` holds the JAX one);
    orthogonal rows with W W^T = gain^2 I; the tree (keys, shapes, dtypes)
    equals the JAX package's, with BN scale N(1, 0.02) and zero biases."""
    import torch.nn.init as tinit

    shape = (4, 4, 64, 128)
    w = init_conv_weight(torch.Generator().manual_seed(0), shape, scheme)
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    tw = torch.empty(128, 64, 4, 4)
    if scheme == "normal":
        tinit.normal_(tw, 0.0, 0.02)
    elif scheme == "xavier":
        tinit.xavier_normal_(tw, gain=0.02)
    elif scheme == "kaiming":
        tinit.kaiming_normal_(tw, a=0, mode="fan_in")
    else:
        tinit.orthogonal_(tw, gain=0.02)
    ts = float(tw.std())
    assert abs(float(w.std()) - ts) < 0.15 * ts, (float(w.std()), ts)
    if scheme == "orthogonal":
        w2d = w.permute(3, 2, 0, 1).reshape(128, -1).double()
        np.testing.assert_allclose((w2d @ w2d.T).numpy(),
                                   0.02 ** 2 * np.eye(128), atol=1e-6)

    ours = init_discriminator_params(torch.Generator().manual_seed(0),
                                     scheme=scheme)
    theirs = jinit_d(jax.random.PRNGKey(0), scheme=scheme)
    got = dict(tree_leaves(ours))
    want = {tuple(getattr(k, "key", k) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.float32
    scale = torch.cat([ours[f"bn{n}"]["scale"] for n in (1, 2, 3)])
    assert abs(float(scale.mean()) - 1.0) < 0.01
    assert abs(float(scale.std()) - 0.02) < 0.005
    for k in ("conv0", "conv_out"):
        assert not ours[k]["b"].any()


def test_refusals():
    with pytest.raises(ValueError, match="grad_accum"):
        make_adversarial_train_step(TrainConfig(
            grad_accum=2, loss=LossConfig(adversarial_loss=True)))
    with pytest.raises(ValueError, match="gan_mode"):
        LossConfig(adversarial_loss=True, gan_mode="hinge")
    with pytest.raises(ValueError, match="d_init"):
        TrainConfig(d_init="uniform")
    with pytest.raises(NotImplementedError, match="item 7"):
        TrainConfig(data_parallel=2, loss=LossConfig(adversarial_loss=True))
    with pytest.raises(ValueError, match="unknown init scheme"):
        init_conv_weight(torch.Generator(), (4, 4, 3, 8), "uniform")


# --- one adversarial step against the JAX package's -------------------------

def _recording(opt):
    """An optax transformation whose state also keeps the last gradients."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def g_params():
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jp["vgg_loss"] = jax.tree.map(np.asarray, jV.init_vgg_params(
        jax.random.PRNGKey(0), scheme="he_relu"))
    return jp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return _smooth_images(rng, 1, 64, 64), _smooth_images(rng, 1, 64, 64)


@pytest.fixture(scope="module")
def d_step_params():
    """The step's discriminator: 'kaiming', under which the gradients
    through D's batch norms are well-conditioned at this size (under the
    default 'normal' init two summation orders give gradients percents of
    their max-abs apart; ``chip_smoke.py`` phase adversarial records it)."""
    return jax.tree.map(np.asarray, jinit_d(jax.random.PRNGKey(1), ndf=8,
                                            scheme="kaiming"))


@pytest.fixture(scope="module")
def jax_steps(g_params, d_step_params, batch):
    """The JAX package's adversarial step in each mode: metrics, the G and D
    gradients, the params after the step, and its fake pair."""
    real_adam, real_make = optax.adam, jstep.make_optimizer

    def adam(lr, b1=0.9, b2=0.999, **kw):  # D's is the one with b1 = 0.5
        o = real_adam(lr, b1=b1, b2=b2, **kw)
        return _recording(o) if b1 == 0.5 else o

    d_params = d_step_params
    content, style = (jnp.asarray(a) for a in batch)
    key = jax.random.PRNGKey(3)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(optax, "adam", adam)
        mp.setattr(jstep, "make_optimizer",
                   lambda cfg, p: _recording(real_make(cfg, p)))
        for mode in MODES:
            cfg = JTrainConfig(loss=JLossConfig(**LCFG, gan_mode=mode))
            fn, d_opt = jstep.make_adversarial_train_step(cfg, g_params,
                                                          d_params)
            g0 = jstate.TrainState(g_params, jstep.make_optimizer(
                cfg, g_params).init(g_params), jnp.zeros((), jnp.int32))
            d0 = jstate.TrainState(d_params, d_opt.init(d_params),
                                   jnp.zeros((), jnp.int32))
            g1, d1, m = fn(g0, d0, content, style, key)
            second, flow = jfake_data(key, content, cfg.loss)
            out[mode] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "g_grads": jax.tree.map(np.asarray, g1.opt_state[1]),
                "d_grads": jax.tree.map(np.asarray, d1.opt_state[1]),
                "g_params": jax.tree.map(np.asarray, g1.params),
                "d_params": jax.tree.map(np.asarray, d1.params),
                "extra": {"Second": np.asarray(second),
                          "FakeFlow": np.asarray(flow)}}
    finally:
        mp.undo()
    return out


def _port_step(g_params, d_params, batch, mode, extra):
    cfg = TrainConfig(loss=LossConfig(**LCFG, gan_mode=mode))
    g = init_train_state(_port(g_params), cfg)
    d = init_d_state(_port(d_params))
    content, style = (torch.from_numpy(a) for a in batch)
    g, d, m = make_adversarial_train_step(cfg)(
        g, d, content, style, None,
        {k: torch.from_numpy(np.array(v)) for k, v in extra.items()})
    return g, d, {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def port_steps(g_params, d_step_params, batch, jax_steps):
    return {mode: _port_step(g_params, d_step_params, batch, mode,
                             jax_steps[mode]["extra"]) for mode in MODES}


def _close_after_step(got, want, grad, lr=1e-4):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * lr + 1e-6 * scale
    sure = np.abs(grad) > 1e-3 * np.abs(grad).max()
    assert np.abs(got - want)[sure].max(initial=0.0) <= 1e-6 * scale


@pytest.mark.parametrize("mode", MODES)
def test_adversarial_step_matches_jax(jax_steps, port_steps, mode):
    want = jax_steps[mode]
    g, d, got = port_steps[mode]
    assert g.step == d.step == 1
    assert set(got) == set(want["metrics"])
    assert {"loss_d", "loss_G_GAN"} <= set(got)
    for k, w in want["metrics"].items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-12), (k, got[k], w)
    for path, leaf in tree_leaves(d.params):
        wg = _get(want["d_grads"], path)
        scale = max(np.abs(wg).max(), 1e-30)
        assert np.abs(leaf.grad.numpy() - wg).max() <= 1e-3 * scale, path
        _close_after_step(leaf.detach().numpy(),
                          _get(want["d_params"], path), wg)
    for site in G_SITES:
        wg = _get(want["g_grads"], site)
        leaf = _get(g.params, site)
        assert np.abs(leaf.grad.numpy() - wg).max() \
            <= 1e-3 * np.abs(wg).max(), site
        _close_after_step(leaf.detach().numpy(),
                          _get(want["g_params"], site), wg)
    # The loss network stays frozen.
    for path, leaf in tree_leaves(g.params["vgg_loss"]):
        assert leaf.grad is None
        assert np.array_equal(leaf.detach().numpy(),
                              _get(want["g_params"]["vgg_loss"], path))


# --- netD-step*.msgpack across the packages ---------------------------------

def _stepped_port_d(d_params, seed, steps=1):
    """A port D state after `steps` Adam steps on seeded gradients."""
    d = init_d_state(_port(d_params))
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for _, leaf in tree_leaves(d.params):
            leaf.grad = torch.randn(leaf.shape, generator=gen) * 0.01
        d.optimizer.step()
        d.step += 1
    return d


def test_port_netd_file_reads_in_jax(d_params, tmp_path):
    from rerevst_torch.train.loop import _save_d_state
    from rerevst_tpu.train.loop import _restore_d_state as jrestore

    d = _stepped_port_d(d_params, 0, steps=2)
    _save_d_state(str(tmp_path), d)
    d_opt = optax.adam(1e-4, b1=0.5, b2=0.9)
    got = jrestore(str(tmp_path), d_params, d_opt.init(d_params))
    assert int(got.step) == 2
    adam = got.opt_state[0]
    assert int(adam.count) == 2
    tree = d_opt_state_tree(d)["0"]
    for path, leaf in tree_leaves(d.params):
        np.testing.assert_array_equal(_get(got.params, path),
                                      leaf.detach().numpy())
        for which, jt in (("mu", adam.mu), ("nu", adam.nu)):
            np.testing.assert_array_equal(_get(jt, path),
                                          _get(tree[which], path).numpy())


def test_jax_netd_file_reads_in_port(d_params, tmp_path):
    """The port restores the JAX package's file, writes it again byte for
    byte, and its next D step equals the one after its own uninterrupted
    run of the same updates; a legacy ``netD.msgpack`` restores with a
    fresh optimizer."""
    from rerevst_torch.train.loop import _restore_d_state, _save_d_state
    from rerevst_tpu.train.loop import _save_d_state as jsave

    d_opt = optax.adam(1e-4, b1=0.5, b2=0.9)
    grads = jax.tree.map(lambda p: np.random.default_rng(4).standard_normal(
        p.shape).astype(np.float32) * 0.01, d_params)
    upd, st = d_opt.update(grads, d_opt.init(d_params), d_params)
    jparams = jax.tree.map(np.asarray, optax.apply_updates(d_params, upd))
    path = jsave(str(tmp_path / "jax"), jstate.TrainState(
        jparams, st, jnp.asarray(5, jnp.int32)))

    d = init_d_state(_port(d_params))
    assert _restore_d_state(str(tmp_path / "jax"), d)
    assert d.step == 5
    again = _save_d_state(str(tmp_path / "port"), d)
    assert Path(again).read_bytes() == Path(path).read_bytes()

    # Resume: one more step from the restored state equals the same step
    # of a port state that took the first update itself.
    ref = init_d_state(_port(d_params))
    for p_, leaf in tree_leaves(ref.params):
        leaf.grad = torch.from_numpy(_get(grads, p_))
    ref.optimizer.step()
    gen = torch.Generator().manual_seed(8)
    nxt = {p_: torch.randn(leaf.shape, generator=gen)
           for p_, leaf in tree_leaves(d.params)}
    for st_ in (d, ref):
        for p_, leaf in tree_leaves(st_.params):
            leaf.grad = nxt[p_].clone()
        st_.optimizer.step()
    for (p_, a), (_, b) in zip(tree_leaves(d.params),
                               tree_leaves(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-7)

    legacy = tmp_path / "legacy"
    ck.save_params(str(legacy / "netD.msgpack"), jparams)
    fresh = _stepped_port_d(d_params, 1)
    assert _restore_d_state(str(legacy), fresh)
    assert fresh.step == 0 and not fresh.optimizer.state
    for p_, leaf in tree_leaves(fresh.params):
        np.testing.assert_array_equal(leaf.detach().numpy(), _get(jparams,
                                                                  p_))


def test_save_keeps_three(d_params, tmp_path):
    from rerevst_torch.train.loop import _save_d_state

    d = init_d_state(_port(d_params))
    for s in range(5):
        d.step = s
        _save_d_state(str(tmp_path), d)
    names = sorted(Path(p).name for p in glob.glob(
        str(tmp_path / "netD-step*.msgpack")))
    assert names == [f"netD-step{s:08d}.msgpack" for s in (2, 3, 4)]


def test_loop_trains_saves_and_resumes_d(tmp_path, monkeypatch):
    """``train()`` with the adversarial loss on a stub loader: D is saved
    beside each generator checkpoint, and resume restores both."""
    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_torch.train import loop

    rng = np.random.default_rng(1)
    batches = [{"Content": _smooth_images(rng, 1, 32, 32),
                "Style": _smooth_images(rng, 1, 32, 32)} for _ in range(2)]
    monkeypatch.setattr(loop, "get_loader", lambda *a, **k: batches)
    cfg = TrainConfig(batch_size=1, epochs=1, log_every=1, scalar_every=1,
                      out_dir=str(tmp_path / "out"),
                      log_dir=str(tmp_path / "log"),
                      val_dir=str(tmp_path / "none"), d_init="xavier",
                      loss=LossConfig(adversarial_loss=True,
                                      relax_style=False, recon_loss=False,
                                      temporal_loss=False))
    monkeypatch.setattr(loop, "_dump_diagnostics", lambda *a, **k: None)

    def params():
        return init_transformer_params(torch.Generator().manual_seed(0),
                                       cfg.model, vgg_scheme="he_relu")

    loop.train(cfg, params=params(), max_steps=1, device="cpu")
    d_files = sorted(glob.glob(str(tmp_path / "out" / "netD-step*")))
    assert [Path(p).name for p in d_files] == ["netD-step00000001.msgpack"]
    assert ck.latest_checkpoint(cfg.out_dir)[1] == 1
    saved = ck.read_msgpack(d_files[0])
    assert int(saved["opt_state"]["0"]["count"]) == 1
    logs = (tmp_path / "log" / "scalars.jsonl").read_text()
    assert "loss_d" in logs and "loss_G_GAN" in logs

    loop.train(cfg, params=params(), max_steps=1, resume=True, device="cpu")
    assert ck.latest_checkpoint(cfg.out_dir)[1] == 2
    saved = ck.read_msgpack(str(tmp_path / "out" /
                                "netD-step00000002.msgpack"))
    assert int(saved["step"]) == 2
    assert int(saved["opt_state"]["0"]["count"]) == 2


# --- netD-epoch-N.pth --------------------------------------------------------

def test_torch_state_dict_matches_jax(d_params, tmp_path):
    from rerevst_torch.io.torch_compat import (
        discriminator_from_torch_state,
        discriminator_to_torch_state,
        export_train_checkpoint,
        import_train_checkpoint,
    )
    from rerevst_tpu.io.torch_compat import (
        discriminator_from_torch_state as jfrom,
    )
    from rerevst_tpu.io.torch_compat import (
        discriminator_to_torch_state as jto,
    )

    got, want = discriminator_to_torch_state(_port(d_params)), jto(d_params)
    assert set(got) == set(want) and "model.3.running_var" in got
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w)
        assert got[k].dtype == torch.from_numpy(np.asarray(w)).dtype, k
    back = discriminator_from_torch_state(got)
    jback = jfrom({k: v.numpy() for k, v in got.items()})
    for p_, leaf in tree_leaves(back):
        np.testing.assert_array_equal(leaf.numpy(), _get(d_params, p_))
        np.testing.assert_array_equal(leaf.numpy(), _get(jback, p_))

    # export_train_checkpoint(d_params=...) -> netD-epoch-N.pth, and back.
    from rerevst_torch.models.transformer import init_transformer_params

    g = init_transformer_params(torch.Generator().manual_seed(0),
                                TrainConfig().model, with_loss_net=False)
    out = export_train_checkpoint(str(tmp_path), 3, g,
                                  d_params=_port(d_params))
    assert Path(out["netD"]).name == "netD-epoch-3.pth"
    _, _, _, d = import_train_checkpoint(out["style_net"], g, {},
                                         netd_pth=out["netD"])
    for p_, leaf in tree_leaves(d):
        np.testing.assert_array_equal(leaf.numpy(), _get(d_params, p_))


def test_convert_netd_against_jax(d_params, tmp_path, monkeypatch, capsys):
    """convert --train-export pairs D with the generator's step (else the
    newest, with a warning) and writes the JAX CLI's netD-epoch-N.pth;
    --train-import --netd writes the JAX CLI's netD-step file, byte for
    byte, with a fresh Adam state."""
    from rerevst_torch import convert
    from rerevst_tpu import convert as jconvert
    from rerevst_tpu.io.checkpoint import save_train_state as jsave
    from rerevst_tpu.models.transformer import init_transformer_params
    from rerevst_tpu.train.loop import _save_d_state as jsave_d

    monkeypatch.chdir(tmp_path)
    jcfg = JTrainConfig()
    params = init_transformer_params(jax.random.PRNGKey(0), jcfg.model)
    st = jstate.init_train_state(params, jcfg)
    src = jsave("native", 7, params, st.opt_state)
    d_opt = optax.adam(1e-4, b1=0.5, b2=0.9)
    jsave_d("native", jstate.TrainState(d_params, d_opt.init(d_params),
                                        jnp.asarray(7, jnp.int32)))
    newer = jax.tree.map(lambda a: a * 2.0, d_params)
    jsave_d("native", jstate.TrainState(newer, d_opt.init(newer),
                                        jnp.asarray(9, jnp.int32)))

    def load(p):
        return torch.load(p, map_location="cpu", weights_only=True)

    convert.main([src, "port_out", "--train-export"])
    jconvert.main([src, "jax_out", "--train-export"])
    got, want = load("port_out/netD-epoch-7.pth"), \
        load("jax_out/netD-epoch-7.pth")
    assert set(got) == set(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            # The JAX CLI writes it with shape [1] (np.ascontiguousarray of
            # a 0-d array); the reference's BatchNorm2d holds a 0-d one.
            assert got[k].shape == () and int(got[k]) == int(want[k]) == 0
        else:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["model.0.weight"], torch.from_numpy(
        np.ascontiguousarray(np.transpose(d_params["conv0"]["w"],
                                          (3, 2, 0, 1)))))

    # No D at the generator's step: the newest, with a warning.
    Path("native/netD-step00000007.msgpack").unlink()
    capsys.readouterr()
    convert.main([src, "port_out2", "--train-export"])
    assert "warning: no netD checkpoint at step 7" in capsys.readouterr().out
    assert torch.equal(load("port_out2/netD-epoch-7.pth")["model.0.weight"],
                       2.0 * got["model.0.weight"])

    args = ["port_out/style_net-epoch-7.pth", "--train-import", "--netd",
            "port_out/netD-epoch-7.pth"]
    convert.main([args[0], "port_in"] + args[1:])
    jconvert.main([args[0], "jax_in"] + args[1:])
    got = Path("port_in/netD-step00000000.msgpack").read_bytes()
    assert got == Path("jax_in/netD-step00000000.msgpack").read_bytes()
    blob = ck.read_msgpack("port_in/netD-step00000000.msgpack")
    assert int(blob["opt_state"]["0"]["count"]) == 0
    assert not any(bool(v.any()) for _, v in
                   tree_leaves(blob["opt_state"]["0"]["mu"]))
