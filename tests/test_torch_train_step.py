"""rerevst_torch's train step vs rerevst_tpu: ``compute_losses`` with an
injected fake pair, the gradients of one step, one optimizer update on
identical gradients, and the step's own invariants (frozen leaves,
gradient accumulation, rematerialization, refusals).

fp32 on the CPU.  Encoder, style encoder and decoder are the bundled
``demo_plum_4000.msgpack`` upcast to fp32; the loss network is the JAX
package's ``init_vgg_params(PRNGKey(0), scheme='he_relu')``.  Tolerances:
every metric to 1e-4 relative (``flow_iter`` 2: the relaxed loss's two
chained steps stay close); the gradients of selected encoder, decoder and
filter tensors to 1e-3 of each tensor's max-abs (``data_sigma=False``, as
``tests/test_grad_parity.py``); Adam against optax on the SAME gradients to
1e-6 (on the first step the update is +-lr wherever |g| is tiny, so the
two packages' own gradients would flip signs there: they are compared
separately); accumulation to 1e-3 of each gradient's max-abs, the parity
bar (two micro-batches sum the batch in another order: 2.8e-4 at the worst
leaf, a bias ahead of an instance norm, where the terms cancel), and
rematerialization to 1e-6.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from rerevst_torch.config import LossConfig, ModelConfig, TrainConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.train.state import (
    init_train_state,
    opt_state_tree,
    tree_leaves,
)
from rerevst_torch.train.step import compute_losses, make_train_step
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import TrainConfig as JTrainConfig
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.ops.warp import flow_warp as jflow_warp
from rerevst_tpu.train import state as jstate
from rerevst_tpu.train.step import compute_losses as jcompute_losses

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
LCFG = dict(flow_iter=2, data_sigma=False)
GRAD_SITES = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def jax_params():
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jp["vgg_loss"] = jax.tree.map(np.asarray, jV.init_vgg_params(
        jax.random.PRNGKey(0), scheme="he_relu"))
    return jp


def _port_params(jp):
    # A copy: from_jax_params shares numpy's memory, and the optimizer
    # updates its leaves in place.
    return from_jax_params(jax.tree.map(np.array, jp), device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    content = _smooth_images(rng, 2, 64, 64)
    style = _smooth_images(rng, 2, 64, 64)
    flow = (rng.standard_normal((2, 64, 64, 2)) * 2).astype(np.float32)
    second = np.asarray(jflow_warp(jnp.asarray(content), jnp.asarray(flow),
                                   mode="nearest"))
    return content, style, {"Second": second, "FakeFlow": flow}


def _t(batch):
    content, style, extra = batch
    return (torch.from_numpy(content), torch.from_numpy(style),
            {k: torch.from_numpy(np.array(v)) for k, v in extra.items()})


@pytest.fixture(scope="module")
def jax_step(jax_params, batch):
    """JAX total, metrics and gradients of the injected-pair step."""
    content, style, extra = batch
    cfg = JTrainConfig(loss=JLossConfig(**LCFG))

    def loss_fn(p):
        total, (metrics, _) = jcompute_losses(
            p, jnp.asarray(content), jnp.asarray(style),
            jax.random.PRNGKey(0), cfg,
            {k: jnp.asarray(v) for k, v in extra.items()})
        return total, metrics

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_params)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_step(jax_params, batch):
    """The port's metrics and gradients of the same step."""
    cfg = TrainConfig(loss=LossConfig(**LCFG))
    state = init_train_state(_port_params(jax_params), cfg)
    content, style, extra = _t(batch)
    total, (metrics, _) = compute_losses(state.params, content, style, None,
                                         cfg, extra)
    named = [((k,) + p, leaf) for k in state.params
             for p, leaf in tree_leaves(state.params[k]) if leaf.requires_grad]
    grads = torch.autograd.grad(total, [leaf for _, leaf in named])
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {name: g for (name, _), g in zip(named, grads)})


def test_compute_losses_metrics(jax_step, port_step):
    want, _ = jax_step
    got, _ = port_step
    assert set(got) == set(want)
    for k in want:
        rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
        assert rel < 1e-4, (k, got[k], want[k])


@pytest.mark.parametrize("site", GRAD_SITES, ids=lambda s: ".".join(s))
def test_gradients(jax_step, port_step, site):
    want = _get(jax_step[1], site)
    got = port_step[1][site].numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-3, err


def test_adam_matches_optax_on_identical_gradients(jax_params, jax_step):
    """Two updates with the JAX gradients through optax (the JAX package's
    optimizer) and through the port's torch Adam: params and moments."""
    import optax

    _, jgrads = jax_step
    cfg, jcfg = TrainConfig(), JTrainConfig()
    opt = jstate.make_optimizer(jcfg, jax_params)
    jst = jstate.init_train_state(jax_params, jcfg)
    jp, jo = jst.params, jst.opt_state
    state = init_train_state(_port_params(jax_params), cfg)
    for _ in range(2):
        upd, jo = opt.update(jgrads, jo, jp)
        jp = optax.apply_updates(jp, upd)
        for k, sub in state.params.items():
            for path, leaf in tree_leaves(sub):
                leaf.grad = torch.from_numpy(
                    np.array(_get(jgrads, (k,) + path))) \
                    if leaf.requires_grad else None
        state.optimizer.step()
    jp = jax.tree.map(np.asarray, jp)
    for k, sub in state.params.items():
        for path, leaf in tree_leaves(sub):
            want = _get(jp, (k,) + path)
            np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    tree = opt_state_tree(state)["inner_states"]["train"]["inner_state"]["0"]
    jadam = jo.inner_states["train"].inner_state[0]
    assert int(tree["count"]) == int(jadam.count) == 2
    for which, jtree in (("mu", jadam.mu), ("nu", jadam.nu)):
        for k in ("decoder", "encoder", "encoder_style"):
            for path, m in tree_leaves(tree[which][k]):
                want = np.asarray(_get(jtree[k], path))
                np.testing.assert_allclose(
                    m.numpy(), want, rtol=1e-6,
                    atol=1e-6 * max(np.abs(want).max(), 1e-30))


def test_step_updates_trainable_leaves_only(jax_params, batch):
    """After one step every trainable leaf has a finite, nonzero gradient
    and moved; every frozen leaf (the loss network) has none and is
    bit-equal."""
    cfg = TrainConfig(loss=LossConfig(**LCFG))
    state = init_train_state(_port_params(jax_params), cfg)
    before = {(k,) + p: leaf.detach().clone()
              for k in state.params for p, leaf in
              tree_leaves(state.params[k])}
    content, style, extra = _t(batch)
    state, metrics = make_train_step(cfg)(state, content, style, None, extra)
    assert state.step == 1
    assert all(torch.isfinite(v) for v in metrics.values())
    for k, sub in state.params.items():
        for path, leaf in tree_leaves(sub):
            old = before[(k,) + path]
            if k == "vgg_loss":
                assert leaf.grad is None and torch.equal(leaf, old)
            else:
                g = leaf.grad
                assert g is not None and torch.isfinite(g).all()
                assert g.abs().max() > 0, (k, path)
                assert not torch.equal(leaf, old), (k, path)


def test_train_only_decoder_freezes_encoders(jax_params, batch):
    cfg = TrainConfig(train_only_decoder=True,
                      loss=LossConfig(relax_style=False, data_sigma=False))
    state = init_train_state(_port_params(jax_params), cfg)
    frozen = {k for k, sub in state.params.items()
              if not any(l.requires_grad for _, l in tree_leaves(sub))}
    assert frozen == {"vgg_loss", "encoder", "encoder_style"}
    tree = opt_state_tree(state)["inner_states"]["train"]["inner_state"]["0"]
    assert tree["mu"]["encoder"] == {} and tree["mu"]["decoder"]


def _grads_after_step(jax_params, batch, **kw):
    cfg = TrainConfig(loss=LossConfig(relax_style=False, data_sigma=False),
                      **kw)
    state = init_train_state(_port_params(jax_params), cfg)
    content, style, extra = _t(batch)
    state, metrics = make_train_step(cfg)(state, content, style,
                                          torch.Generator().manual_seed(0),
                                          extra)
    grads = {(k,) + p: leaf.grad for k in state.params
             for p, leaf in tree_leaves(state.params[k]) if leaf.requires_grad}
    return grads, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("kw,tol", [({"grad_accum": 2}, 1e-3),
                                    ({"remat": True}, 1e-6)],
                         ids=["grad_accum", "remat"])
def test_memory_options_keep_the_gradient(jax_params, batch, kw, tol):
    """grad_accum=2 gives the full batch's gradient (every loss is a
    per-sample mean; ``relax_style=False``, whose best iterate is chosen per
    micro-batch); remat recomputes the same decode."""
    g1, m1 = _grads_after_step(jax_params, batch)
    g2, m2 = _grads_after_step(jax_params, batch, **kw)
    for k in g1:
        scale = float(g1[k].abs().max())
        assert float((g2[k] - g1[k]).abs().max()) <= tol * scale, k
    for k in m1:
        assert abs(m2[k] - m1[k]) <= 1e-5 * max(abs(m1[k]), 1e-12), k


def test_refusals(jax_params, batch):
    """What the step refuses: the pair-lane kernel, data-parallel training
    (item 7), a batch that micro-batches do not divide, and micro-batches
    with the adversarial loss; the adversarial and ablation flags are
    accepted, and an ablation pair without its mask is an error."""
    from rerevst_torch.train.step import make_adversarial_train_step

    with pytest.raises(ValueError, match="pair-lane"):
        TrainConfig(model=ModelConfig(pairlane=True))
    assert LossConfig(adversarial_loss=True, gan_mode="wgangp").gan_mode \
        == "wgangp"
    for kw in ({"use_mpi": True}, {"use_video": True}):
        assert TrainConfig(**kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        TrainConfig(data_parallel=2)
    with pytest.raises(ValueError, match="grad_accum > 1"):
        make_adversarial_train_step(TrainConfig(
            grad_accum=2, loss=LossConfig(adversarial_loss=True)))
    cfg = TrainConfig(grad_accum=3, loss=LossConfig(relax_style=False))
    state = init_train_state(_port_params(jax_params), cfg)
    content, style, extra = _t(batch)
    with pytest.raises(ValueError, match="must divide the batch"):
        make_train_step(cfg)(state, content, style, None, extra)
    with pytest.raises(KeyError, match="NextContent"):
        compute_losses(state.params, content, style, None, cfg,
                       {"BackwardFlow": extra["FakeFlow"]})


@pytest.mark.parametrize("scheme", ["torch", "he_relu"])
def test_init_tree_and_distributions(scheme):
    """The port's initializers give the JAX package's tree (keys, shapes,
    dtypes) with its distributions: decoder normal(0, 0.02) and zero bias,
    VGG torch-default uniform bounds or he_relu normal(0, sqrt(2 / 9 Cin));
    the values differ (another PRNG)."""
    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_tpu.config import ModelConfig as JModelConfig
    from rerevst_tpu.models.transformer import (
        init_transformer_params as jinit,
    )

    got = init_transformer_params(torch.Generator().manual_seed(0),
                                  ModelConfig(), True, scheme)
    want = jax.eval_shape(lambda k: jinit(k, JModelConfig(), True, scheme),
                          jax.random.PRNGKey(0))
    flat = {(k,) + p: leaf for k in got for p, leaf in tree_leaves(got[k])}
    wflat = {tuple(getattr(e, "key") for e in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat) == set(wflat)
    for path, leaf in flat.items():
        assert tuple(leaf.shape) == wflat[path].shape, path
        assert leaf.dtype == torch.float32
    w = got["decoder"]["res3"]["conv1"]["w"]
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert not got["decoder"]["res3"]["conv1"]["b"].any()
    v = got["encoder"]["conv3_1"]
    fan_in = 9 * 128
    if scheme == "he_relu":
        assert abs(float(v["w"].std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.02
        assert not v["b"].any()
    else:
        bound = (6.0 / (6 * fan_in)) ** 0.5
        assert float(v["w"].abs().max()) <= bound
        assert float(v["w"].abs().max()) > 0.99 * bound
        assert float(v["b"].abs().max()) <= fan_in ** -0.5
    again = init_transformer_params(torch.Generator().manual_seed(0),
                                    ModelConfig(), True, scheme)
    assert torch.equal(again["encoder"]["conv1_1"]["w"],
                       got["encoder"]["conv1_1"]["w"])


def test_from_torch_features_matches_jax(jax_params):
    from rerevst_torch.models.vgg import from_torch_features
    from rerevst_tpu.io.torch_compat import to_reference_state_dict

    sd = to_reference_state_dict({"encoder": jax_params["encoder"]})
    got = from_torch_features(sd, "Encoder.slice.")
    want = jV.from_torch_features(sd, "Encoder.slice.")
    assert set(got) == set(want) == set(jax_params["encoder"])
    for k in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[k][leaf].numpy(),
                                          np.asarray(want[k][leaf]))
