"""rerevst_torch's Figure-16 ablations and U-Net vs rerevst_tpu: the MPI and
video temporal losses, ``compute_losses`` with each ablation pair (metrics
and gradients), ``MPIDataset``/``VideoDataset`` items and ``get_loader``
batches on synthetic trees, one ``train()`` step on the MPI tree, and the
U-Net forward.

fp32 on the CPU.  The generator is the bundled ``demo_plum_4000.msgpack``
upcast to fp32 with the JAX package's he_relu ``vgg_loss``.  Tolerances:
the losses alone to 1e-6 relative; in ``compute_losses`` every metric to
1e-4 relative and the selected gradients to 1e-3 of each tensor's max-abs
(the bars of ``tests/test_torch_train_step.py``); dataset items and loader
batches bit-equal (the same Python ``random`` draws, numpy, scipy and cv2
calls in the same order); the U-Net to 1e-5 of the output's max-abs.  The
trees are the synthetic ones of ``tests/test_ablation_losses.py``: MPI
Sintel's ``clean/``, ``flow_mat/*.mat`` and ``occlusions/``; a video zip
with ``.npy`` flow; the reference's ``video_data.pickle`` schema with
raw-float flow blobs behind a 32-float header and a ``.zip`` of styles.
"""

import io
import pickle
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.config import LossConfig, TrainConfig
from rerevst_torch.io.convert import from_jax_params
from rerevst_torch.losses.temporal import (
    temporal_loss_mpi,
    temporal_loss_video,
)
from rerevst_torch.models.unet import init_unet_params, unet
from rerevst_torch.train.state import init_train_state, tree_leaves
from rerevst_torch.train.step import compute_losses
from rerevst_tpu.config import LossConfig as JLossConfig
from rerevst_tpu.config import TrainConfig as JTrainConfig
from rerevst_tpu.losses import temporal as jtemporal
from rerevst_tpu.models import vgg as jV
from rerevst_tpu.train.step import compute_losses as jcompute_losses

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "demo_plum_4000.msgpack"
LCFG = dict(relax_style=False, data_sigma=False)
GRAD_SITES = [("decoder", "out", "w"), ("decoder", "res2", "conv2", "w"),
              ("decoder", "filter1", "p1", "fc", "w"),
              ("encoder", "conv4_1", "w"), ("encoder_style", "conv1_1", "w")]
#: The two ablations' ``extra`` keys: (flow, mask).
ABLATIONS = [("BackwardFlow", "BackwardMask"), ("ForwardFlow", "ForwardMask")]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _pair(seed, n=1, hw=64):
    """A smooth frame, the next one (a whole-pixel flow applied to it), the
    flow and a mask of valid pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    f = rng.uniform(0.03, 0.2, (n, 3, 2))
    pre = np.stack([np.stack([np.sin(xx * f[i, c, 0] + yy * f[i, c, 1] + c)
                              for c in range(3)], -1) for i in range(n)])
    flow = rng.integers(-3, 4, (n, hw, hw, 2)).astype(np.float32)
    nxt = np.asarray(jtemporal.flow_warp(jnp.asarray(pre), jnp.asarray(flow),
                                         mode="nearest"))
    nxt = nxt + rng.standard_normal(nxt.shape).astype(np.float32) * 0.05
    mask = (rng.random((n, hw, hw)) > 0.2).astype(np.float32)
    return pre.astype(np.float32), nxt.astype(np.float32), flow, mask


@pytest.mark.parametrize("name", ["temporal_loss_mpi", "temporal_loss_video"])
def test_temporal_losses_match_jax(name):
    cur, pre, flow, mask = _pair(1, n=2, hw=24)
    mask = mask[..., None]
    want, wfake = getattr(jtemporal, name)(*map(jnp.asarray,
                                                (cur, pre, flow, mask)))
    fn = {"temporal_loss_mpi": temporal_loss_mpi,
          "temporal_loss_video": temporal_loss_video}[name]
    got, fake = fn(*map(torch.from_numpy, (cur, pre, flow, mask)))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_array_equal(fake.numpy(), np.asarray(wfake))


# --- compute_losses with an ablation pair ------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jp["vgg_loss"] = jax.tree.map(np.asarray, jV.init_vgg_params(
        jax.random.PRNGKey(0), scheme="he_relu"))
    return jp


@pytest.mark.parametrize("flow_key,mask_key", ABLATIONS,
                         ids=["mpi", "video"])
def test_compute_losses_with_ablation_pair(jax_params, flow_key, mask_key):
    """A 3-D mask (as the loaders give it); the metrics, the aux frames and
    the gradients against the JAX package's."""
    content, nxt, flow, mask = _pair(2)
    style = _pair(3)[0]
    extra = {"NextContent": nxt, flow_key: flow, mask_key: mask}
    jcfg = JTrainConfig(loss=JLossConfig(**LCFG))

    def loss_fn(p):
        total, (metrics, aux) = jcompute_losses(
            p, jnp.asarray(content), jnp.asarray(style),
            jax.random.PRNGKey(0), jcfg,
            {k: jnp.asarray(v) for k, v in extra.items()})
        return total, (metrics, aux["fake_styled_second"])

    (_, (jm, jfake)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_params)

    cfg = TrainConfig(loss=LossConfig(**LCFG))
    state = init_train_state(from_jax_params(
        jax.tree.map(np.array, jax_params), device="cpu"), cfg)
    total, (metrics, aux) = compute_losses(
        state.params, torch.from_numpy(content), torch.from_numpy(style),
        None, cfg, {k: torch.from_numpy(v) for k, v in extra.items()})
    assert {"styled_second", "fake_styled_second"} <= set(aux)
    assert "second" not in aux  # no synthetic pair was drawn
    assert not metrics["temporal_gt"].requires_grad
    assert set(metrics) == set(jm)
    for k, w in jm.items():
        got, w = float(metrics[k]), float(w)
        assert abs(got - w) <= 1e-4 * max(abs(w), 1e-12), (k, got, w)
    assert float(metrics["temporal_gt"]) > 0
    fake = aux["fake_styled_second"].detach().numpy()
    assert np.abs(fake - np.asarray(jfake)).max() \
        <= 1e-4 * np.abs(np.asarray(jfake)).max()
    leaves = [_get(state.params, s) for s in GRAD_SITES]
    for site, g in zip(GRAD_SITES, torch.autograd.grad(total, leaves)):
        want = np.asarray(_get(jgrads, site))
        assert np.abs(g.numpy() - want).max() <= 1e-3 * np.abs(want).max(), \
            site


# --- datasets ------------------------------------------------------------------

@pytest.fixture()
def mpi_tree(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    import scipy.io as scio

    h, w = 80, 96
    clean = tmp_path / "mpi" / "clean" / "alley_1"
    occ = tmp_path / "mpi" / "occlusions" / "alley_1"
    fmat = tmp_path / "mpi" / "flow_mat"
    for d in (clean, occ, fmat):
        d.mkdir(parents=True)
    for i in (1, 2, 3):
        cv2.imwrite(str(clean / f"frame_{i:04d}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
    for i in (1, 2):
        cv2.imwrite(str(occ / f"frame_{i:04d}.png"),
                    (rng.random((h, w, 3)) > 0.9).astype(np.uint8) * 255)
        scio.savemat(str(fmat / f"alley_1_frame_{i:04d}.mat"),
                     {"Img": rng.standard_normal((h, w, 2)) * 4})
    styles = tmp_path / "style"
    styles.mkdir()
    for i in range(2):
        cv2.imwrite(str(styles / f"s{i}.jpg"),
                    (rng.random((48 + 16 * i, 64, 3)) * 255).astype(np.uint8))
    return str(tmp_path / "mpi"), str(styles)


def _png(cv2, img):
    return cv2.imencode(".png", img)[1].tobytes()


@pytest.fixture()
def video_trees(tmp_path, rng):
    """Two archives: our schema (``.npy`` flow, a style directory) and the
    reference's (a ``video_data.pickle`` of member lists, raw-float flow
    blobs, a ``.zip`` of styles)."""
    cv2 = pytest.importorskip("cv2")
    h, w = 72, 80
    ours, ref = str(tmp_path / "video.zip"), str(tmp_path / "ref.zip")
    with zipfile.ZipFile(ours, "w") as zo, zipfile.ZipFile(ref, "w") as zr:
        for i in range(3):
            for z in (zo, zr):
                z.writestr(f"f{i}.png", _png(cv2, (rng.random((h, w, 3))
                                                    * 255).astype(np.uint8)))
                z.writestr(f"m{i}.png", _png(cv2, (rng.random((h, w, 3)) > 0.8)
                                         .astype(np.uint8) * 255))
            flow = (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)
            bio = io.BytesIO()
            np.save(bio, flow)
            zo.writestr(f"flow{i}.npy", bio.getvalue())
            zr.writestr(f"flow_mat/flow{i}", np.concatenate(
                [np.zeros(32, np.float32), flow.ravel()]).tobytes())
    styles = tmp_path / "video_style"
    styles.mkdir()
    spath = str(tmp_path / "styles.zip")
    with zipfile.ZipFile(spath, "w") as zs:
        for i in range(2):
            img = (rng.random((64, 48 + 8 * i, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(styles / f"s{i}.jpg"), img)
            zs.writestr(f"s{i}.jpg", cv2.imencode(".jpg", img)[1].tobytes())
        zs.writestr("notes.txt", b"not a style")
    pairs = [(f"f{i}.png", f"f{i + 1}.png") for i in range(2)]
    data = {"frames": pairs, "flows": ["flow0.npy", "flow1.npy"],
            "masks": ["m0.png", "m1.png"]}
    pkl = str(tmp_path / "video_data.pickle")
    with open(pkl, "wb") as f:
        pickle.dump({"pre_frame_list": [p for p, _ in pairs],
                     "cur_frame_list": [c for _, c in pairs],
                     "flow_list": ["flow_mat/flow0", "flow_mat/flow1"],
                     "mask_list": ["m0.png", "m1.png"]}, f)
    return {"ours": (ours, str(styles), data), "ref": (ref, spath, pkl)}


def _items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flip", [True, False])
def test_mpi_items_match_jax(mpi_tree, flip):
    from rerevst_torch.data.datasets import MPIDataset
    from rerevst_tpu.data.datasets import MPIDataset as JMPIDataset

    mpi, style = mpi_tree
    kw = dict(load_size=72, fine_size=48, flip=flip, mpi_path=mpi,
              style_path=style)
    ours, theirs = MPIDataset(**kw, seed=4), JMPIDataset(**kw, seed=4)
    assert len(ours) == len(theirs) == 2
    for _ in range(3):  # the rng advances: more crops and flips
        for i in range(2):
            item = ours[i]
            _items_equal(item, theirs[i])
    assert item["BackwardMask"].shape == (48, 48, 3)
    assert 0.0 <= item["BackwardMask"].min() <= item["BackwardMask"].max() \
        <= 1.0


def test_video_items_match_jax(video_trees):
    from rerevst_torch.data.datasets import VideoDataset
    from rerevst_tpu.data.datasets import VideoDataset as JVideoDataset

    zpath, style, data = video_trees["ours"]
    kw = dict(load_size=72, fine_size=48, flip=True, video_path=zpath,
              style_path=style, data=data)
    ours, theirs = VideoDataset(**kw, seed=2), JVideoDataset(**kw, seed=2)
    for _ in range(3):
        for i in range(2):
            _items_equal(ours[i], theirs[i])


@pytest.mark.parametrize("which", ["mpi", "video_pickle"])
def test_get_loader_matches_jax(mpi_tree, video_trees, which):
    """``get_loader(use_mpi/use_video)`` batches, one reader thread, two
    epochs; the video case reads the reference's pickle, its raw flow blobs
    and its zip of styles."""
    from rerevst_torch.data.datasets import get_loader
    from rerevst_tpu.data.datasets import get_loader as jget_loader

    if which == "mpi":
        kw = dict(content_path=mpi_tree[0], style_path=mpi_tree[1],
                  use_mpi=True)
        keys = {"Content", "NextContent", "BackwardFlow", "BackwardMask",
                "Style"}
    else:
        zpath, spath, pkl = video_trees["ref"]
        kw = dict(content_path=zpath, style_path=spath, use_video=True,
                  video_pickle=pkl)
        keys = {"Content", "NextContent", "ForwardFlow", "ForwardMask",
                "Style"}
    kw.update(batch_size=1, load_size=72, fine_size=48, flip=True,
              num_workers=1, seed=3)
    ours, theirs = get_loader(**kw), jget_loader(**kw)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == keys
            _items_equal(g, w)
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_loader(1, use_mpi=True, use_video=True)


def test_train_steps_on_the_mpi_tree(mpi_tree, tmp_path, monkeypatch):
    """``train()`` with ``use_mpi``: the loader's pairs reach the ablation
    loss (``temporal_gt`` of real pairs is not 0, as it is for the
    synthetic pair without noise)."""
    import json

    from rerevst_torch.models.transformer import init_transformer_params
    from rerevst_torch.train import loop

    monkeypatch.setattr(loop, "_dump_diagnostics", lambda *a, **k: None)
    cfg = TrainConfig(batch_size=1, epochs=1, log_every=1, scalar_every=1,
                      num_workers=1, load_size=72, fine_size=32,
                      content_data=mpi_tree[0], style_data=mpi_tree[1],
                      use_mpi=True, out_dir=str(tmp_path / "out"),
                      log_dir=str(tmp_path / "log"),
                      val_dir=str(tmp_path / "none"),
                      loss=LossConfig(**LCFG, recon_loss=False))
    params = init_transformer_params(torch.Generator().manual_seed(0),
                                     cfg.model, vgg_scheme="he_relu")
    loop.train(cfg, params=params, max_steps=2, device="cpu")
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "scalars.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    assert all(r["temporal_gt"] > 0 and np.isfinite(r["total"])
               for r in rows)


# --- the U-Net -----------------------------------------------------------------

def test_unet_matches_jax():
    from rerevst_tpu.models.unet import init_unet_params as jinit
    from rerevst_tpu.models.unet import unet as junet

    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), ngf=8,
                                            num_downs=3))
    # Weights x5: the 0.02 init leaves the tanh output near its bias.
    params = jax.tree.map(lambda a: a * 5.0, params)
    x = np.random.default_rng(0).standard_normal((2, 32, 40, 3)) \
        .astype(np.float32)
    want = np.asarray(junet(params, jnp.asarray(x), num_downs=3))
    got = unet(from_jax_params(jax.tree.map(np.array, params), device="cpu"),
               torch.from_numpy(x), num_downs=3).numpy()
    assert got.shape == want.shape == (2, 32, 40, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    ours = init_unet_params(torch.Generator().manual_seed(0), ngf=8,
                            num_downs=3)
    assert {p: tuple(v.shape) for p, v in tree_leaves(ours)} == {
        tuple(getattr(k, "key", k) for k in p): v.shape for p, v in
        jax.tree_util.tree_flatten_with_path(params)[0]}
