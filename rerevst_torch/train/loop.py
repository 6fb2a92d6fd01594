"""Training loop: epochs, logging, validation grid, checkpoints, resume —
``rerevst_tpu/train/loop.py``.

The same observable contract as the JAX package: the same console line and
``scalars.jsonl`` names every ``scalar_every`` iterations (TensorBoard too
where ``torch.utils.tensorboard`` imports), a fixed validation grid at each
log point, best-loss-gated step-tagged checkpoints every ``log_every``
iterations, restart-safe resume, and a checkpoint flushed in ``finally``
when the run dies between log points.

With ``LossConfig(adversarial_loss=True)`` the loop also trains the
PatchGAN discriminator (seeded from ``cfg.seed + 99`` with ``cfg.d_init``)
and saves it beside each generator checkpoint as
``netD-step{step:08d}.msgpack`` (params, Adam state, step), the file the JAX
package writes; ``resume`` restores it.

Host-side init (the seeded parameters, a pretrained graft) runs on the CPU
and moves to the device once.  Reading images (the loader, the validation
grid, the diagnostic dumps) needs cv2, which the card's machine lacks.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from rerevst_torch.config import TrainConfig, resolve_device
from rerevst_torch.data.datasets import get_loader
from rerevst_torch.data.transforms import bgr_to_model, model_to_bgr
from rerevst_torch.io.checkpoint import (
    checkpoint_at_step,
    latest_checkpoint,
    read_msgpack,
    restore_train_state,
    save_params,
    save_train_state,
)
from rerevst_torch.models.transformer import (
    TransformerNet,
    init_transformer_params,
)
from rerevst_torch.train.state import (
    TrainState,
    d_opt_state_tree,
    init_d_state,
    init_train_state,
    load_d_opt_state_tree,
    load_train_state,
    opt_state_tree,
    tree_leaves,
)
from rerevst_torch.train.step import (
    compute_losses,
    make_adversarial_train_step,
    make_train_step,
)

_SCALAR_NAMES = {
    "temporal": "temporal", "content": "content", "new_style": "new style",
    "old_style": "old style", "recon": "recon", "tv": "tv",
    "temporal_gt": "temporal GT", "loss_G_GAN": "loss_G_GAN",
    "loss_d": "loss_d",
}


class MetricsLogger:
    """JSONL scalar sink, plus TensorBoard where it imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=log_dir)
        except Exception:  # noqa: BLE001 — any import failure: JSONL only
            self.tb = None

    def log(self, step: int, metrics: Dict):
        vals = {k: float(v) for k, v in metrics.items()}
        self.jsonl.write(json.dumps({"step": step, **vals}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalars("scalar/loss", {
                _SCALAR_NAMES[k]: v for k, v in vals.items()
                if k in _SCALAR_NAMES}, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class Validation:
    """Fixed 6x6 content x style render grid (``train/train.py:221-249``)."""

    def __init__(self, val_dir: str, net: TransformerNet, out_dir: str,
                 device: torch.device, n: int = 6, size: int = 256):
        import cv2

        self.net, self.out_dir, self.device = net, out_dir, device
        self.pairs = []
        contents = sorted(glob.glob(os.path.join(val_dir, "content",
                                                 "*.jpg")))[:n]
        styles = sorted(glob.glob(os.path.join(val_dir, "style",
                                               "*.jpg")))[:n]
        for c, s in zip(contents, styles):
            ci = cv2.resize(cv2.imread(c), (size, size))
            si = cv2.resize(cv2.imread(s), (size, size))
            self.pairs.append((bgr_to_model(ci), bgr_to_model(si)))

    def save_results(self, params: Dict, epoch: int):
        import cv2

        os.makedirs(self.out_dir, exist_ok=True)
        cols = []
        for i, (c, s) in enumerate(self.pairs):
            with torch.no_grad():
                out = self.net.validation(
                    params, torch.from_numpy(c).to(self.device),
                    torch.from_numpy(s).to(self.device))
            # result | content | style, stacked vertically.
            col = np.concatenate([model_to_bgr(out.float().cpu().numpy()),
                                  model_to_bgr(c), model_to_bgr(s)], axis=0)
            cv2.imwrite(os.path.join(
                self.out_dir, f"Epoch[{epoch}]-validation-{i}.png"), col)
            cols.append(col)
        if cols:  # one combined grid per epoch: the pairs side by side
            cv2.imwrite(os.path.join(
                self.out_dir, f"Epoch[{epoch}]-validation.png"),
                np.concatenate(cols, axis=1))


def _dump_diagnostics(params: Dict, content: torch.Tensor,
                      style: torch.Tensor, gen: torch.Generator,
                      cfg: TrainConfig, epoch: int, extra: Optional[Dict]):
    """The reference's per-log diagnostic images (``train/train.py:459-474``):
    the input pair, the styled result, the relaxed-warped style and its
    residual, the recon outputs and the fake second frame trio."""
    import cv2

    with torch.no_grad():
        _, (_, aux) = compute_losses(params, content, style, gen, cfg, extra)
    os.makedirs(cfg.out_dir, exist_ok=True)

    def dump(name, x, is_image=True):
        if x is None:
            return
        arr = x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)
        if is_image:
            img = model_to_bgr(arr)
        else:
            a = arr[0]
            rng_ = a.max() - a.min()
            img = ((a - a.min()) / (rng_ + 1e-8) * 255)[..., ::-1]
            img = img.astype(np.uint8)
        cv2.imwrite(os.path.join(cfg.out_dir, f"{epoch}_{name}.png"), img)

    dump("FirstFrame", content)
    dump("Style", style)
    dump("StyledFirstFrame", aux.get("styled"))
    if "relaxed_style" in aux:
        dump("RelaxedStyledFirstFrame", aux["relaxed_style"])
        dump("RelaxedResidual",
             (aux["relaxed_style"].float() - style.float()).abs(),
             is_image=False)
    dump("ReconFirstFrame", aux.get("recon_content"))
    dump("ReconFirstStyle", aux.get("recon_style"))
    dump("SecondFrame", aux.get("second"))
    dump("StyledSecondFrame", aux.get("styled_second"))
    dump("FakeStyledSecondFrame_1", aux.get("fake_styled_second"))


def _save_d_state(out_dir: str, d_state: TrainState, keep: int = 3) -> str:
    """``netD-step{step:08d}.msgpack``: D's params, its Adam state (plain
    optax ``adam``'s tree) and step; the newest `keep` are kept.  The
    reference saves D's weights alone (``netD-epoch-N.pth``)."""
    path = os.path.join(out_dir, f"netD-step{d_state.step:08d}.msgpack")
    save_params(path, {"params": d_state.params,
                       "opt_state": d_opt_state_tree(d_state),
                       "step": d_state.step})
    old = sorted(glob.glob(os.path.join(out_dir, "netD-step*.msgpack")))
    for p in old[:-keep]:
        os.remove(p)
    return path


def _restore_d_state(out_dir: str, d_state: TrainState) -> bool:
    """Restore `d_state` in place from the newest ``netD-step*`` file, or
    from a legacy params-only ``netD.msgpack`` with a fresh optimizer;
    False when there is neither."""
    paths = sorted(glob.glob(os.path.join(out_dir, "netD-step*.msgpack")))
    legacy = os.path.join(out_dir, "netD.msgpack")
    if paths:
        blob = read_msgpack(paths[-1])
        params, step = blob["params"], int(blob["step"])
    elif os.path.exists(legacy):
        blob, params, step = None, read_msgpack(legacy), 0
    else:
        return False
    saved = dict(tree_leaves(params))
    with torch.no_grad():
        for path, leaf in tree_leaves(d_state.params):
            leaf.copy_(saved[path])
    d_state.optimizer.state.clear()
    if blob is not None:
        load_d_opt_state_tree(d_state, blob["opt_state"])
    d_state.step = step
    return True


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def train(cfg: TrainConfig, params: Optional[Dict] = None,
          max_steps: Optional[int] = None, resume: bool = False,
          pretrained: Optional[str] = None, load_step: Optional[int] = None,
          vgg_init: str = "torch", device="cuda") -> TrainState:
    """Run training on `device`; returns the final state.

    `pretrained` initialises the parameters from a checkpoint (``.pth``
    through the three-stage graft, or a native ``.msgpack``); `resume`
    restores the whole train state from ``cfg.out_dir``, the newest
    checkpoint or the one of `load_step`; `vgg_init` ('torch' | 'he_relu')
    is the VGG init of freshly initialised backbones."""
    dev = resolve_device(device)
    net = TransformerNet(cfg.model)
    if params is None:
        params = init_transformer_params(
            torch.Generator().manual_seed(cfg.seed), cfg.model,
            with_loss_net=True, vgg_scheme=vgg_init)
    if pretrained is not None:
        from rerevst_torch.io.torch_compat import load_pretrained

        params, stage = load_pretrained(pretrained, params)
        print(f"initialized from {pretrained} (stage: {stage})", flush=True)
    state = init_train_state(_to_device(params, dev), cfg)
    start_step = 0
    if resume:
        if load_step is not None:
            ck = checkpoint_at_step(cfg.out_dir, load_step)
            if ck is None:
                raise FileNotFoundError(
                    f"Cannot find checkpoint for step {load_step} "
                    f"in {cfg.out_dir}")
        else:
            ck = latest_checkpoint(cfg.out_dir)
        if ck is not None:
            path, start_step = ck
            p, o = restore_train_state(path, state.params)
            load_train_state(state, p, o, start_step)
            print(f"resumed from {path} @ step {start_step}", flush=True)

    d_state = None
    if cfg.loss.adversarial_loss:
        # The PatchGAN's alternating D/G update (train/train.py:275-287).
        from rerevst_torch.models.discriminator import (
            init_discriminator_params,
        )

        d_state = init_d_state(_to_device(init_discriminator_params(
            torch.Generator().manual_seed(cfg.seed + 99),
            scheme=cfg.d_init), dev))
        if resume and _restore_d_state(cfg.out_dir, d_state):
            print(f"resumed discriminator @ step {d_state.step}", flush=True)
        adv_step = make_adversarial_train_step(cfg)

        def step_fn(state, content, style, gen, extra=None):
            state, _, metrics = adv_step(state, d_state, content, style, gen,
                                         extra)
            return state, metrics
    else:
        step_fn = make_train_step(cfg)
    loader = get_loader(cfg.batch_size, cfg.load_size, cfg.fine_size,
                        cfg.flip, cfg.content_data, cfg.style_data,
                        num_workers=cfg.num_workers, seed=cfg.seed,
                        use_mpi=cfg.use_mpi, use_video=cfg.use_video)
    logger = MetricsLogger(cfg.log_dir)
    validation = None
    if os.path.isdir(os.path.join(cfg.val_dir, "content")):
        validation = Validation(cfg.val_dir, net, cfg.out_dir, dev)
        validation.save_results(state.params, 0)

    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    min_total, cur_total = np.inf, 0.0
    it = start_step
    t0 = time.time()
    done = False
    try:
        for epoch in range(1, cfg.epochs + 1):
            if done:
                break
            for batch in loader:
                content = torch.from_numpy(batch["Content"]).to(dev)
                style = torch.from_numpy(batch["Style"]).to(dev)
                extra = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()
                         if k not in ("Content", "Style")} or None
                state, metrics = step_fn(state, content, style, gen, extra)
                it += 1
                cur_total += float(metrics["total"])

                if it % cfg.scalar_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t0) / cfg.scalar_every
                    t0 = time.time()
                    print(f"[Epoch {epoch}/{cfg.epochs}][Iter {it}] "
                          f"New Style: {m['new_style']:.3f}, "
                          f"Content: {m['content']:.3f}, "
                          f"Recon: {m['recon']:.3f}, TV: {m['tv']:.3f}, "
                          f"Temporal: {m['temporal']:.3f} "
                          f"({m['temporal_gt']:.3f})  [{dt:.2f}s/it]",
                          flush=True)
                    logger.log(it, metrics)

                if it % cfg.log_every == 0:
                    cur_total /= cfg.log_every
                    if cur_total < min_total:
                        min_total = cur_total
                        save_train_state(cfg.out_dir, it, state.params,
                                         opt_state_tree(state))
                        if d_state is not None:
                            _save_d_state(cfg.out_dir, d_state)
                    cur_total = 0.0
                    if validation is not None:
                        validation.save_results(state.params, epoch)
                    # A copy of the generator: the dumps draw their own fake
                    # motion without moving the training stream.
                    diag = torch.Generator(device=dev)
                    diag.set_state(gen.get_state())
                    _dump_diagnostics(state.params, content, style, diag,
                                      cfg, epoch, extra)

                if max_steps is not None and it - start_step >= max_steps:
                    done = True
                    break
    finally:
        # A crash between log points must not lose the run: flush a
        # step-tagged checkpoint of whatever progress exists.  The flush
        # must not raise (a lost device fails it), or it would mask the
        # original exception.
        try:
            if it > start_step:
                save_train_state(cfg.out_dir, it, state.params,
                                 opt_state_tree(state))
                if d_state is not None:
                    _save_d_state(cfg.out_dir, d_state)
        except Exception as e:  # noqa: BLE001 — keeps the real diagnostic
            print(f"WARNING: crash-flush checkpoint failed: {e!r}",
                  flush=True)
        try:
            logger.close()
        except Exception:  # noqa: BLE001
            pass
    return state
