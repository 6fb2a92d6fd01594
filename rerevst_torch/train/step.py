"""One training step — ``rerevst_tpu/train/step.py`` (the reference's G
update, ``train/train.py:353-415``).

The forward computes every loss, the 16-step relaxed style optimization
included; one backward pass gives the gradients of the trainable leaves, and
``torch.optim.Adam`` updates them in place.  The step reads nothing back
from the card: its metrics come back as device tensors.

Training runs the per-frame graph (``transformer.decode``) and the VGG
networks under autograd at the levels the model config names, as the JAX
package does: at 'high' and 'default' the fp32 3x3 SAME convs run the
``conv3x3_implicit_gemm`` kernel forward and backward
(``kernels.conv3x3.Conv3x3Fn``: the input gradient on the same kernel, the
weight gradient on ``conv3x3_wgrad``), every other product the library's,
exact (``exact_products``, held around forward and backward: the hand-
written kernels read no TF32 flag).  The relaxed loss's VGG runs exact at
every level, as JAX's pins it to HIGHEST.  The step never runs
``decode_global``, and neither the per-frame ``decode`` nor the VGG
encoders take the pair-lane route, so the normalization, filter and
pair-lane kernels stay off the train path in both packages: a
``ModelConfig(pairlane=True)`` step is the ``pairlane=False`` step.

``extra`` carries what the loader gives beside ``Content`` and ``Style``:
the Figure-16 ablation pairs (``NextContent`` with ``BackwardFlow`` and
``BackwardMask`` from MPI Sintel, or with ``ForwardFlow`` and
``ForwardMask`` from video), which replace the synthetic motion, or an
injected fake pair (``Second``, ``FakeFlow``).

``make_adversarial_train_step`` is the PatchGAN step: one generator
forward, D's Adam update on the detached output, then G's update through
the updated D.  ``make_sharded_train_step`` is the data-parallel step over
a mesh (``parallel/mesh.py``): each shard computes the gradients of its
part of the batch, the gradients and metrics are averaged over every shard
(``pmean``), and each replica of the parameters takes its own Adam step on
the averaged gradients, as DDP does, so the replicas stay identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rerevst_torch.config import TrainConfig
from rerevst_torch.losses.gan import gan_loss
from rerevst_torch.losses.perceptual import content_loss, style_loss, tv_loss
from rerevst_torch.losses.relaxed import relaxed_style_loss
from rerevst_torch.losses.temporal import (
    generate_fake_data,
    temporal_loss,
    temporal_loss_mpi,
    temporal_loss_video,
)
from rerevst_torch.models import vgg
from rerevst_torch.models.discriminator import discriminator
from rerevst_torch.models.transformer import decode, encode_style
from rerevst_torch.ops.image import rgb_to_luma_reversed
from rerevst_torch.ops.precision import exact_products_fn, precision_for
from rerevst_torch.parallel.collectives import run_sharded, shard_batch, \
    tree_to
from rerevst_torch.parallel.mesh import lift_local
from rerevst_torch.train.state import (
    TrainState,
    init_train_state,
    trainable_leaves,
)

#: The profiler range around the discriminator's part of an adversarial
#: step: D's forward, backward and Adam update, and G's GAN term through
#: the updated D (forward and backward to the styled frame).
D_RANGE = "adversarial_step.discriminator"

#: The ablation pairs' ``extra`` keys: (flow, mask, loss) for MPI Sintel's
#: backward flow and for video's forward flow.
_ABLATIONS = (("BackwardFlow", "BackwardMask", temporal_loss_mpi),
              ("ForwardFlow", "ForwardMask", temporal_loss_video))


@exact_products_fn
def compute_losses(params: Dict, content: torch.Tensor, style: torch.Tensor,
                   gen: Optional[torch.Generator], cfg: TrainConfig,
                   extra: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
    """(total weighted loss, (metrics, aux)).

    Keeps the reference's asymmetries: the encoder sees the COLOR content
    while the content loss's target is VGG of the GRAY content; recon
    encodes the gray style; the temporal pass runs the color fake second
    frame through the per-frame graph.  ``extra={'Second', 'FakeFlow'}``
    injects the fake pair in place of drawing it from `gen`; an ablation
    pair in `extra` (see the module's docstring) replaces the fake pair."""
    mcfg, lcfg = cfg.model, cfg.loss
    prec = precision_for(mcfg.dtype, mcfg.precision)
    ablation = None if extra is None else next(
        (a for a in _ABLATIONS if a[0] in extra), None)
    metrics: Dict = {}
    aux: Dict = {}
    zero = content.new_zeros((), dtype=torch.float32)

    def decode_(pd, f, s):
        if cfg.remat:
            # Recompute the decode in the backward pass: each of the
            # step's decodes keeps only its inputs.
            return checkpoint(decode, pd, f, s, mcfg, use_reentrant=False)
        return decode(pd, f, s, mcfg)

    gray_content = rgb_to_luma_reversed(content)
    f_content = vgg.encode(params["encoder"], content, precision=prec)
    sf = encode_style(params, style, mcfg)
    styled = decode_(params["decoder"], f_content, sf)
    aux["styled"] = styled

    total = zero
    if lcfg.style_content_loss:
        f_styled = vgg.vgg_features(params["vgg_loss"], styled, "relu4_1",
                                    precision=prec)
        f_content_gt = vgg.vgg_features(params["vgg_loss"], gray_content,
                                        "relu4_1", precision=prec)
        c_loss = content_loss(f_styled, f_content_gt)
        if lcfg.relax_style:
            s_loss, ori_loss, robust_style = relaxed_style_loss(
                params["vgg_loss"], style, f_styled, lcfg, mcfg)
            aux["relaxed_style"] = robust_style
        else:
            f_style_gt = vgg.vgg_features(params["vgg_loss"], style,
                                          "relu4_1", precision=prec)
            s_loss = style_loss(f_styled, f_style_gt, mcfg.mean_std_eps)
            ori_loss = zero
        total = total + c_loss * lcfg.content_weight \
            + s_loss * lcfg.style_weight
        if lcfg.old_style_loss:
            total = total + ori_loss * lcfg.old_weight
        metrics.update(content=c_loss, new_style=s_loss, old_style=ori_loss)
    else:
        metrics.update(content=zero, new_style=zero, old_style=zero)

    if lcfg.recon_loss:
        recon_content = decode_(params["decoder"], f_content,
                                encode_style(params, content, mcfg))
        gray_style_feat = vgg.encode(params["encoder"],
                                     rgb_to_luma_reversed(style),
                                     precision=prec)
        recon_style = decode_(params["decoder"], gray_style_feat, sf)
        r_loss = (torch.mean(torch.abs(recon_content - content))
                  + torch.mean(torch.abs(recon_style - style)))
        total = total + r_loss * lcfg.recon_weight
        metrics["recon"] = r_loss
        aux["recon_content"] = recon_content
        aux["recon_style"] = recon_style
    else:
        metrics["recon"] = zero

    if lcfg.temporal_loss and ablation is not None:
        # Figure-16 ablation: real pairs and their flow (loss M18).
        flow_key, mask_key, loss_fn = ablation
        nxt, flow, mask = extra["NextContent"], extra[flow_key], \
            extra[mask_key]
        if mask.dim() == 3:
            mask = mask[..., None]
        styled_next = decode_(params["decoder"],
                              vgg.encode(params["encoder"], nxt,
                                         precision=prec), sf)
        t_loss, fake = loss_fn(styled_next, styled, flow, mask)
        t_gt, _ = loss_fn(nxt, content, flow, mask)
        total = total + t_loss * lcfg.temporal_weight
        metrics["temporal"] = t_loss
        metrics["temporal_gt"] = t_gt.detach()
        aux["styled_second"] = styled_next
        aux["fake_styled_second"] = fake
    elif lcfg.temporal_loss:
        if extra is not None and "Second" in extra:
            second, flow = extra["Second"], extra["FakeFlow"]
        else:
            second, flow = generate_fake_data(gen, content, lcfg)
        second = second.detach()
        f_second = vgg.encode(params["encoder"], second, precision=prec)
        styled_second = decode_(params["decoder"], f_second, sf)
        t_loss, warped = temporal_loss(styled, styled_second, flow,
                                       use_warp=lcfg.data_w)
        t_gt, _ = temporal_loss(content, second, flow, use_warp=lcfg.data_w)
        total = total + t_loss * lcfg.temporal_weight
        metrics["temporal"] = t_loss
        metrics["temporal_gt"] = t_gt.detach()
        aux["second"] = second
        aux["styled_second"] = styled_second
        aux["fake_styled_second"] = warped
    else:
        metrics["temporal"] = zero
        metrics["temporal_gt"] = zero

    if lcfg.tv_loss:
        t = tv_loss(styled)
        total = total + t * lcfg.tv_weight
        metrics["tv"] = t
    else:
        metrics["tv"] = zero

    metrics["total"] = total
    return total, (metrics, aux)


@exact_products_fn
def _grads(total: torch.Tensor, leaves: List[torch.Tensor]):
    # A leaf the losses do not reach gets a zero gradient, as under JAX,
    # so Adam still decays its moments.
    return torch.autograd.grad(total, leaves, allow_unused=True,
                               materialize_grads=True)


def _accum_loss_grads(params: Dict, leaves: List[torch.Tensor],
                      cfg: TrainConfig, accum: int, content: torch.Tensor,
                      style: torch.Tensor, gen: Optional[torch.Generator],
                      extra: Optional[Dict] = None):
    """The mean gradient over `accum` micro-batches: one optimizer update's
    gradient at about 1/accum of the activation memory.  Sums in fp32 and
    casts back to each leaf's dtype; each micro-batch draws its fake motion
    from a generator of its own, seeded from `gen`."""
    b = content.shape[0]
    if b % accum:
        raise ValueError(
            f"grad_accum {accum} must divide the batch; got batch {b}")
    m = b // accum
    seeds = ([None] * accum if gen is None else torch.randint(
        0, 2 ** 62, (accum,), generator=gen, device=gen.device).tolist())
    g_sum = None
    per_micro: List[Dict] = []
    for i in range(accum):
        sl = slice(i * m, (i + 1) * m)
        ex = None if extra is None else {k: v[sl] for k, v in extra.items()}
        g_i = None if seeds[i] is None else \
            torch.Generator(device=gen.device).manual_seed(seeds[i])
        total, (metrics, _) = compute_losses(params, content[sl], style[sl],
                                             g_i, cfg, ex)
        grads = _grads(total, leaves)
        g32 = [g.to(torch.float32) for g in grads]
        g_sum = g32 if g_sum is None else [a + g for a, g in zip(g_sum, g32)]
        per_micro.append({k: v.detach() for k, v in metrics.items()})
    grads = [(g / accum).to(p.dtype) for g, p in zip(g_sum, leaves)]
    metrics = {k: torch.stack([mm[k] for mm in per_micro]).mean(0)
               for k in per_micro[0]}
    return grads, metrics


def make_train_step(cfg: TrainConfig):
    """(state, content, style, gen, extra=None) -> (state, metrics): one
    Adam update of `state` in place, metrics as device tensors.  `gen` is a
    ``torch.Generator`` on the batch's device (the fake motion's draws)."""
    accum = max(int(cfg.grad_accum), 1)

    def train_step(state: TrainState, content: torch.Tensor,
                   style: torch.Tensor, gen: Optional[torch.Generator],
                   extra: Optional[Dict] = None):
        leaves = trainable_leaves(state)
        if accum > 1:
            grads, metrics = _accum_loss_grads(state.params, leaves, cfg,
                                               accum, content, style, gen,
                                               extra)
        else:
            total, (metrics, _) = compute_losses(state.params, content,
                                                 style, gen, cfg, extra)
            grads = _grads(total, leaves)
            metrics = {k: v.detach() for k, v in metrics.items()}
        for p, g in zip(leaves, grads):
            p.grad = g
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def shard_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of the shard with global index `index` for one sharded
    step: seeded from the step's seed and the index (JAX: ``fold_in(key,
    axis_index)``), so each shard draws its own fake motion, as
    independent loader workers would."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index + 1) % (1 << 63))


def make_sharded_train_step(cfg: TrainConfig, mesh):
    """(state, content, style, gen, extra=None) -> (state, metrics): one
    data-parallel step over `mesh`, `state` updated in place.

    The batch splits over the shards; each shard computes its losses and
    gradients (``grad_accum`` micro-batches its own part), drawing from
    ``shard_generator(seed, shard)`` with `seed` drawn once from `gen`.
    Gradients and metrics are averaged over every shard (within the process
    in shard order, then across processes).  A shard on the state's device
    uses the state itself; a shard on another device a replica (a copy of
    the parameters and the optimizer, made once); one shard per device
    steps that device's Adam on the averaged gradients.  A batch that the
    shards do not divide raises: padding a training batch would bias the
    averaged gradients.  In a multi-process mesh `content` and `style` are
    this process's LOCAL batches."""
    accum = max(int(cfg.grad_accum), 1)
    n_shards = mesh.size
    multihost = mesh.process_count > 1
    n_local = len(mesh.devices) if multihost else n_shards
    devs = mesh.devices

    def make_replica(state: TrainState, dev: torch.device) -> TrainState:
        rep = init_train_state(tree_to(_detached(state.params), dev), cfg)
        rep.optimizer.load_state_dict(state.optimizer.state_dict())
        rep.step = state.step
        return rep

    def replica(state: TrainState, dev: torch.device) -> TrainState:
        # A replica steps with the state; one that fell behind (the state
        # stepped elsewhere) is made anew.
        if dev == _device_of(state):
            return state
        return mesh.replica(state, dev, make=make_replica,
                            fresh=lambda rep: rep.step == state.step)

    def local(comm, st: TrainState, content, style, seed, extra, stepper):
        gen = None if seed is None else shard_generator(
            seed, comm.global_index, comm.device)
        leaves = trainable_leaves(st)
        if accum > 1:
            grads, metrics = _accum_loss_grads(st.params, leaves, cfg, accum,
                                               content, style, gen, extra)
        else:
            total, (metrics, _) = compute_losses(st.params, content, style,
                                                 gen, cfg, extra)
            grads = _grads(total, leaves)
            metrics = {k: v.detach() for k, v in metrics.items()}
        keys = sorted(metrics)
        avg = comm.pmean(list(grads) + [metrics[k] for k in keys])
        if stepper:
            for p, g in zip(leaves, avg[:len(leaves)]):
                p.grad = g
            st.optimizer.step()
            st.step += 1
        return dict(zip(keys, avg[len(leaves):]))

    def step(state: TrainState, content: torch.Tensor, style: torch.Tensor,
             gen: Optional[torch.Generator], extra: Optional[Dict] = None):
        if content.shape[0] % n_local or style.shape[0] % n_local:
            scope = (f"this process's {n_local} mesh devices" if multihost
                     else f"the mesh ({n_shards} devices)")
            raise ValueError(
                f"sharded train step needs batch divisible by {scope}; got "
                f"content batch {content.shape[0]}, style batch "
                f"{style.shape[0]}. Pick batch_size = k * {n_local}.")
        if multihost:
            content = lift_local(mesh, content, what="content batch")
            style = lift_local(mesh, style, what="style batch")
        seed = None if gen is None else int(torch.randint(
            0, 1 << 62, (1,), generator=gen, device=gen.device))
        states = [replica(state, d) for d in devs]
        first = {}  # the shard that steps each device's optimizer
        for i, d in enumerate(devs):
            first.setdefault(str(d), i)
        steppers = [first[str(d)] == i for i, d in enumerate(devs)]
        extras = ([None] * len(devs) if extra is None else
                  [dict(zip(extra, vs)) for vs in zip(
                      *(shard_batch(v, mesh) for v in extra.values()))])
        metrics = run_sharded(local, mesh, states, shard_batch(content, mesh),
                              shard_batch(style, mesh), [seed] * len(devs),
                              extras, steppers)
        return state, tree_to(metrics[0], _device_of(state))

    return step


def _device_of(state: TrainState) -> torch.device:
    return trainable_leaves(state)[0].device


@exact_products_fn
def discriminator_step(d_state: TrainState, fake: torch.Tensor,
                       real: torch.Tensor, mode: str) -> torch.Tensor:
    """D's Adam step on 0.5 (gan(D(fake), fake) + gan(D(real), real)), in
    place; returns that loss."""
    leaves = trainable_leaves(d_state)
    d_loss = 0.5 * (gan_loss(discriminator(d_state.params, fake), False, mode)
                    + gan_loss(discriminator(d_state.params, real), True,
                               mode))
    for p, g in zip(leaves, _grads(d_loss, leaves)):
        p.grad = g
    d_state.optimizer.step()
    d_state.step += 1
    return d_loss


@exact_products_fn
def gan_cotangent(d_params: Dict, styled: torch.Tensor, mode: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """G's GAN loss gan(D(styled), real) with D held fixed, and its
    gradient at `styled`."""
    x = styled.detach().requires_grad_(True)
    g_gan = gan_loss(discriminator(_detached(d_params), x), True, mode)
    (cot,) = torch.autograd.grad(g_gan, x)
    return g_gan, cot


def make_adversarial_train_step(cfg: TrainConfig):
    """(g_state, d_state, content, style, gen, extra=None) -> (g_state,
    d_state, metrics): the D-then-G update of ``train/train.py:320-415``,
    both states updated in place.

    The generator runs ONCE, as in the reference: D takes one Adam step on
    0.5 (gan(D(styled.detach()), fake) + gan(D(style), real)) (the style
    image is D's real input, the reference's choice); then G's gradient is
    that of total + gan_weight gan(D'(styled), real) through the UPDATED,
    frozen D' -- its cotangent at `styled` joins the losses' in one
    backward over the generator.  The metrics add ``loss_d`` and
    ``loss_G_GAN``; ``total`` stays the losses' total without the GAN
    term.  The objective is ``cfg.loss.gan_mode``."""
    mode, weight = cfg.loss.gan_mode, cfg.loss.gan_weight
    if cfg.grad_accum > 1:
        # The D and G updates share the one forward's `styled`: there is
        # no micro-batched form of it.
        raise ValueError("grad_accum > 1 is not supported with "
                         "adversarial_loss; drop one of the two")

    @exact_products_fn
    def train_step(g_state: TrainState, d_state: TrainState,
                   content: torch.Tensor, style: torch.Tensor,
                   gen: Optional[torch.Generator],
                   extra: Optional[Dict] = None):
        total, (metrics, aux) = compute_losses(g_state.params, content,
                                               style, gen, cfg, extra)
        styled = aux["styled"]
        with torch.profiler.record_function(D_RANGE):
            d_loss = discriminator_step(d_state, styled.detach(), style,
                                        mode)
            g_gan, cot = gan_cotangent(d_state.params, styled, mode)
        g_leaves = trainable_leaves(g_state)
        grads = torch.autograd.grad(
            [total, styled], g_leaves,
            grad_outputs=[torch.ones_like(total), cot * weight],
            allow_unused=True, materialize_grads=True)
        for p, g in zip(g_leaves, grads):
            p.grad = g
        g_state.optimizer.step()
        g_state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss_G_GAN"] = g_gan.detach()
        metrics["loss_d"] = d_loss.detach()
        return g_state, d_state, metrics

    return train_step


def _detached(tree: Dict) -> Dict:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()
