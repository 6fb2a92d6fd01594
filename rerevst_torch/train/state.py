"""Train state and optimizer — ``rerevst_tpu/train/state.py``.

``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` over the generator's
leaves, the loss network frozen: the JAX package's optax
``multi_transform({'train': adam, 'freeze': set_to_zero})``.  A frozen leaf
gets ``requires_grad=False`` and stays out of the optimizer; ``vgg_loss`` is
always frozen, and ``encoder`` and ``encoder_style`` too under
``train_only_decoder``.

Checkpoints hold the optimizer as flax writes optax's state
(``opt_state_tree``): ``inner_states/train/inner_state/0`` is the
``ScaleByAdamState`` (``count``, ``mu``, ``nu``; an empty map where a
subtree is frozen), so a checkpoint of either package resumes in the other.
torch's Adam computes the same update as optax's up to rounding:
``count``/``mu``/``nu`` are its ``step``/``exp_avg``/``exp_avg_sq``.

The discriminator's state (``init_d_state``) is a second ``TrainState``
whose Adam is optax's ``adam(1e-4, b1=0.5, b2=0.9)``; its files hold plain
``optax.adam``'s tree (``d_opt_state_tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

from rerevst_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    """Parameters (the optimizer updates them in place), the optimizer, and
    the number of steps taken."""
    params: Dict
    optimizer: torch.optim.Adam
    step: int = 0


def param_labels(params: Dict, train_only_decoder: bool = False) -> Dict:
    """'train' / 'freeze' per top-level subtree."""
    frozen = {"vgg_loss"}
    if train_only_decoder:
        frozen |= {"encoder", "encoder_style"}
    return {k: ("freeze" if k in frozen else "train") for k in params}


def tree_leaves(tree: Dict, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict, depth first in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def make_optimizer(cfg: TrainConfig, params: Dict) -> torch.optim.Adam:
    """Adam over the leaves labelled 'train'; every leaf's ``requires_grad``
    is set from its label."""
    labels = param_labels(params, cfg.train_only_decoder)
    train: List[torch.Tensor] = []
    for k, sub in params.items():
        for _, leaf in tree_leaves(sub):
            leaf.requires_grad_(labels[k] == "train")
            if labels[k] == "train":
                train.append(leaf)
    return torch.optim.Adam(train, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(params: Dict, cfg: TrainConfig) -> TrainState:
    return TrainState(params, make_optimizer(cfg, params), 0)


def trainable_leaves(state: TrainState) -> List[torch.Tensor]:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def _trained_subtrees(state: TrainState) -> Dict[str, bool]:
    ids = {id(p) for p in trainable_leaves(state)}
    return {k: any(id(t) in ids for _, t in tree_leaves(sub))
            for k, sub in state.params.items()}


def _adam_moments(opt: torch.optim.Adam, tree: Dict
                  ) -> Tuple[int, Dict, Dict]:
    """(count, mu, nu) of the leaves of `tree` as optax's
    ``ScaleByAdamState`` holds them: zeros for a leaf not yet stepped."""
    count = 0
    mu: Dict = {}
    nu: Dict = {}
    for path, leaf in tree_leaves(tree):
        st = opt.state.get(leaf, {})
        if "step" in st:
            count = int(st["step"])
        for out, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = st[name].detach() if name in st \
                else torch.zeros_like(leaf, requires_grad=False)
    return count, mu, nu


def _load_adam_moments(opt: torch.optim.Adam, tree: Dict, count: int,
                       mu: Dict, nu: Dict) -> None:
    """Set the Adam state of the leaves of `tree` from optax's moments."""
    for path, leaf in tree_leaves(tree):
        m, v = mu, nu
        for key in path:
            m, v = m[key], v[key]
        if count == 0:
            opt.state.pop(leaf, None)
            continue
        opt.state[leaf] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(device=leaf.device, dtype=leaf.dtype).clone(),
            "exp_avg_sq": v.to(device=leaf.device, dtype=leaf.dtype)
            .clone()}


def _adam_node(count: int, mu: Dict, nu: Dict) -> Dict:
    return {"count": torch.tensor(count, dtype=torch.int32), "mu": mu,
            "nu": nu}


def opt_state_tree(state: TrainState) -> Dict:
    """The optimizer as flax writes optax's ``multi_transform`` Adam state:
    count (int32), mu and nu trees (zeros before the first step; an empty
    map for a frozen subtree)."""
    count = 0
    mu: Dict = {}
    nu: Dict = {}
    for k, trained in _trained_subtrees(state).items():
        if not trained:
            mu[k], nu[k] = {}, {}
            continue
        c, mu[k], nu[k] = _adam_moments(state.optimizer, state.params[k])
        count = max(count, c)
    return {"inner_states": {
        "freeze": {"inner_state": {}},
        "train": {"inner_state": {"0": _adam_node(count, mu, nu),
                                  "1": {}}}}}


def load_opt_state_tree(state: TrainState, tree: Dict) -> None:
    """Set the optimizer's moments and step from an ``opt_state_tree``
    layout (the JAX package's or the port's checkpoint)."""
    adam = tree["inner_states"]["train"]["inner_state"]["0"]
    for k, trained in _trained_subtrees(state).items():
        saved = bool(adam["mu"].get(k))
        if trained != saved:
            raise ValueError(
                f"optimizer state: subtree {k!r} is "
                f"{'trained' if trained else 'frozen'} here but "
                f"{'trained' if saved else 'frozen'} in the checkpoint "
                f"(train_only_decoder differs?)")
        if trained:
            _load_adam_moments(state.optimizer, state.params[k],
                               int(adam["count"]), adam["mu"][k],
                               adam["nu"][k])


# ---------------------------------------------------------------------------
# The discriminator
# ---------------------------------------------------------------------------

#: D's Adam: optax ``adam(1e-4, b1=0.5, b2=0.9)`` (``train/train.py:287``).
D_LR, D_BETAS, D_EPS = 1e-4, (0.5, 0.9), 1e-8


def init_d_state(d_params: Dict) -> TrainState:
    """The discriminator's state: every leaf trained by its own Adam."""
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves(d_params)]
    return TrainState(d_params, torch.optim.Adam(
        leaves, lr=D_LR, betas=D_BETAS, eps=D_EPS), 0)


def d_opt_state_tree(d_state: TrainState) -> Dict:
    """D's optimizer as flax writes plain ``optax.adam``'s state,
    ``(ScaleByAdamState(count, mu, nu), EmptyState())``."""
    return {"0": _adam_node(*_adam_moments(d_state.optimizer,
                                           d_state.params)), "1": {}}


def load_d_opt_state_tree(d_state: TrainState, tree: Dict) -> None:
    adam = tree["0"]
    _load_adam_moments(d_state.optimizer, d_state.params, int(adam["count"]),
                       adam["mu"], adam["nu"])


def load_train_state(state: TrainState, params: Dict, opt_tree: Dict,
                     step: int) -> None:
    """Restore `state` in place from a checkpoint's params (same tree) and
    optimizer tree: the leaves keep their identity, so the optimizer keeps
    holding them."""
    saved = dict(tree_leaves(params))
    with torch.no_grad():
        for k, sub in state.params.items():
            for path, leaf in tree_leaves(sub):
                leaf.copy_(saved[(k,) + path])
    load_opt_state_tree(state, opt_tree)
    state.step = step
