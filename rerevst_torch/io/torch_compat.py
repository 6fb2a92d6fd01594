"""The reference's PyTorch ``state_dict`` layout <-> the port's parameter tree —
the inference half of ``rerevst_tpu/io/torch_compat.py``.

``from_reference_state_dict`` reads released ReReVST checkpoints
(``style_net-TIP-final.pth``) into the port's tree (HWIO conv weights,
``[in,out]`` linear weights); ``to_reference_state_dict`` writes the tree
back as a dict of tensors that ``torch.save`` takes as it is.  Both carry the
ablation trees: a decoder without ``filter{1,2,3}`` (``dynamic_filter=False``)
and the style-only predictors' ``ic -> 9 ic ic`` FC (``both_sty_con=False``).

state_dict naming (from the reference module trees):
  Encoder.slice.<i>.{weight,bias}        i in {0,2,5,7,10,12,14,16,19}
  EncoderStyle.slice<k>.<i>.*            k slices keep torchvision indices
  Vgg19.slice<k>.<i>.*                   (loss net; optional)
  Decoder.slice{4,3,2}.{conv1,conv2,conv_shortcut}.*
  Decoder.slice1.*                       final 64->3 conv
  Decoder.Filter{1,2,3}.{down_sample.0,upsample.0,F1.down_sample.0,F1.FC,F2...}

The training half: ``load_pretrained`` (a ``.pth`` through the reference's
three-stage ``LoadPretrained`` graft, or a native ``.msgpack``), the Adam
state in the reference's ``optimizer-epoch-N.pth`` layout, and the
reference's training-checkpoint files, and the PatchGAN discriminator's
``netD-epoch-N.pth`` (``NLayerDiscriminator``'s Sequential indices).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from rerevst_torch.io.convert import leaf_to_tensor
from rerevst_torch.models.layers import from_torch_conv, from_torch_linear

#: our vgg conv name -> (EncoderStyle/Vgg19 slice name, torchvision index)
_VGG_SLICED = {
    "conv1_1": ("slice1", 0),
    "conv1_2": ("slice2", 2),
    "conv2_1": ("slice2", 5),
    "conv2_2": ("slice3", 7),
    "conv3_1": ("slice3", 10),
    "conv3_2": ("slice4", 12),
    "conv3_3": ("slice4", 14),
    "conv3_4": ("slice4", 16),
    "conv4_1": ("slice4", 19),
}

_RES_MAP = {"res4": "slice4", "res3": "slice3", "res2": "slice2"}
_RES_CONVS = {"conv1": "conv1", "conv2": "conv2", "shortcut": "conv_shortcut"}


def _conv_to_torch(p) -> Dict[str, torch.Tensor]:
    out = {"weight": leaf_to_tensor(p["w"]).permute(3, 2, 0, 1).contiguous()}
    if "b" in p:
        out["bias"] = leaf_to_tensor(p["b"]).contiguous()
    return out


def _linear_to_torch(p) -> Dict[str, torch.Tensor]:
    return {"weight": leaf_to_tensor(p["w"]).T.contiguous(),
            "bias": leaf_to_tensor(p["b"]).contiguous()}


def to_reference_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's (or ``rerevst_tpu``'s) parameter tree -> the reference's
    state_dict: OIHW conv and ``[out,in]`` linear weights, each leaf a CPU
    tensor in its stored dtype."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for k, v in tensors.items():
            sd[f"{prefix}.{k}"] = v.cpu()

    if "encoder" in params:
        for name, (_, idx) in _VGG_SLICED.items():
            put(f"Encoder.slice.{idx}", _conv_to_torch(params["encoder"][name]))
    for tree_key, mod in (("encoder_style", "EncoderStyle"),
                          ("vgg_loss", "Vgg19")):
        if tree_key in params:
            for name, (slc, idx) in _VGG_SLICED.items():
                put(f"{mod}.{slc}.{idx}",
                    _conv_to_torch(params[tree_key][name]))

    dec = params.get("decoder")
    if dec is not None:
        for ours, theirs in _RES_MAP.items():
            for ck, tk in _RES_CONVS.items():
                put(f"Decoder.{theirs}.{tk}", _conv_to_torch(dec[ours][ck]))
        put("Decoder.slice1", _conv_to_torch(dec["out"]))
        for i in (1, 2, 3):
            fname = f"filter{i}"
            if fname not in dec:
                continue
            fp = dec[fname]
            put(f"Decoder.Filter{i}.down_sample.0", _conv_to_torch(fp["down"]))
            put(f"Decoder.Filter{i}.upsample.0", _conv_to_torch(fp["up"]))
            for pk, pt in (("p1", "F1"), ("p2", "F2")):
                put(f"Decoder.Filter{i}.{pt}.down_sample.0",
                    _conv_to_torch(fp[pk]["down"]))
                put(f"Decoder.Filter{i}.{pt}.FC",
                    _linear_to_torch(fp[pk]["fc"]))
    return sd


def from_reference_state_dict(state_dict: Dict,
                              dtype: Optional[torch.dtype] = torch.float32
                              ) -> Dict:
    """A reference state_dict (tensors or arrays) -> the port's parameter
    tree of CPU tensors cast to `dtype` (None keeps each stored dtype)."""
    sd = {k: leaf_to_tensor(v) for k, v in state_dict.items()}

    def conv(prefix):
        return from_torch_conv(sd[f"{prefix}.weight"],
                               sd.get(f"{prefix}.bias"), dtype)

    params: Dict = {}
    if "Encoder.slice.0.weight" in sd:
        params["encoder"] = {
            name: conv(f"Encoder.slice.{idx}")
            for name, (_, idx) in _VGG_SLICED.items()
        }
    for tree_key, mod in (("encoder_style", "EncoderStyle"),
                          ("vgg_loss", "Vgg19")):
        if f"{mod}.slice1.0.weight" in sd:
            params[tree_key] = {
                name: conv(f"{mod}.{slc}.{idx}")
                for name, (slc, idx) in _VGG_SLICED.items()
            }

    if "Decoder.slice4.conv1.weight" in sd:
        dec: Dict = {}
        for ours, theirs in _RES_MAP.items():
            dec[ours] = {
                ck: conv(f"Decoder.{theirs}.{tk}")
                for ck, tk in _RES_CONVS.items()
            }
        dec["out"] = conv("Decoder.slice1")
        for i in (1, 2, 3):
            pre = f"Decoder.Filter{i}"
            if f"{pre}.down_sample.0.weight" not in sd:
                continue
            dec[f"filter{i}"] = {
                "down": conv(f"{pre}.down_sample.0"),
                "up": conv(f"{pre}.upsample.0"),
                **{pk: {"down": conv(f"{pre}.{pt}.down_sample.0"),
                        "fc": from_torch_linear(sd[f"{pre}.{pt}.FC.weight"],
                                                sd[f"{pre}.{pt}.FC.bias"],
                                                dtype)}
                   for pk, pt in (("p1", "F1"), ("p2", "F2"))},
            }
        params["decoder"] = dec
    return params


def load_reference_checkpoint(path: str,
                              dtype: Optional[torch.dtype] = torch.float32
                              ) -> Dict:
    """Load a ReReVST ``.pth`` checkpoint as the port's parameter tree (CPU
    tensors; ``Stylization`` moves and casts them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_reference_state_dict(sd, dtype)


# --- LoadPretrained: the reference's three-stage fallback -------------------

#: The ancient schema's extra 512->512 1x1 conv, which the reference
#: tolerates by attaching a dummy module (``train/train.py:144-146``).
_LEGACY_KEYS = ("Decoder.conv_kernel.weight", "Decoder.conv_kernel.bias")


def _covers(partial: Any, template: Any) -> bool:
    """Does `partial` provide every subtree and leaf of `template`?"""
    if isinstance(template, dict):
        return isinstance(partial, dict) and all(
            k in partial and _covers(partial[k], template[k])
            for k in template)
    return (isinstance(partial, torch.Tensor)
            and tuple(partial.shape) == tuple(template.shape))


def _graft(template: Any, partial: Any, path: str = "") -> Any:
    """Overlay `partial` on `template` (template keys only, shapes must
    match); each leaf takes its template leaf's dtype and device."""
    if isinstance(template, dict):
        part = partial if isinstance(partial, dict) else {}
        return {k: _graft(v, part.get(k), f"{path}.{k}" if path else k)
                for k, v in template.items()}
    if partial is None:
        return template
    p = leaf_to_tensor(partial)
    if tuple(p.shape) != tuple(template.shape):
        raise ValueError(f"pretrained leaf {path}: shape {tuple(p.shape)} "
                         f"!= model {tuple(template.shape)}")
    return p.to(dtype=template.dtype, device=template.device)


def graft_pretrained_state_dict(state_dict: Dict, template: Dict,
                                dtype: torch.dtype = torch.float32
                                ) -> Tuple[Dict, str]:
    """The reference's three-stage ``LoadPretrained`` as a graft onto
    `template` (a freshly initialised tree): 'direct' (the checkpoint covers
    the whole tree), 'subtree' (a flags-off or half-pretrained checkpoint:
    the template keeps the rest) or 'legacy' (the ``Decoder.conv_kernel``
    schema, its extra keys dropped).  Returns ``(params, stage)``."""
    sd = dict(state_dict)
    stage = "direct"
    if any(k in sd for k in _LEGACY_KEYS):
        stage = "legacy"
        for k in _LEGACY_KEYS:
            sd.pop(k, None)
    partial = from_reference_state_dict(sd, dtype)
    if not partial:
        raise ValueError("state_dict contains no recognizable ReReVST keys")
    if stage == "direct" and not _covers(partial, template):
        stage = "subtree"
    return _graft(template, partial), stage


def load_pretrained(path: str, template: Dict,
                    dtype: torch.dtype = torch.float32) -> Tuple[Dict, str]:
    """Initialise training from a checkpoint: a reference ``.pth`` (through
    the three-stage graft) or a native ``.msgpack`` (bare params or a
    train-state blob; missing subtrees keep the template's).  Returns
    ``(params, stage)`` in the template's dtypes and devices."""
    if path.endswith(".msgpack"):
        from rerevst_torch.io.checkpoint import read_msgpack

        raw = read_msgpack(path)
        if "params" in raw and "opt_state" in raw:
            raw = raw["params"]
        stage = "direct" if _covers(raw, template) else "subtree"
        return _graft(template, raw), stage
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return graft_pretrained_state_dict(sd, template, dtype)


# --- Train-state interop ---------------------------------------------------
#
# The reference saves ``optimizer-epoch-N.pth`` (torch Adam's state_dict),
# ``style_net-epoch-N.pth`` and ``netD-epoch-N.pth`` at each best-loss log
# point (``train/train.py:446-457``).  The port's optimizer IS torch Adam, so
# the optimizer file is its state in the reference's parameter order; the
# port keeps it as the optax-layout tree of ``train.state.opt_state_tree``,
# which the JAX package reads too.

_TRAINABLE_SUBTREES = ("decoder", "encoder", "encoder_style")


def reference_trainable_param_order() -> List[str]:
    """The reference training net's trainable parameters in registration
    order (Decoder, Encoder, EncoderStyle; Vgg19 is frozen): the index
    order of ``optim.Adam(filter(requires_grad, style_net.parameters()))``
    (``train/train.py:175``)."""
    names = []
    for s in ("slice4", "slice3", "slice2"):
        names += [f"Decoder.{s}.conv1.weight", f"Decoder.{s}.conv1.bias",
                  f"Decoder.{s}.conv2.weight", f"Decoder.{s}.conv2.bias",
                  f"Decoder.{s}.conv_shortcut.weight"]
    names += ["Decoder.slice1.weight", "Decoder.slice1.bias"]
    for i in (1, 2, 3):
        p = f"Decoder.Filter{i}"
        names += [f"{p}.down_sample.0.weight", f"{p}.down_sample.0.bias",
                  f"{p}.upsample.0.weight", f"{p}.upsample.0.bias"]
        for fp in ("F1", "F2"):
            names += [f"{p}.{fp}.down_sample.0.weight",
                      f"{p}.{fp}.down_sample.0.bias",
                      f"{p}.{fp}.FC.weight", f"{p}.{fp}.FC.bias"]
    for _, idx in _VGG_SLICED.values():
        names += [f"Encoder.slice.{idx}.weight", f"Encoder.slice.{idx}.bias"]
    for slc, idx in _VGG_SLICED.values():
        names += [f"EncoderStyle.{slc}.{idx}.weight",
                  f"EncoderStyle.{slc}.{idx}.bias"]
    return names


def _adam_node(opt_state: Dict) -> Dict:
    """The ScaleByAdamState (count, mu, nu) of an optax-layout tree."""
    return opt_state["inner_states"]["train"]["inner_state"]["0"]


def adam_state_to_torch(opt_state: Dict, lr: float = 1e-4) -> Dict:
    """An optax-layout optimizer tree -> a ``torch.optim.Adam.state_dict()``
    with the parameters in the reference's trainable order."""
    adam = _adam_node(opt_state)
    step = int(adam["count"])
    order = reference_trainable_param_order()
    mom_sd = {}
    for which, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
        sub = {k: tree[k] for k in _TRAINABLE_SUBTREES if k in tree}
        if any(not v for v in sub.values()):
            raise ValueError(
                "optimizer state has frozen encoder subtrees "
                "(train_only_decoder?): the reference's Adam covers "
                "Decoder+Encoder+EncoderStyle, cannot export")
        mom_sd[which] = to_reference_state_dict(sub)
    state = {i: {"step": torch.tensor(float(step)),
                 "exp_avg": mom_sd["exp_avg"][name],
                 "exp_avg_sq": mom_sd["exp_avg_sq"][name]}
             for i, name in enumerate(order)}
    group = {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8,
             "weight_decay": 0, "amsgrad": False, "maximize": False,
             "foreach": None, "capturable": False, "differentiable": False,
             "fused": None, "params": list(range(len(order)))}
    return {"state": state, "param_groups": [group]}


def _merge(old: Any, new: Any) -> Any:
    if isinstance(old, dict):
        part = new if isinstance(new, dict) else {}
        return {k: _merge(v, part.get(k)) for k, v in old.items()}
    return old if new is None else new.to(dtype=old.dtype, device=old.device)


def adam_state_from_torch(torch_sd: Dict, opt_state_template: Dict
                          ) -> Tuple[Dict, int]:
    """Inverse of ``adam_state_to_torch``: a torch Adam state_dict's moments
    in the template optimizer tree (frozen subtrees stay empty); returns
    ``(opt_state, step)``."""
    order = reference_trainable_param_order()
    state = torch_sd["state"]

    def get(i):  # torch picklers give int or str keys
        return state[i] if i in state else state[str(i)]

    count = int(float(get(0)["step"]))
    parts = {which: from_reference_state_dict(
        {order[i]: get(i)[which] for i in range(len(order))})
        for which in ("exp_avg", "exp_avg_sq")}
    adam = _adam_node(opt_state_template)
    new_adam = {"count": torch.tensor(count, dtype=torch.int32),
                "mu": _merge(adam["mu"], parts["exp_avg"]),
                "nu": _merge(adam["nu"], parts["exp_avg_sq"])}
    return {"inner_states": {
        "freeze": {"inner_state": {}},
        "train": {"inner_state": {"0": new_adam, "1": {}}}}}, count


#: The reference ``NLayerDiscriminator``'s Sequential indices
#: (``train/other_networks.py:300-344``): our conv and BN names -> index.
_D_CONVS = (("conv0", 0), ("conv1", 2), ("conv2", 5), ("conv3", 8),
            ("conv_out", 11))
_D_BNS = (("bn1", 3), ("bn2", 6), ("bn3", 9))


def discriminator_to_torch_state(params: Dict) -> Dict[str, torch.Tensor]:
    """PatchGAN params (n_layers 3) -> the reference's ``NLayerDiscriminator``
    state_dict, CPU tensors.  BatchNorm running statistics are written as
    identity (zero mean, unit variance, 0 batches): D always normalizes
    with the batch's statistics."""
    sd: Dict[str, torch.Tensor] = {}
    for name, idx in _D_CONVS:
        for k, v in _conv_to_torch(params[name]).items():
            sd[f"model.{idx}.{k}"] = v.cpu()
    for name, idx in _D_BNS:
        scale = leaf_to_tensor(params[name]["scale"]).cpu()
        c = scale.shape[0]
        sd[f"model.{idx}.weight"] = scale
        sd[f"model.{idx}.bias"] = leaf_to_tensor(params[name]["bias"]).cpu()
        sd[f"model.{idx}.running_mean"] = torch.zeros(c)
        sd[f"model.{idx}.running_var"] = torch.ones(c)
        sd[f"model.{idx}.num_batches_tracked"] = torch.tensor(0)
    return sd


def discriminator_from_torch_state(state_dict: Dict,
                                   dtype: Optional[torch.dtype]
                                   = torch.float32) -> Dict:
    """A reference ``netD-epoch-N.pth`` state_dict -> PatchGAN params (CPU
    tensors in `dtype`; the running statistics are dropped)."""
    sd = {k: leaf_to_tensor(v) for k, v in state_dict.items()}
    params: Dict = {}
    for name, idx in _D_CONVS:
        params[name] = from_torch_conv(sd[f"model.{idx}.weight"],
                                       sd.get(f"model.{idx}.bias"), dtype)
    for name, idx in _D_BNS:
        params[name] = {"scale": sd[f"model.{idx}.weight"].to(dtype),
                        "bias": sd[f"model.{idx}.bias"].to(dtype)}
    return params


def export_train_checkpoint(out_dir: str, epoch: int, params: Dict,
                            opt_state: Optional[Dict] = None,
                            d_params: Optional[Dict] = None,
                            lr: float = 1e-4) -> Dict[str, str]:
    """Write the reference's training files so that a torch run of the
    reference resumes drop-in: ``style_net-epoch-{N}.pth`` and, with an
    optimizer tree, ``optimizer-epoch-{N}.pth``, with D's params
    ``netD-epoch-{N}.pth``.  Returns {artifact: path}."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}

    def save(name, blob):
        path = os.path.join(out_dir, name)
        torch.save(blob, path)
        out[name.split("-")[0]] = path

    save(f"style_net-epoch-{epoch}.pth", to_reference_state_dict(params))
    if opt_state is not None:
        save(f"optimizer-epoch-{epoch}.pth",
             adam_state_to_torch(opt_state, lr))
    if d_params is not None:
        save(f"netD-epoch-{epoch}.pth",
             discriminator_to_torch_state(d_params))
    return out


def import_train_checkpoint(style_pth: str, params_template: Dict,
                            opt_state_template: Dict,
                            optimizer_pth: Optional[str] = None,
                            netd_pth: Optional[str] = None,
                            dtype: torch.dtype = torch.float32):
    """The inverse: the reference's files -> (params, opt_state, step,
    d_params).  Missing pieces keep the templates' values; `step` is the
    torch Adam step (0 without an optimizer file); `d_params` is None
    without a ``netD`` file."""
    params, _ = load_pretrained(style_pth, params_template, dtype)
    opt_state, step = opt_state_template, 0
    if optimizer_pth is not None:
        sd = torch.load(optimizer_pth, map_location="cpu",
                        weights_only=False)
        opt_state, step = adam_state_from_torch(sd, opt_state_template)
    d_params = None
    if netd_pth is not None:
        d_params = discriminator_from_torch_state(
            torch.load(netd_pth, map_location="cpu", weights_only=True),
            dtype)
    return params, opt_state, step, d_params
