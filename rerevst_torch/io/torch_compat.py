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

Not here yet (ROADMAP.md Queue 1 item 12, training): the pretrained graft
with its three-stage fallback, and the optimizer, discriminator and
training-checkpoint interop.
"""

from __future__ import annotations

from typing import Dict, Optional

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
