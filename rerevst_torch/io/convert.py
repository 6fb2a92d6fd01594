"""The weights carried across: ``rerevst_tpu`` parameter trees -> the port's.

The port keeps the JAX package's parameter tree as it is — nested dicts with
the same keys, conv weights HWIO ``[kh,kw,in,out]`` and linear weights
``[in,out]`` — with each leaf a tensor.  ``models.layers.conv2d`` makes the
OIHW view cuDNN takes at the call, so the tree needs no re-layout here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rerevst_torch.config import resolve_device


def leaf_to_tensor(a: Any) -> torch.Tensor:
    """A tensor, or an array (numpy's bf16 included) as a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. decoded straight from a file buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # numpy's bf16 (ml_dtypes) has no torch counterpart: move the raw
        # 2-byte words across and reinterpret them.
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_layout(path: str, t: torch.Tensor) -> None:
    if path.endswith("/w") and t.dim() not in (2, 4):
        raise ValueError(
            f"{path}: expected an HWIO conv weight (4-D) or an [in,out] "
            f"linear weight (2-D), got shape {tuple(t.shape)}")


def from_jax_params(tree: Dict, dtype=None, device="cuda") -> Dict:
    """Nested dict of arrays (as ``flax.serialization.msgpack_restore`` or
    ``jax.tree.map(np.asarray, params)`` give them, or CPU tensors) -> the
    same tree of tensors on `device`, floating leaves cast to `dtype` (None
    keeps each leaf's dtype)."""
    dev = resolve_device(device)

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        t = leaf_to_tensor(node)
        _check_layout(path, t)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev).contiguous()

    return walk(tree, "")
