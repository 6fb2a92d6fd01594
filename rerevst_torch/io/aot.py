"""AOT Pass-2 bundles: the global-mode Pass-2 graph as a deployment
artifact — ``rerevst_tpu/io/aot.py`` for the port.

``torch.export`` captures the session's Pass-2 function (encode, then
``decode_global`` under frozen sequence statistics) as an ATen graph in
which each hand-written kernel is one node, its ``rerevst::*`` op
(``kernels/``).  A server loads the bundle and calls it with ``(params,
frames, style, stats)``: no Python model code runs, and the graph runs the
same ops as the eager path, so on a device its frames equal the eager
path's.  No compiler is involved, so a bundle buys a fixed graph, not
speed.

Params, style and statistics stay ARGUMENTS, not baked constants: one
bundle serves any checkpoint, style or clip whose tree structure, dtypes
and padded frame geometry match the export.  The frame geometry and batch
are static; the style map's H and W are symbolic (``torch.export.Dim``),
as the JAX package exports them.

A graph is exported on the device it will run on, one per platform: the
ops' device is part of the graph.  Exporting for ``cuda`` traces on CUDA
tensors, which needs a card: PyTorch's fake CUDA tensors do not carry a
convolution on a build without CUDA.  So a bundle for the card is built
on a machine with a card.

File layout: magic | u32 JSON length | JSON meta (hw, batches, platforms,
dtype, the model switches the graph depends on, and for each entry its
batch, platform, size and input leaves) | one ``torch.export.save`` blob per
(batch, platform).  The magic is the port's own; a JAX ``RVAOT001`` bundle
is refused.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from rerevst_torch.ops.precision import exact_products

#: The port's bundle magic (the JAX package writes ``RVAOT001``).
MAGIC = b"RVTAOT01"

#: The model switches an exported graph bakes in, beside its dtype.
MODEL_KEYS = ("pairlane", "spatial_tiles", "precision", "fp32_mix",
              "mix_precision", "luma_fold", "parity_packed")

_REGISTERED = False


def _register_pytrees() -> None:
    """The conditioning NamedTuples (StyleFeatures, NormStats, SeqStats)
    must survive the serialization of an exported graph's input and output
    specs under stable names (``jax.export``'s
    ``register_namedtuple_serialization`` in the JAX package)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from rerevst_torch.models.transformer import (
        NormStats,
        SeqStats,
        StyleFeatures,
    )

    for cls in (StyleFeatures, NormStats, SeqStats):
        pytree._register_namedtuple(
            cls, serialized_type_name=f"rerevst_torch.{cls.__name__}")
    _REGISTERED = True


def _canonical(tree):
    """The tree with every dict's keys in sorted order: the flattening order
    of an exported graph's inputs, whatever order a checkpoint reader or
    Pass 1 built the dicts in."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        items = [_canonical(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class _Pass2(torch.nn.Module):
    """The session's global-mode Pass 2 as a module for ``torch.export``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, params, frames, style, stats):
        from rerevst_torch.models.transformer import stylize

        return stylize(params, frames, style, self.cfg, stats)


def _conditioning(session):
    """The session's style and statistics, or, before Pass 1, a style and
    statistics of the same structure from zero images (the norms and filters
    are per channel: their shapes do not depend on frame geometry)."""
    from rerevst_torch.models.transformer import (
        collect_stats,
        encode_content,
        encode_style,
    )

    style, stats = session.style, session.stats
    with torch.no_grad():
        if style is None:
            style = encode_style(
                session.params,
                torch.zeros((1, 64, 64, 3), device=session.device),
                session.cfg)
        if stats is None:
            feats = encode_content(
                session.params,
                torch.zeros((1, 64, 64, 3), device=session.device),
                session.cfg)
            stats = collect_stats(session.params["decoder"], feats, style,
                                  session.cfg)
    return style, stats


def check_platforms(platforms: Sequence[str]) -> None:
    """Raise unless every platform is 'cpu' or 'cuda', and 'cuda' only where
    a card is visible."""
    for platform in platforms:
        if platform not in ("cpu", "cuda"):
            raise ValueError(f"unknown platform {platform!r} (cpu or cuda)")
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "exporting for 'cuda' needs a card: torch.export traces the "
                "graph on CUDA tensors, and this PyTorch cannot trace a "
                "convolution on fake CUDA tensors without one.  Build the "
                "bundle on the machine that serves it, or pass --platforms "
                "cpu")


def _static():
    return getattr(torch.export.Dim, "STATIC", None)


def export_pass2(session, hw: Tuple[int, int], batch: int = 1,
                 platforms: Sequence[str] = ("cpu", "cuda")
                 ) -> Dict[str, torch.export.ExportedProgram]:
    """Export the session's global-mode Pass 2 at a static geometry, one
    graph per platform.

    `hw` is the PADDED frame size (e.g. 512x512 content pads to 640x640).
    Style and statistics structures come from the session, or from zero
    images before its Pass 1.  The example inputs are copied to each
    platform's device.  Raises for ``cuda`` where no card is visible."""
    check_platforms(platforms)
    _register_pytrees()
    style, stats = _conditioning(session)
    h, w = hw
    out = {}
    for platform in platforms:
        dev = torch.device(platform)
        to = (lambda t, d=dev: t.detach().to(d))
        args = _canonical((pytree.tree_map(to, session.params),
                           torch.zeros((batch, h, w, 3), dtype=torch.float32,
                                       device=dev),
                           pytree.tree_map(to, style),
                           pytree.tree_map(to, stats)))
        dims = list(pytree.tree_map(lambda t: {i: _static()
                                               for i in range(t.dim())}, args))
        dims[2] = dims[2]._replace(map={
            0: _static(), 1: torch.export.Dim("rv_style_h"),
            2: torch.export.Dim("rv_style_w"), 3: _static()})
        with torch.no_grad():
            ep = torch.export.export(_Pass2(session.cfg), args,
                                     dynamic_shapes=tuple(dims))
        # The example inputs would store the weights in the bundle.
        ep._example_inputs = None
        out[platform] = ep
    return out


def _inputs(args, dynamic_map: bool = True):
    """(tree spec, [dtype name, shape] of each leaf) of canonical inputs, in
    flattening order, with None for the style map's symbolic H and W."""
    flat, spec = pytree.tree_flatten(args)
    leaves = [[str(t.dtype).removeprefix("torch."), list(t.shape)]
              for t in flat]
    if dynamic_map:
        n_params = len(pytree.tree_leaves(args[0]))
        leaves[n_params + 1][1][1:3] = [None, None]  # style.map [N, h, w, C]
    return spec, leaves


def export_bundle(session, hw: Tuple[int, int],
                  batches: Sequence[int] = (1,),
                  platforms: Sequence[str] = ("cpu", "cuda")):
    """Export one Pass-2 graph per (batch, platform): (meta, {(batch,
    platform): ExportedProgram}), for ``write_bundle``."""
    _register_pytrees()
    style, stats = _conditioning(session)
    meta = {"hw": list(hw), "batches": list(batches),
            "platforms": list(platforms),
            "dtype": str(session.cfg.dtype).removeprefix("torch."),
            "model": {k: getattr(session.cfg, k) for k in MODEL_KEYS},
            "torch": torch.__version__, "entries": []}
    programs = {}
    for b in batches:
        frames = torch.zeros((b,) + tuple(hw) + (3,))
        spec, leaves = _inputs(_canonical((session.params, frames, style,
                                           stats)))
        for platform, ep in export_pass2(session, hw, b, platforms).items():
            meta["entries"].append({"batch": b, "platform": platform,
                                    "spec": pytree.treespec_dumps(spec),
                                    "inputs": leaves})
            programs[(b, platform)] = ep
    return meta, programs


def write_bundle(path: str, meta: dict, programs) -> dict:
    """Write the bundle file of ``export_bundle``'s result: to ``path +
    '.tmp'``, then moved into place.  Returns the meta dict (with each
    entry's size)."""
    blobs = []
    for e in meta["entries"]:
        buf = io.BytesIO()
        torch.export.save(programs[(e["batch"], e["platform"])], buf)
        blobs.append(buf.getvalue())
        e["size"] = len(blobs[-1])
    head = json.dumps(meta).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(len(head)).tobytes())
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)
    return meta


def save_bundle(path: str, session, hw: Tuple[int, int],
                batches: Sequence[int] = (1,),
                platforms: Sequence[str] = ("cpu", "cuda")) -> dict:
    """Export and write an AOT bundle: one Pass-2 graph per (batch,
    platform).  Returns the meta dict."""
    return write_bundle(path, *export_bundle(session, hw, batches,
                                             platforms))


class AotPass2:
    """A loaded bundle: callable ``(params, frames, style, stats) ->
    styled``.

    Dispatches on the frames' batch and device to the matching graph, and
    raises ``KeyError`` for a geometry, batch or device the bundle does not
    carry (the session then runs eager).  Inputs whose tree structure,
    dtypes or static shapes differ from the export raise ``ValueError``."""

    def __init__(self, meta: dict,
                 programs: Dict[Tuple[int, str],
                                torch.export.ExportedProgram]):
        self.meta = meta
        self.hw = tuple(meta["hw"])
        self._programs = programs
        self._inputs = {(int(e["batch"]), e["platform"]):
                        (pytree.treespec_loads(e["spec"]), e["inputs"])
                        for e in meta["entries"]}
        self._modules: Dict[Tuple[int, str], torch.nn.Module] = {}

    def batches(self):
        return sorted({b for b, _ in self._programs})

    def platforms(self):
        return sorted({p for _, p in self._programs})

    def program(self, batch: int, platform: str
                ) -> torch.export.ExportedProgram:
        return self._programs[(batch, platform)]

    def _check(self, key, args) -> None:
        spec, got = _inputs(args, dynamic_map=False)
        want_spec, want = self._inputs[key]
        if spec != want_spec:
            raise ValueError("bundle inputs were exported with another tree "
                             "structure (params, style or statistics)")
        for i, ((gd, gs), (wd, ws)) in enumerate(zip(got, want)):
            if gd != wd or len(gs) != len(ws) or any(
                    w is not None and g != w for g, w in zip(gs, ws)):
                raise ValueError(f"bundle input {i} was exported as {wd} "
                                 f"{ws}, got {gd} {gs}")

    def __call__(self, params, frames, style, stats):
        b, h, w, _ = frames.shape
        key = (b, frames.device.type)
        if (h, w) != self.hw or key not in self._programs:
            raise KeyError(f"bundle has {self.hw} x batches {self.batches()} "
                           f"on {self.platforms()}, got {(h, w)} batch {b} "
                           f"on {frames.device.type}")
        args = _canonical((params, frames, style, stats))
        self._check(key, args)
        if key not in self._modules:
            self._modules[key] = self._programs[key].module()
        # The graph's library products carry no precision of their own: an
        # fp32 one runs exact, as the eager path's do, only with the TF32
        # flags off while it runs.
        with exact_products():
            return self._modules[key](*args)


def load_bundle(path: str) -> AotPass2:
    """Read a bundle written by ``save_bundle``.  Raises ``ValueError`` on a
    file that is not one (a JAX ``RVAOT001`` bundle included)."""
    import rerevst_torch.kernels  # noqa: F401 — registers the rerevst:: ops

    _register_pytrees()
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not an AOT bundle of rerevst_torch "
                             f"(magic {magic!r})")
        n = int(np.frombuffer(f.read(4), np.uint32)[0])
        meta = json.loads(f.read(n).decode())
        programs = {}
        for e in meta["entries"]:
            blob = f.read(int(e["size"]))
            programs[(int(e["batch"]), e["platform"])] = torch.export.load(
                io.BytesIO(blob))
    return AotPass2(meta, programs)
