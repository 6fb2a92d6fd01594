"""Training traffic: back-to-back optimizer steps of ``make_train_step`` over
seeded batches.

Set-up builds one train state (the configuration's checkpoint gives the
VGG encoders and the loss VGG, the decoder is drawn from the seed on the
device), a pool of ``pool`` distinct batches of ``batch`` content and style
images at ``size`` x ``size`` made from the seed, and the generator of the
synthetic motion.  It then drives that state through ``check_steps`` steps
of the window's own call on the pool's first batches, reading each step's
loss, the first gradient (from Adam's first moment after step 1) and, after
the last, each leaf's change; those steps warm up every shape.  The window
continues on the next batches, cycling through the pool, until
``--seconds`` have passed; it closes once the card has finished.  After the
window the plain reference (``benchmark/reference/train.py``) takes the
same start, batches and generator state through the same steps at exact
fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import data, faults, weights
from benchmark.lib.check import judge
from benchmark.reference import model as refmodel
from benchmark.reference import train as reference

#: Below this share of the median leaf's reference gradient norm a leaf
#: is nought to rounding (a bias under a norm): its change is left out.
ROUNDING_LEAF = 1e-3
#: The relaxed loop's iterations whose losses are compared one by one
#: (the first ones: later iterates of two sound loops drift apart, PERF.md
#: section 2).
INNER_COMPARED = 2
#: Faults ``calibrate`` plants in the relaxed loop, as the loss
#: configuration's fields they change.
LOOP_FAULTS = {"loop_skipped": {"flow_iter": 0},
               "flow_iter_8": {"flow_iter": 8},
               "flow_iter_4": {"flow_iter": 4},
               "inner_bf16": {"relaxed_inner_dtype": "bf16"}}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rel(values: Dict[str, float], ref: Dict[str, float], med: float
         ) -> List[float]:
    """Each leaf's gap against the larger of its reference value and the
    median leaf's, sorted."""
    return sorted(abs(values[k] - v) / max(v, med) for k, v in ref.items())


def inner_gaps(prog: List[List[float]], ref: List[List[float]]
               ) -> List[float]:
    """The worst step's relative gap of the relaxed loop's loss at each
    iteration; inf throughout where a step's loop ran another number of
    iterations than the reference's (or the program reported none)."""
    n = max(len(r) for r in ref)
    if len(prog) != len(ref) or any(len(p) != len(r)
                                    for p, r in zip(prog, ref)):
        return [float("inf")] * n
    return [max(abs(p[i] - r[i]) / abs(r[i]) for p, r in zip(prog, ref))
            for i in range(n)]


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training cell's numbers from two sides' {losses, grad, change,
    relaxed}: the worst step's relative loss gap; the worst leaf's gap of
    first-gradient norms and of change norms after the check's steps
    (leaves whose reference gradient is nought to rounding left out of the
    change), each against the larger of that leaf's reference norm and
    the median leaf's; and the stage the reference takes from the program,
    the relaxed loop, twice: the worst relative gap of its iterations'
    losses against the reference's own loop over the first
    ``INNER_COMPARED`` iterations (inf where the iteration counts differ),
    and the worst step's gap between the relaxed loss of the program's
    chosen iterate and of the reference's own."""
    gr = ref["grad"]
    by_iter = inner_gaps(prog["inner"], ref["inner"])
    med_g = statistics.median(gr.values())
    moved = {k: ref["change"][k] for k, v in gr.items()
             if v >= ROUNDING_LEAF * med_g}
    return {
        "loss_rel_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": _rel(prog["grad"], gr, med_g)[-1],
        "change_norm_gap": _rel(prog["change"], moved,
                                statistics.median(moved.values()))[-1],
        "relaxed_loop_rel_gap": max(abs(p - r) / abs(r) for p, r in
                                    ref["relaxed"]),
        "inner_loss_rel_gap": max(by_iter[:INNER_COMPARED]),
        "inner_gap_by_iter": by_iter}


def train_config(spec: Dict):
    from rerevst_torch.config import ModelConfig, TrainConfig

    model = dict(spec["model"])
    model["dtype"] = {"float32": torch.float32}[model.get("dtype",
                                                          "float32")]
    return TrainConfig(batch_size=spec["batch"], fine_size=spec["size"],
                       lr=spec["lr"], model=ModelConfig(**model))


class Cell:
    #: Faults ``calibrate`` can plant in the program's steps.
    FAULTS = ("half_batch", *LOOP_FAULTS, "loop_tf32")

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.tr = ctx.traffic
        self.device = torch.device(ctx.device)
        self.counters: Dict = {}

    # -- set-up ----------------------------------------------------------

    def load(self, seed: int) -> None:
        ck = weights.as_float32(
            weights.read(str(self.ctx.root / self.cfg["weights"])))
        self.ck = ck
        self.make_inputs(seed)

    def make_inputs(self, seed: int) -> None:
        """The start parameters (on the device), the batch pool and the
        generator's seed, all from `seed`."""
        t, dev = self.tr, self.device
        self.seed = seed
        gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
        dec = self.ck["decoder"]
        flat = [(k, v) for k, v in reference.leaves({"decoder": dec},
                                                     ("decoder",))]
        n_w = sum(v.numel() for k, v in flat if k.endswith("/w"))
        draws = torch.randn(n_w, generator=gen, device=dev) * 0.02
        start, fresh = 0, {}
        for k, v in flat:
            if k.endswith("/w"):
                fresh[k] = draws[start:start + v.numel()].reshape(v.shape)
                start += v.numel()
            else:
                fresh[k] = torch.zeros(v.shape, device=dev)

        def rebuild(node, path):
            return {k: rebuild(v, f"{path}/{k}") if isinstance(v, dict)
                    else fresh[f"{path}/{k}"] for k, v in node.items()}

        on_dev = lambda x: x.to(dev)  # noqa: E731
        self.start = {"encoder": tree_map(on_dev, self.ck["encoder"]),
                      "encoder_style": tree_map(on_dev,
                                                self.ck["encoder_style"]),
                      "decoder": rebuild(dec, "decoder"),
                      "vgg_loss": tree_map(on_dev, self.ck["encoder"])}
        b, s, n = t["batch"], t["size"], t["pool"]
        content = np.concatenate([data.clip(seed, 100 + k, b, s, s, dev)
                                  for k in range(n)])
        styles = np.stack([data.style(seed * 1000 + j, s, s, dev)
                           for j in range(n * b)])
        as_model = lambda a: torch.from_numpy(  # noqa: E731
            refmodel.bgr_to_model(a).copy()).to(dev).reshape(n, b, s, s, 3)
        self.content, self.style = as_model(content), as_model(styles)
        self.gen_seed = (seed * 7919 + 17) % (1 << 63)

    def program(self, spec_model: Dict):
        """A fresh train state from the start parameters, its step and
        generator."""
        from rerevst_torch.train.state import init_train_state
        from rerevst_torch.train.step import make_train_step

        cfg = train_config(dict(self.tr, lr=self.cfg["lr"],
                                model=spec_model))
        params = tree_map(lambda x: x.detach().clone(), self.start)
        state = init_train_state(params, cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        return state, make_train_step(cfg), gen

    def first_steps(self, state, step, gen, fault: Optional[str] = None
                    ) -> Dict:
        """The check's steps through the window's call: each step's loss,
        the first gradient's norm by leaf (as Adam got it), each leaf's
        change norm, and each step's style batch as the relaxed loop left
        it, with the losses of the loop's iterations (the loop's own
        ``record``)."""
        from rerevst_torch.train.state import trainable_leaves

        import rerevst_torch.train.step as train_step

        paths = [p for p, _ in reference.leaves(self.start)]
        before = [p.detach().clone() for p in trainable_leaves(state)]
        losses, robust, inner = [], [], []
        relaxed = train_step.relaxed_style_loss

        def observed(vp, st, fs, lc, mc, **kwargs):
            # The style batch as the relaxed loop left it: the reference
            # takes the loop's choice from here (PERF.md section 2), and
            # holds the loop's iterations to its own.
            if fault in LOOP_FAULTS:
                lc = dataclasses.replace(lc, **LOOP_FAULTS[fault])
            rec: Dict = {}
            with (faults.library_tf32() if fault == "loop_tf32"
                  else contextlib.nullcontext()):
                out = relaxed(vp, st, fs, lc, mc, record=rec, **kwargs)
            robust.append(out[2].detach().clone())
            inner.append([float(v) for v in rec.get("inner_losses", [])])
            return out

        train_step.relaxed_style_loss = observed
        try:
            for i in range(self.tr["check_steps"]):
                c, s = self.content[i], self.style[i]
                if fault == "half_batch":
                    c, s = c[:c.shape[0] // 2], s[:s.shape[0] // 2]
                state, m = step(state, c, s, gen)
                losses.append(float(m["total"]))
                if i == 0:
                    # Adam's first moment after one step is 0.1 g; a leaf
                    # the optimizer never moved has none and reads 0.
                    moments = state.optimizer.state
                    grad = {p: float(moments[t]["exp_avg"].norm() / 0.1)
                            if "exp_avg" in moments.get(t, {}) else 0.0
                            for p, t in zip(paths, trainable_leaves(state))}
        finally:
            train_step.relaxed_style_loss = relaxed
        change = {p: float((t.detach() - b).norm()) for p, t, b in
                  zip(paths, trainable_leaves(state), before)}
        return {"losses": losses, "grad": grad, "change": change,
                "robust": robust, "inner": inner}

    def setup(self, seed: int) -> None:
        self.load(seed)
        self.state, self.step, self.gen = self.program(self.cfg["model"])
        self.prog = self.first_steps(self.state, self.step, self.gen)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        pool = self.content.shape[0]
        totals = []
        i = self.tr["check_steps"]
        steps = 0
        t0 = time.perf_counter()
        while True:
            k = i % pool
            self.state, m = self.step(self.state, self.content[k],
                                      self.style[k], self.gen)
            totals.append(m["total"])
            i += 1
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        finite = bool(torch.isfinite(torch.stack(totals)).all())
        self.counters = {"window_s": elapsed, "work": steps, "steps": steps,
                         "batch": self.tr["batch"], "finite": finite,
                         "passes": {"default": 1, "high": 3}.get(
                             self.cfg["model"].get("precision"), 0)}
        return self.counters

    def end_to_end(self) -> Dict[str, float]:
        c = self.counters
        return {"train_images_per_s": c["batch"] * c["steps"]
                / c["window_s"]}

    def release(self) -> None:
        self.state = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------

    def reference_steps(self, robust: List[torch.Tensor],
                        count_flops: bool = False) -> Dict:
        """The reference through the check's steps from the same start,
        batches and generator, each relaxed term against the program's
        iterate of that step (`robust`)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.gen_seed)
        trainer = reference.Trainer(self.start, lr=self.cfg["lr"])
        before = {p: t.detach().clone() for p, t in trainer.trained}
        losses, grad, relaxed, inner = [], {}, [], []
        for i in range(self.tr["check_steps"]):
            # An iterate of another shape, or none, is the program's fault:
            # the reference runs its own loop and the stage reads inf.
            took = robust[i] if i < len(robust) and \
                robust[i].shape == self.style[i].shape else None
            inner.append([])
            args = (self.content[i], self.style[i], gen, took, inner[-1])
            if i == 0 and count_flops:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as fc:
                    terms, g = trainer.step(*args)
                self.counters["step_flops"] = float(fc.get_total_flops())
            else:
                terms, g = trainer.step(*args)
            losses.append(terms["total"])
            relaxed.append((terms["new_style"] if took is not None
                            else float("inf"), terms["own_relaxed"]))
            if i == 0:
                grad = {p: float(v.norm()) for p, v in g.items()}
        change = {p: float((t.detach() - before[p]).norm())
                  for p, t in trainer.trained}
        return {"losses": losses, "grad": grad, "change": change,
                "relaxed": relaxed, "inner": inner}

    def check(self):
        ref = self.reference_steps(self.prog["robust"], count_flops=True)
        got = readings(self.prog, ref)
        for k, v in got.items():
            if k not in self.cfg["limits"]:
                print(f"reading {k} = {v!r} (not compared)",
                      file=sys.stderr)
        ok, compared = judge(got, self.cfg["limits"])
        finite = self.counters.get("finite", True)
        return (ok and finite, self.counters["steps"]
                + self.tr["check_steps"], 0 if finite else 1, compared)

    def calibrate(self, seed: int, spec_model: Dict,
                  fault: Optional[str] = None) -> Dict[str, float]:
        self.make_inputs(seed)
        state, step, gen = self.program(spec_model)
        prog = self.first_steps(state, step, gen, fault)
        del state, step
        self.release()
        return readings(prog, self.reference_steps(prog["robust"]))
