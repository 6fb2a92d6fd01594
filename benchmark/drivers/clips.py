"""Inference traffic: whole clips through ``Stylization.stylize_video``, one
client in a closed loop (a batch job over clips, as the stylize CLI runs
one).

Set-up makes ``clips`` distinct seeded clips and one seeded style on the
device, loads the configuration's weights as fp32 and hands the same
tensors to the program and to the reference, prepares the style, and runs
``warmup_clips`` whole clips.  The window hands the clips to the session in
turn, each consumed to its last frame, until ``--seconds`` have passed; it
closes at the end of that clip, and every delivered frame counts.  Of each
clip handed over, ``check.frames_per_iteration`` frames drawn from the seed
are kept; after the window ``check.iterations`` of the handed clips, drawn
from the seed, are stylized again by the reference (its own Pass 1 from the
same sampled frames in global mode) and their kept frames compared.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import check, data, faults, weights
from benchmark.reference import model as reference

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


def model_config(spec: Dict):
    from rerevst_torch.config import ModelConfig

    kw = dict(spec)
    kw["dtype"] = DTYPES[kw.get("dtype", "float32")]
    return ModelConfig(**kw)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.tr = ctx.traffic
        self.device = torch.device(ctx.device)
        self.session = None
        self.kept: Dict[tuple, np.ndarray] = {}
        self.counters: Dict = {}

    # -- set-up ----------------------------------------------------------

    def load(self, seed: int) -> None:
        """Weights, inputs and the program's session, without warm-up."""
        self.params = weights.as_float32(
            weights.read(str(self.ctx.root / self.cfg["weights"])))
        self.params = {k: v for k, v in self.params.items()
                       if k in ("encoder", "encoder_style", "decoder")}
        self.make_inputs(seed)
        self.session = self.new_session(self.cfg["model"])

    def make_inputs(self, seed: int) -> None:
        t = self.tr
        self.seed = seed
        self.clips = data.clips(seed, t["clips"], t["frames"], t["height"],
                                t["width"], self.device)
        self.style = data.style(seed, t["style_size"], t["style_size"],
                                self.device)

    def new_session(self, model_spec: Dict):
        from rerevst_torch.api import Stylization
        from rerevst_torch.config import InferenceConfig

        t = self.tr
        s = Stylization(params=self.params, cfg=model_config(model_spec),
                        use_global=t["use_global"],
                        infer=InferenceConfig(
                            use_global=t["use_global"],
                            sample_interval=t["sample_interval"],
                            batch_size=t["batch"]),
                        device=self.device)
        s.prepare_style(self.style)
        return s

    def setup(self, seed: int) -> None:
        self.load(seed)
        for k in range(self.tr.get("warmup_clips", 2)):
            for _ in self.session.stylize_video(
                    list(self.clips[k % len(self.clips)]),
                    batch_size=self.tr["batch"]):
                pass
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ------------------------------------------------------

    def _keep_plan(self, seed: int):
        rng = np.random.default_rng([seed, 7])
        per = self.tr["check"]["frames_per_iteration"]
        n = self.tr["frames"]
        while True:
            yield set(rng.choice(n, size=min(per, n), replace=False).tolist())

    def run_clips(self, session, seconds: Optional[float],
                  iterations: Optional[int] = None, seed: int = 0):
        """Hand clips to `session` in turn until `seconds` have passed (or
        for `iterations` clips); keep the planned frames.  Returns the
        counters of the run."""
        plan = self._keep_plan(seed)
        kept: Dict[tuple, np.ndarray] = {}
        first_ms: List[float] = []
        clip_s: List[float] = []
        delivered = short = 0
        k = 0
        t0 = time.perf_counter()
        while True:
            want = next(plan)
            clip = list(self.clips[k % len(self.clips)])
            t_hand = time.perf_counter()
            got = 0
            for i, frame in enumerate(session.stylize_video(
                    clip, batch_size=self.tr["batch"])):
                if got == 0:
                    first_ms.append((time.perf_counter() - t_hand) * 1e3)
                if i in want:
                    kept[(k, i)] = frame
                got += 1
            delivered += got
            short += len(clip) - got
            clip_s.append(time.perf_counter() - t_hand)
            k += 1
            if iterations is not None and k >= iterations:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        return {"window_s": elapsed, "work": delivered,
                "frames_delivered": delivered,
                "frames_missing": short, "clip_iterations": k,
                "first_frame_ms": first_ms, "clip_s": clip_s, "kept": kept}

    def window(self, seconds: float) -> Dict:
        run = self.run_clips(self.session, seconds, seed=self.seed)
        self.kept = run.pop("kept")
        print(f"clip seconds {[round(v, 4) for v in run['clip_s']]}",
              file=sys.stderr)
        t = self.tr
        h, w = t["height"], t["width"]
        ph, pw = reference.padded_size(h, w)
        samples = (len(reference.sample_indices(t["frames"],
                                                t["sample_interval"]))
                   if t["use_global"] else 0)
        run.update(height=h, width=w, padded_height=ph, padded_width=pw,
                   per_frame=not t["use_global"],
                   pass1_frames=samples * run["clip_iterations"],
                   passes={"default": 1, "high": 3}.get(
                       self.cfg["model"].get("precision"), 0))
        self.counters = run
        return run

    def end_to_end(self) -> Dict[str, float]:
        c = self.counters
        return {"frames_per_s": c["frames_delivered"] / c["window_s"]}

    def release(self) -> None:
        self.session = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------

    def chosen_iterations(self, seed: int, done: int) -> List[int]:
        rng = np.random.default_rng([seed, 8])
        n = min(self.tr["check"]["iterations"], done)
        return sorted(rng.choice(done, size=n, replace=False).tolist())

    def reference_frames(self, iters: List[int], kept: Dict[tuple, np.ndarray]
                         ):
        """(program frames, reference frames) of the chosen iterations."""
        t = self.tr
        # The configuration's TF32 passes are the card's: the program's
        # plain path on the CPU is exact, and so is the reference there.
        passes = (self.cfg.get("reference_conv3x3_passes", 0)
                  if self.device.type == "cuda" else 0)
        ref = reference.Reference(self.params, self.style, self.device,
                                  passes)
        prog, want = [], []
        by_clip: Dict[int, List[int]] = {}
        for k in iters:
            idx = sorted(i for (kk, i) in kept if kk == k)
            by_clip.setdefault(k % len(self.clips), []).extend(idx)
            prog.extend(kept[(k, i)] for i in idx)
            want.extend((k % len(self.clips), i) for i in idx)
        out: Dict[tuple, np.ndarray] = {}
        for c, idx in by_clip.items():
            clip = self.clips[c]
            stats = None
            if t["use_global"]:
                stats = ref.pass1([clip[i] for i in reference.sample_indices(
                    t["frames"], t["sample_interval"])])
            uniq = sorted(set(idx))
            frames = ref.frames([clip[i] for i in uniq], stats,
                                block=t["check"].get("block", 4))
            out.update({(c, i): f for i, f in zip(uniq, frames)})
            del stats
        del ref
        return prog, [out[key] for key in want]

    def check(self):
        """(correct, attempted, failed, compared): `failed` counts the
        frames that never came and the compared frames whose own gap is
        over the worst frame's limit."""
        c = self.counters
        iters = self.chosen_iterations(self.seed, c["clip_iterations"])
        gaps = check.frame_gaps(*self.reference_frames(iters, self.kept))
        limits = self.cfg["limits"]
        ok, compared = check.judge(check.gap_readings(gaps), limits)
        failed = c["frames_missing"] + int(
            (~(gaps <= limits["worst_frame_mean_abs_counts"])).sum())
        attempted = c["frames_delivered"] + c["frames_missing"]
        return ok and c["frames_missing"] == 0, attempted, failed, compared

    #: Faults ``calibrate`` can plant: TF32 in every product that the
    #: configuration states exact (the library's convs and matmuls).
    FAULTS = ("tf32_rest",)

    def calibrate(self, seed: int, model_spec: Dict,
                  fault: Optional[str] = None) -> Dict[str, float]:
        """The numbers compared for one seed's inputs through a session of
        `model_spec`, over ``check.iterations`` whole clips (no window)."""
        self.make_inputs(seed)
        planted = {None: contextlib.nullcontext,
                   "tf32_rest": faults.library_tf32}[fault]
        with planted():
            session = self.new_session(model_spec)
            run = self.run_clips(session, None,
                                 iterations=self.tr["check"]["iterations"],
                                 seed=seed)
        del session
        self.release()
        iters = list(range(run["clip_iterations"]))
        return check.gap_readings(check.frame_gaps(
            *self.reference_frames(iters, run["kept"])))
