"""mfu.infer: the model FLOPs of the useful work over the window, over
TF32's 495 TFLOP/s, in percent.  Useful work: each delivered frame's Pass 2
at its padded geometry and each sampled frame's Pass-1 encode at its own
(``benchmark/lib/flops.py``); padding rows of a batch are not counted.
Layer: model.  Moves frames_per_s."""

from benchmark.lib import flops


def read(ctx):
    c = ctx.counters
    if not c.get("frames_delivered"):
        return None
    work = (c["frames_delivered"] * flops.stylize_flops(
        c["padded_height"], c["padded_width"], c["per_frame"])
        + c["pass1_frames"] * flops.vgg_flops(c["height"], c["width"]))
    return 100.0 * work / c["window_s"] / flops.PEAK_FLOPS["tf32"]
