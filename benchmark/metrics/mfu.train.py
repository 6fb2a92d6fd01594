"""mfu.train: the step's model FLOPs (convs and products, forward and
backward, the relaxed loop's inner gradients included, counted once by
``torch.utils.flop_counter`` over the reference's first step at the cell's
shapes, whatever the pass count) times the window's steps, over the
window, over TF32's 495 TFLOP/s, in percent.  Layer: model.  Moves
train_images_per_s."""

from benchmark.lib import flops


def read(ctx):
    c = ctx.counters
    if not c.get("step_flops") or not c.get("steps"):
        return None
    return 100.0 * c["step_flops"] * c["steps"] / c["window_s"] \
        / flops.PEAK_FLOPS["tf32"]
