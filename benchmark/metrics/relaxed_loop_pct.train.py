"""relaxed_loop_pct.train: device time attributed to the relaxed style
loss's inner loop (the program's profiler range ``INNER_LOOP_RANGE``) over
all device time of the traced window, in percent.  Layer: train step.
Moves train_images_per_s."""

from benchmark.lib.trace import device_us


def read(ctx):
    from rerevst_torch.losses.relaxed import INNER_LOOP_RANGE

    t = ctx.trace
    inner = sum(device_us(e) for e in t.ops(INNER_LOOP_RANGE)) / 1e6
    if inner <= 0 or t.kernel_s <= 0:
        return None
    return 100.0 * inner / t.kernel_s
