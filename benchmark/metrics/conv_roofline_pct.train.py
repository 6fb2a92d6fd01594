"""conv_roofline_pct.train: sum of the one-launch bounds over sum of the
device time of every traced launch of ``rerevst::conv3x3_implicit_gemm``
(the step's forward convs and input gradients) and
``rerevst::conv3x3_wgrad`` (the weight gradients), each at its pass count.
Layer: kernels.  Moves train_images_per_s."""

from benchmark.lib import flops


def read(ctx):
    return flops.traced_roofline_pct(
        ctx.trace, ("conv3x3_implicit_gemm", "conv3x3_wgrad"),
        ctx.counters.get("passes") or 3)
