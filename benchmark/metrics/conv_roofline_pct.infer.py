"""conv_roofline_pct.infer: sum of the one-launch bounds over sum of the
device time of every traced ``rerevst::conv3x3_implicit_gemm`` and
``rerevst::conv3x3_pairlane`` launch (the one-pass, rows and three-pass
designs alike), shapes from the profiler's recorded inputs, each bound at
the launch's pass count.  Layer: kernels.  Moves frames_per_s."""

from benchmark.lib import flops


def read(ctx):
    return flops.traced_roofline_pct(
        ctx.trace, ("conv3x3_implicit_gemm", "conv3x3_pairlane"),
        ctx.counters.get("passes") or 1)
