"""norm_roofline_pct.infer: sum of the byte bounds over sum of the device
time of every traced ``rerevst::norm_affine_clamp`` launch (x read once, y
written once, the conditioning vectors read once).  Layer: kernels.  Moves
frames_per_s; read in the global cells, where the frozen norms run."""

from benchmark.lib import flops


def read(ctx):
    return flops.traced_roofline_pct(ctx.trace, ("norm_affine_clamp",), 1)
