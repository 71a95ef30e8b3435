"""ln_mlp_roofline.serve: the least time of the served images' LN->MLP
forward work over the device time of K5 (``ln_mlp_roofline.kernels.json``)
in the profiled stretch, in %."""

from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "ln_mlp", ctx.family.ln_mlp_calls)
