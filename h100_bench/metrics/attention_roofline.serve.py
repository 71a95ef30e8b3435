"""attention_roofline.serve: the least time of the served images'
attention forward work over the device time of K3
(``attention_roofline.kernels.json``) in the profiled stretch, in %."""

from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "attention", ctx.family.attention_calls)
