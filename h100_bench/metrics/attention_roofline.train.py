"""attention_roofline.train: the least time of the train steps' attention
work (forward and backward) over the device time of K3 and K4
(``attention_roofline.kernels.json``) in the profiled stretch, in %."""

from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "attention", ctx.family.attention_calls)
