"""ln_mlp_roofline.train: the least time of the train steps' LN->MLP work
(forward and backward, from the model's shapes) over the device time of
K5 and K6 (``ln_mlp_roofline.kernels.json``) in the profiled stretch, in %."""

from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "ln_mlp", ctx.family.ln_mlp_calls)
