"""mfu.serve: the model FLOPs of the images served back to back for as
long as the window, unprofiled, after it (2 x the forward's multiply-adds
an image, padding rows not counted) over that stretch's time on the host's
clock, in % of the card's bf16 peak."""

from h100_bench.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.capacity_images, ctx.capacity_s)
