"""mfu.train: the model FLOPs of the window's train steps (3 x 2 x the
forward's multiply-adds an image) over the window's time, in % of the
card's bf16 peak."""

from h100_bench.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.window_images, ctx.window_s)
