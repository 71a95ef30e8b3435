"""capacity_img_s.serve: images a second served by the one caller with
the requests back to back (the mix's cycle, over and over) for as long as
the window, unprofiled, after it: the rate the serving path sustains,
beside the window's tail at its fixed rate."""


def read(ctx):
    return ctx.capacity_images / ctx.capacity_s if ctx.capacity_s > 0 else None
