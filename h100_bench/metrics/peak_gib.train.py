"""peak_gib.train: ``torch.cuda.max_memory_allocated`` over the window, in
GiB (its peak statistics reset when the window opens)."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2**30
