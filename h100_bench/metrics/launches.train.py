"""launches.train: kernels launched on the device a train step in the
profiled stretch (copies and memsets not counted)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return sum(1 for name, kind, _, _ in ctx.trace.device
               if not name.startswith(("Memcpy", "Memset"))) / ctx.trace_units
