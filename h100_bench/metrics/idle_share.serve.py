"""idle_share.serve: 1 - (the union of the device's busy intervals) / (the
profiled stretch's wall time) over one cycle of requests back to back, in %."""

from h100_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
