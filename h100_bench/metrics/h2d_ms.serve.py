"""h2d_ms.serve: device ms a request in host-to-device copies in the
profiled stretch."""

from h100_bench.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda name, kind: "HtoD" in name)
