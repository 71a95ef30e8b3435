"""optimizer_ms.train: device ms a step in the optimizer's foreach kernels
(the copied categorisation's "optimizer foreach")."""

from h100_bench.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda name, kind: kind == "optimizer foreach")
