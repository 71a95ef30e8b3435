"""Arithmetic shared by the per-layer metrics' readers (``metrics/*.py``).
Each returns None where the run gives it nothing to read (no trace, no
device events, no peak for the card), never 0 for a share."""

from __future__ import annotations

import json
from pathlib import Path

from h100_bench import work

HERE = Path(__file__).resolve().parent


def _peak(ctx):
    return work.peaks(ctx.device_name)


def _events(ctx) -> bool:
    return ctx.trace is not None and bool(ctx.trace.device)


def kernel_names(layer: str) -> list:
    return json.loads((HERE / "metrics" / f"{layer}_roofline.kernels.json").read_text())["names"]


def mfu(ctx, images: int, seconds: float):
    """Model FLOPs of ``images`` (a train step's or a forward's, padding
    rows not counted) over ``seconds`` on the host's clock, in % of the
    card's bf16 peak."""
    peak = _peak(ctx)
    if peak is None or seconds <= 0:
        return None
    flops = work.model_flops(ctx.family, ctx.config, images, train=ctx.train)
    return 100.0 * flops / seconds / peak[0]


def roofline(ctx, layer: str, calls_of):
    """The least time of the layer's work in the stretch over the device
    time of the kernels named in ``metrics/<layer>_roofline.kernels.json``,
    in %."""
    peak = _peak(ctx)
    if peak is None or not _events(ctx):
        return None
    spent = ctx.trace.kernel_s(kernel_names(layer))
    if spent <= 0:
        return None
    bound = {"ln_mlp": work.ln_mlp_bound_s, "attention": work.attention_bound_s}[layer]
    least = sum(bound(calls_of(ctx.config, n), ctx.train, peak) for n in ctx.trace_batches)
    if least <= 0:
        return None
    return 100.0 * least / spent


def per_unit_ms(ctx, pred):
    """Device ms a step or a request in the operations ``pred(name,
    category)`` selects."""
    if not _events(ctx):
        return None
    return 1e3 * ctx.trace.seconds_where(pred) / ctx.trace_units


def idle_share(ctx):
    """1 - (the union of the device's busy intervals) / (the stretch's wall
    time), in %."""
    if not _events(ctx):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)
