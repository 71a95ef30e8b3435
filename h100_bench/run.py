"""One run of one cell of the port's benchmark on one H100:

    python3 -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (:mod:`h100_bench.spec`), refuses to run without
as many CUDA cards as the cell asks for, builds and warms up the program
(``nkbx_torch``), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, the card's power limit, and
last ``checks``, each compared number beside its limit (also the last lines
of standard error).

Exits 2 without a line where the card or the cell's files are missing, and
3 where the process holds JAX or the JAX package once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "optax", "nkbx"}


def banned_modules() -> list:
    """Top-level names of the loaded modules that belong to JAX or to the
    JAX package (compared whole: ``nkbx_torch`` is not ``nkbx``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & BANNED)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _finite(x):
    """``x`` with every non-finite float as None (strict JSON has no inf)."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def execute(cell, seed: int, seconds: float, trace_on: bool, device, t0: float) -> dict:
    """Run ``cell`` on ``device`` (no look for a card) and return the line."""
    import torch

    from h100_bench import spec

    out = cell.driver.run(cell, seed, seconds, trace_on, device, t0)
    ctx = out.context
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": bool(out.correct), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if trace_on and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.wall_s
        line["breakdown"] = ctx.trace.breakdown(ctx.host_trace)
    line["power_limit_w"] = power_limit_w() if on_card else None
    line["notes"] = out.notes
    line["checks"] = out.checks
    return _finite(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    from h100_bench import spec

    try:
        cell = spec.cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"h100_bench: cannot load cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    found = banned_modules()
    if found:
        print(f"h100_bench: the process holds {', '.join(found)} after the window; no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
