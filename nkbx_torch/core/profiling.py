"""Device time by kernel and by kind of kernel (counterpart of
``nkbx/core/profiling.py``).

Two inputs:

- a chrome trace that ``torch.profiler`` wrote
  (:func:`nkbx_torch.core.runtime.profile_trace`, ``.json`` or
  ``.json.gz``): :func:`aggregate_trace` sums the device events (kernels,
  copies and memsets) by name and by :func:`categorize_kernel`'s kind, or
  the host's operators in a trace of the CPU alone;
- a profiler still in memory: :func:`device_events` lists its kernels from
  ``key_averages()``, :func:`kernel_ms` sums one kernel of ours and
  :func:`kernel_kinds` the kinds.

The port's own kernels are told apart by name: the ``__global__`` functions
of ``nkbx_torch/ops/csrc`` (:func:`port_kernel_names`). The CLI::

    python -m nkbx_torch.core.profiling TRACE_OR_DIR [--top N]

prints :func:`format_breakdown` of a trace, or of the newest one under a
directory.
"""

from __future__ import annotations

import argparse
import functools
import glob
import gzip
import json
import os
import re
from collections import defaultdict

from nkbx_torch.ops._build import CSRC

__all__ = ["aggregate_trace", "categorize_kernel", "format_breakdown", "device_events",
           "kernel_ms", "kernel_kinds", "port_kernel_names"]

# the chrome trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

KINDS = ("port kernels", "cudnn convolution", "cublas gemm", "reductions", "elementwise",
         "optimizer foreach", "copies/memset", "other")


@functools.lru_cache(maxsize=None)
def port_kernel_names() -> frozenset:
    """The names of the port's own CUDA kernels, from the ``__global__``
    functions of nkbx_torch/ops/csrc."""
    names = set()
    for p in sorted(CSRC.glob("*.cu*")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                p.read_text()))
    return frozenset(names)


@functools.lru_cache(maxsize=None)
def _port_kernel():
    """A profiler name of a port kernel: the kernels live in each source's
    unnamed namespace ("void (anonymous namespace)::ln_mlp_gemm_kernel<...>(...)")
    or in bottleneck.cuh's ``chain`` and bottleneck_tc.cuh's ``chain::tc``."""
    return re.compile(r"^(void )?(\(anonymous namespace\)|chain(::tc)?)::("
                      + "|".join(sorted(port_kernel_names())) + r")[<(]")


def categorize_kernel(name: str) -> str:
    """The kind of a CUDA kernel by its name (one of :data:`KINDS`): the
    port's own first (their names hold "gemm" or "wgrad" too), the CUDA
    runtime's copies and memsets, then the libraries' kernels by the words
    of their names."""
    n = name.lower()
    if _port_kernel().search(name):
        return "port kernels"
    if n.startswith(("memcpy", "memset")):
        return "copies/memset"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer foreach"
    if any(w in n for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "cudnn convolution"
    if "gemm" in n or "nvjet" in n:  # nvjet: cuBLASLt's Hopper GEMMs
        return "cublas gemm"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def _find_trace(path) -> str:
    if os.path.isfile(path):
        return str(path)
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(
            f"no *.json or *.json.gz trace under {str(path)!r} — capture one with "
            f"nkbx_torch.core.runtime.profile_trace(log_dir)")
    return max(files, key=os.path.getmtime)


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _sorted(d: dict) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1]))


def aggregate_trace(path, extra_category=None) -> dict:
    """Sum the durations of a torch profiler chrome trace's device events
    (kernels, copies, memsets), or of its host operators (``cpu_op``) where
    it holds none, as a trace of the CPU alone does.

    ``path`` is a trace or a directory (the newest trace under it).
    ``extra_category`` (``name -> kind | None``) is tried before
    :func:`categorize_kernel`. Returns ``total_ms``, ``by_name`` (ms a name),
    ``by_category`` (ms a kind), both largest first, and ``events``: the
    side counted, ``"device"`` or ``"host"``."""
    events = [e for e in _load(_find_trace(path)).get("traceEvents", []) if e.get("ph") == "X"]
    on_device = any(e.get("cat") in DEVICE_CATS for e in events)
    cats = DEVICE_CATS if on_device else ("cpu_op",)
    by_name: dict = defaultdict(float)
    for e in events:
        if e.get("cat") in cats:
            by_name[e["name"]] += e.get("dur", 0) / 1e3  # us -> ms
    by_cat: dict = defaultdict(float)
    for name, ms in by_name.items():
        cat = extra_category(name) if extra_category else None
        by_cat[cat or categorize_kernel(name)] += ms
    return {"total_ms": sum(by_name.values()), "by_name": _sorted(by_name),
            "by_category": _sorted(by_cat), "events": "device" if on_device else "host"}


def format_breakdown(agg: dict, top: int = 20) -> str:
    total = agg["total_ms"] or 1e-9
    side = "host operator" if agg.get("events") == "host" else "device"
    lines = [f"total {side} time: {agg['total_ms']:.2f} ms", "", "by category:"]
    for cat, ms in agg["by_category"].items():
        lines.append(f"  {ms:9.2f} ms  {100 * ms / total:5.1f}%  {cat}")
    lines += ["", f"top {top} kernels:"]
    for name, ms in list(agg["by_name"].items())[:top]:
        lines.append(f"  {ms:9.2f} ms  {name[:100]}")
    return "\n".join(lines)


# --- a profiler in memory ---------------------------------------------------------


def device_events(prof):
    """``(device us, event)`` of the kernels in ``prof.key_averages()``,
    largest first (a CPU op's device time repeats its kernels')."""
    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    events = [(dev_us(e), e) for e in prof.key_averages()
              if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sorted(events, key=lambda t: -t[0])


def _ms_by_name(events):
    """(name, ms) pairs of :func:`device_events` or of a ``by_name`` dict."""
    if isinstance(events, dict):
        return list(events.items())
    return [(e.key, us / 1e3) for us, e in events]


# K7 and K8 launch the kernels of K5's and K6's sources (ln_mlp_*): on a path
# that runs no K5/K6 their names are these
SHARED_NAMES = {"mlp": "ln_mlp", "mlp_bwd": "ln_mlp_bwd"}


def kernel_ms(events, name, reps, want):
    """Device ms of one kernel of ours a repetition, by its names' prefix
    after the namespace (K1: window_attention*, K3: attention_*; a backward
    name with its reduction, K2: window_attention_bwd*, K4: attention_bwd_*),
    a forward's name not followed by ``_bwd``; K7/K8 by SHARED_NAMES, on a
    path whose launch counts ``want`` hold no K5/K6. ``events`` are
    :func:`device_events` or :func:`aggregate_trace`'s ``by_name``."""
    if name in SHARED_NAMES:
        if want[SHARED_NAMES[name]]:
            raise ValueError(f"{name} and {SHARED_NAMES[name]} both ran: their kernels' names "
                             f"are one")
        name = SHARED_NAMES[name]
    pat = rf"(^|[^\w]){name}" + ("" if name.endswith("_bwd") else "(?!_bwd)")
    return sum(ms for key, ms in _ms_by_name(events) if re.search(pat, key)) / reps


def kernel_kinds(events, reps):
    """Device ms a repetition by :func:`categorize_kernel`'s kind, every
    kind present."""
    kinds = dict.fromkeys(KINDS, 0.0)
    for key, ms in _ms_by_name(events):
        kinds[categorize_kernel(key)] += ms / reps
    return kinds


def main(argv=None):
    ap = argparse.ArgumentParser(description="Device time by kind and by kernel of a torch "
                                             "profiler chrome trace")
    ap.add_argument("trace", help="a .json or .json.gz trace, or a directory (its newest)")
    ap.add_argument("--top", type=int, default=20, help="kernels listed")
    args = ap.parse_args(argv)
    print(format_breakdown(aggregate_trace(args.trace), args.top))


if __name__ == "__main__":
    main()
