"""A profiled stretch of the cell's own work and what the metrics read
from it.

:func:`capture` runs a callable under ``torch.profiler`` (host and device
activity), inside a host span ``h100_bench.stretch``, writes the chrome
trace to a temporary file (under ``TMPDIR``), reads it back and removes
it. :func:`parse` keeps the device's events (kernels, copies, memsets:
name, start, length, category) and the host's spans on the thread that
ran the stretch. Busy time is the union of the device's intervals, not
their sum, so kernels that overlap count once.

The categorisation is a copy of the program's
``nkbx_torch.core.profiling.categorize_kernel`` with the program's kernel
names frozen in ``kernels/port.json``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
STRETCH = "h100_bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

_PORT = None


def _port_pattern():
    global _PORT
    if _PORT is None:
        names = json.loads((HERE / "kernels" / "port.json").read_text())["names"]
        _PORT = re.compile(r"^(void )?(\(anonymous namespace\)|chain(::tc)?)::("
                           + "|".join(sorted(names)) + r")[<(]")
    return _PORT


def categorize(name: str) -> str:
    """The kind of a device operation by its name: the program's own
    kernels, copies and memsets, the optimizer's foreach kernels, cuDNN
    convolutions, GEMMs, reductions, elementwise, other."""
    n = name.lower()
    if _port_pattern().search(name):
        return "port kernels"
    if n.startswith(("memcpy", "memset")):
        return "copies/memset"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer foreach"
    if any(w in n for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "cudnn convolution"
    if "gemm" in n or "nvjet" in n:
        return "cublas gemm"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments, at most 96 characters."""
    n = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    n = re.split(r"[<(]", n, maxsplit=1)[0]
    n = n.rsplit("::", 1)[-1] or name
    return n[:96]


def matches(name: str, names) -> bool:
    """Whether a device operation is one of the kernels ``names``
    (``__global__`` names, matched whole after any namespace)."""
    return any(re.search(rf"(^|[\s:]){re.escape(k)}[<(]", name) for k in names)


class Trace:
    """``device``: (name, category, start_us, dur_us) of the device events
    inside the stretch; ``host``: (name, start_us, dur_us) of the host
    spans on the stretch's thread (none in a trace of the device alone);
    ``start``, ``end``: the stretch (us)."""

    def __init__(self, device, host, start, end):
        self.device, self.host, self.start, self.end = device, host, start, end
        self._starts = None

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device's intervals, clipped to the stretch."""
        spans = sorted((max(s, self.start), min(s + d, self.end)) for _, _, s, d in self.device)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(start_us, end_us) of the stretch's intervals with nothing on the
        device."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def kernel_s(self, names) -> float:
        return sum(d for n, _, _, d in self.device if matches(n, names)) / 1e6

    def seconds_where(self, pred) -> float:
        return sum(d for n, c, _, d in self.device if pred(n, c)) / 1e6

    def host_at(self, t_us: float, reach: int = 5000) -> str:
        """The innermost host span that holds ``t_us`` (the latest-starting
        one, found among the ``reach`` spans that start before it); "python"
        where none does."""
        if self._starts is None:
            self.host.sort(key=lambda h: h[1])
            self._starts = [h[1] for h in self.host]
        i = bisect.bisect_right(self._starts, t_us)
        for name, s, d in reversed(self.host[max(0, i - reach):i]):
            if s + d >= t_us and name != STRETCH:
                return name
        return "python"

    def breakdown(self, host_trace=None, top: int = 10) -> dict:
        """The device operations that took most time (by kernel name, with
        its kind), and the idle time by what the host was doing at each
        gap's middle in ``host_trace`` (a trace with the host's spans; this
        one by default); each list ``top`` long at most, seconds as
        measured."""
        ops = defaultdict(float)
        for n, c, _, d in self.device:
            ops[f"{c}: {short_name(n)}"] += d / 1e6
        ht = host_trace or self
        gaps = defaultdict(float)
        for s, e in ht.idle_gaps():
            gaps[ht.host_at((s + e) / 2)] += (e - s) / 1e6

        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(ops), "idle_gaps": first(gaps)}


def parse(events: list, wall_us=None) -> Trace:
    """A :class:`Trace` from a chrome trace's event list: the stretch is
    the ``h100_bench.stretch`` host span, or, in a trace of the device
    alone, ``wall_us`` from the first device event."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = next((e for e in xs if e.get("name") == STRETCH
                    and e.get("cat") == "user_annotation"), None)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if stretch is not None:
        start, end = float(stretch["ts"]), float(stretch["ts"]) + float(stretch["dur"])
    elif wall_us is not None and dev:
        start = min(float(e["ts"]) for e in dev)
        end = start + wall_us
    else:
        raise ValueError(f"no {STRETCH} span and no device events in the trace")
    device = [(e["name"], categorize(e["name"]), float(e["ts"]), float(e.get("dur", 0)))
              for e in dev
              if float(e["ts"]) < end and float(e["ts"]) + float(e.get("dur", 0)) > start]
    tid = stretch.get("tid") if stretch is not None else None
    host = [(e["name"], float(e["ts"]), float(e.get("dur", 0))) for e in xs
            if e.get("cat") in HOST_CATS and e.get("tid") == tid and e.get("name") != STRETCH
            and float(e["ts"]) < end and float(e["ts"]) + float(e.get("dur", 0)) > start]
    return Trace(device, host, start, end)


def capture(fn, host: bool = True) -> Trace:
    """Run ``fn()`` once under the profiler and return its :class:`Trace`.
    ``host=False`` records the device alone, which slows the host less:
    the stretch is then the host clock's time around ``fn()`` and the
    synchronise after it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    host = host or not card
    acts = ([ProfilerActivity.CPU] if host else []) + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH):
            fn()
            if card:
                torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(prefix="h100_bench_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f).get("traceEvents", []), None if host else wall_us)
    finally:
        os.remove(path)
