"""Device resolution for the port's entry points, timers, and the profiler
trace.

The port runs on the CUDA card by default. The CPU is taken only when the
caller asks for it (``device="cpu"``, as the tests do); a missing card is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise when a CUDA device is asked for and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nkbx_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds of one call of ``fn`` on the current CUDA stream: one
    call to warm up, then ``iters`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
_HOLD_CYCLES = 1_000_000  # about 0.5 ms of the card's clock: longer than a call's host work


def cold_ms(fn, iters: int) -> float:
    """Milliseconds of one call of ``fn`` on the current CUDA stream with a
    cold L2 cache: one call to warm up, then ``iters`` calls, each after a
    256 MB read that evicts the cache and timed alone between two CUDA
    events. Back-to-back calls on a tensor that fits the L2 would read it
    from there and time under the memory's bound. A spin kernel after the
    read holds the stream while the host enqueues the call, so that the
    host's own time (Python, argument checks, launch) does not open a gap
    between the two events. The spin is ``torch.cuda._sleep``, a private
    PyTorch function (used by PyTorch's own tests) that may change between
    releases."""
    fn()
    flush = torch.ones(_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for a, b in events:
        flush.sum()
        torch.cuda._sleep(_HOLD_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


@dataclasses.dataclass
class Throughput:
    """Steps and images a second of the host loop since creation or
    :meth:`reset` (counterpart of nkbx's ``Throughput``)."""

    n_chips: int = 1
    _t0: float = dataclasses.field(default_factory=time.perf_counter)
    _steps: int = 0
    _images: int = 0

    def step(self, batch_size: int):
        self._steps += 1
        self._images += batch_size

    def reset(self):
        self._t0, self._steps, self._images = time.perf_counter(), 0, 0

    def snapshot(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"steps_per_sec": self._steps / dt, "images_per_sec": self._images / dt,
                "images_per_sec_per_chip": self._images / dt / max(self.n_chips, 1),
                "elapsed_sec": dt}


@contextlib.contextmanager
def profile_trace(log_dir, device=None):
    """``with profile_trace("/tmp/tb"): ...`` records the block with
    ``torch.profiler`` and writes its chrome trace to
    ``log_dir/trace_<pid>_<ns>.json.gz``, which
    :func:`nkbx_torch.core.profiling.aggregate_trace` turns into time by
    kernel and by kind (nkbx's ``profile_trace(log_dir, perfetto=True)``).
    On the card (the default) it records CPU and CUDA activity; with
    ``device="cpu"`` CPU activity only. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json.gz"))
