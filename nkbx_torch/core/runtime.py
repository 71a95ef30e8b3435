"""Device resolution for the port's entry points, the distributed runtime
(:func:`initialize`), timers, and the profiler trace.

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


def initialize(distributed: bool = False, device=None) -> dict:
    """The port's runtime set-up (nkbx's ``initialize``); with
    ``distributed=True``, this process's rank of a ``torch.distributed``
    process group made from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``device`` None (or ``"cuda"``): each rank takes its own card,
    ``cuda:LOCAL_RANK`` (raising where the node has no such card), and the
    group runs over NCCL. An explicit device (``"cpu"``, or ``"cuda:0"`` for
    ranks that share one card, which NCCL refuses) runs the group over
    gloo. The backend and device are logged.

    Returns nkbx's keys: ``backend`` (the process group's, or the device
    type on one process), ``devices`` (ranks), ``local_devices`` (ranks of
    this node), ``process_index`` and ``process_count`` (the node, nkbx's
    process: see :mod:`nkbx_torch.parallel.mesh`), and ``rank`` and
    ``device``."""
    import logging

    import torch.distributed as dist

    if not distributed:
        dev = resolve_device(device)
        return {"backend": dev.type, "devices": 1, "local_devices": 1, "process_index": 0,
                "process_count": 1, "rank": 0, "device": dev}
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize(distributed=True) reads torchrun's environment and "
                           f"{', '.join(missing)} is not set: launch with python -m "
                           "torch.distributed.run --nproc_per_node=N ...")
    local_rank = int(os.environ["LOCAL_RANK"])
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no card
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} has no card of its own: "
                               f"{torch.cuda.device_count()} visible; start at most that many "
                               "ranks a node, or pass device= to share one")
        dev, backend = torch.device("cuda", local_rank), "nccl"
    else:
        dev, backend = resolve_device(device), "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    logging.getLogger(__name__).info("rank %d of %d: backend %s, device %s", rank, world,
                                     backend, dev)
    return {"backend": backend, "devices": world, "local_devices": local_world,
            "process_index": rank // local_world, "process_count": world // local_world,
            "rank": rank, "device": dev}


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

    @property
    def images(self) -> int:
        return self._images

    def add_images(self, n: int):
        """Images fed in the same time elsewhere: a data-parallel epoch's
        other ranks, whose cards ``n_chips`` counts."""
        self._images += n

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
