"""The general drivers, one a kind of traffic mix (``kind`` in the mix's
file): ``train`` and ``serve``. Each ``run(cell, seed, seconds, trace,
device, t0)`` builds the program from the cell's files, warms up, measures
the window, optionally profiles a stretch after it, checks what the timed
path produced against the plain reference and returns a :class:`Outcome`."""

from __future__ import annotations

import dataclasses
import gc
from typing import Optional


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: object
    device_name: str
    train: bool
    window_s: float = 0.0
    window_images: int = 0
    peak_window_bytes: Optional[int] = None
    trace: object = None  # trace.Trace of the profiled stretch (the device alone)
    host_trace: object = None  # the same stretch again, with the host's spans
    trace_batches: list = dataclasses.field(default_factory=list)  # images a step or request
    capacity_s: float = 0.0  # a serving cell's back-to-back stretch, unprofiled
    capacity_images: int = 0

    @property
    def trace_units(self) -> int:
        return len(self.trace_batches)

    @property
    def trace_images(self) -> int:
        return sum(self.trace_batches)

    @property
    def family(self):
        return self.cell.family

    @property
    def config(self):
        return self.cell.config


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict  # {name: value}
    context: Context
    memory_peak_bytes: int
    checks: dict  # {name: {"value", "limit"}}
    notes: dict = dataclasses.field(default_factory=dict)


def release():
    """Give the memory of the program's dropped state back to the card (the
    caller drops its references first)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
