"""ServingModule: batched inference with bucket padding (counterpart of
nkbx's ``TPUServingModule``, ``nkbx/export/serving.py``).

Built from a port :class:`~nkbx_torch.models.ClassificationModel` (nkbx's
StableHLO bundles cannot be read without JAX). A request's uint8 NHWC batch
is zero-padded up to the next bucket size, split into chunks of the largest
bucket when it is larger, normalised to the model's compute dtype on the
card, run through the model, and sliced back. Keeping a few fixed batch
shapes keeps the kernels' launch geometries few and warmed up.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from nkbx_torch.train.engine import build_predict_fn
from nkbx_torch.transforms.spec import Compose, Normalize


def default_buckets(max_batch: int) -> list:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class ServingModule:
    """Serve a ClassificationModel on its device with bucket padding."""

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 warm_up_on_load: bool = True):
        self.model = model
        self.classes = model.classes
        self.task = model.task
        self.device = model.device
        self.imgsz = model.input_size
        self.buckets = sorted(buckets) if buckets else default_buckets(32)
        norm = Compose([Normalize()])
        self._predict = build_predict_fn(
            model, lambda b: norm.device_apply(b, out_dtype=model.dtype))
        if warm_up_on_load:
            self.warm_up()

    # -- core ---------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def forward(self, im):
        """Run a uint8 NHWC batch (numpy or tensor; one HWC image is a batch
        of one); returns logits on the device (a tensor, or {target: tensor})."""
        x = torch.as_tensor(np.asarray(im)) if not isinstance(im, torch.Tensor) else im
        if x.ndim == 3:
            x = x[None]
        n = x.shape[0]
        bucket = self._bucket_for(n)
        if n > bucket:  # larger than the largest bucket: chunk
            outs = [self.forward(x[i:i + bucket]) for i in range(0, n, bucket)]
            if isinstance(outs[0], dict):
                return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
            return torch.cat(outs)
        x = x.to(self.device, non_blocking=True)
        if n < bucket:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        out = self._predict(x)
        if isinstance(out, dict):
            return {k: v[:n] for k, v in out.items()}
        return out[:n]

    __call__ = forward

    # -- ops ----------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self, batches: Optional[Sequence[int]] = None):
        """Run every bucket once (first launches load the kernels)."""
        h, w = self.imgsz
        for b in batches or self.buckets:
            self.forward(np.zeros((b, h, w, 3), dtype=np.uint8))
        self._sync()

    def benchmark(self, batch_size: int = 32, iters: int = 100):
        """p50/p99 latency and throughput for one batch size.

        ``p50_ms``/``p99_ms`` time the full ``forward`` from a host uint8
        batch (copy in, normalise, model, synchronise); ``compute_*`` stage the
        batch on the device once and time normalise + model; ``pipelined_*``
        issue ``iters`` forwards back to back and synchronise once."""
        h, w = self.imgsz
        x = np.random.default_rng(0).integers(0, 256, (batch_size, h, w, 3), dtype=np.uint8)
        self.forward(x)
        self._sync()

        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.forward(x)
            self._sync()
            times.append(time.perf_counter() - t0)
        times = np.asarray(times)

        xd = torch.as_tensor(x, device=self.device)
        ctimes = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.forward(xd)
            self._sync()
            ctimes.append(time.perf_counter() - t0)
        ctimes = np.asarray(ctimes)

        t0 = time.perf_counter()
        for _ in range(iters):
            self.forward(xd)
        self._sync()
        pipelined = (time.perf_counter() - t0) / iters

        return {
            "batch_size": batch_size,
            "p50_ms": float(np.percentile(times, 50) * 1e3),
            "p99_ms": float(np.percentile(times, 99) * 1e3),
            "images_per_sec": float(batch_size / np.median(times)),
            "compute_p50_ms": float(np.percentile(ctimes, 50) * 1e3),
            "compute_p99_ms": float(np.percentile(ctimes, 99) * 1e3),
            "compute_images_per_sec": float(batch_size / np.median(ctimes)),
            "pipelined_ms": float(pipelined * 1e3),
            "pipelined_images_per_sec": float(batch_size / pipelined),
        }

    def benchmark_sweep(self, batch_sizes: Optional[Sequence[int]] = None, iters: int = 50):
        """:meth:`benchmark` per batch size (default: every bucket); each row
        after the first carries ``pad_miss_vs_prev_ms`` and
        ``pad_miss_pipelined_ms``, what a request one image past the previous
        bucket pays for landing in this one."""
        sizes = sorted(batch_sizes or self.buckets)
        rows = [self.benchmark(b, iters) for b in sizes]
        for prev, row in zip(rows, rows[1:]):
            row["pad_miss_vs_prev_ms"] = round(row["compute_p50_ms"] - prev["compute_p50_ms"], 3)
            row["pad_miss_pipelined_ms"] = round(row["pipelined_ms"] - prev["pipelined_ms"], 3)
        return rows
