"""ServingModule: batched inference with bucket padding (counterpart of
nkbx's ``TPUServingModule``, ``nkbx/export/serving.py``), and
:class:`ExportedModel`, a bundle in ``ClassificationModel``'s shape.

A ServingModule is built from either

- a port :class:`~nkbx_torch.models.ClassificationModel`: a request's uint8
  NHWC batch is normalised to the model's compute dtype on the card and run
  through the model; or
- the path of a ``.nkbx`` bundle (:mod:`nkbx_torch.export.bundle`), as
  nkbx's ``TPUServingModule(weight)``: the request is the normalised NHWC
  batch, fed unchanged in the program's dtype, without a Normalize, as
  nkbx does. Its buckets come from the metadata's batch, or are the one
  batch of a ``dynamic="none"`` bundle.

Either way the batch is zero-padded up to the next bucket size, split into
chunks of the largest bucket when it is larger, and the logits are sliced
back. Keeping a few fixed batch shapes keeps the kernels' launch geometries
few and warmed up. nkbx's StableHLO bundles cannot be read without JAX.

    python -m nkbx_torch.export.serving BUNDLE [--batch-size N] [--iters N]
        [--sweep [B ...]] [--device cpu]

prints :meth:`ServingModule.benchmark` as one JSON line, or with ``--sweep``
one line per batch size (every bucket when none is given).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from nkbx_torch.export.bundle import load_exported
from nkbx_torch.train.engine import build_predict_fn
from nkbx_torch.transforms.spec import Compose, Normalize


def default_buckets(max_batch: int) -> list:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _program_input(program):
    """The fake tensor of an exported program's (one) user input."""
    name = program.graph_signature.user_inputs[0]
    return next(n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)


class ServingModule:
    """Serve a ClassificationModel, or a ``.nkbx`` bundle's program, on its
    device with bucket padding. ``device`` (default ``cuda``) is where a
    bundle is loaded; a model serves on its own device."""

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 warm_up_on_load: bool = True, device=None):
        if isinstance(model, (str, os.PathLike)):
            self._load_bundle(model, buckets, device)
        else:
            self.model, self.metadata, self.program, self.program_module = model, None, None, None
            self.classes = model.classes
            self.task = model.task
            self.device = model.device
            self.dtype = model.dtype
            self.imgsz = model.input_size
            self.buckets = sorted(buckets) if buckets else default_buckets(32)
            norm = Compose([Normalize()])
            self._predict = build_predict_fn(
                model, lambda b: norm.device_apply(b, out_dtype=model.dtype))
        if warm_up_on_load:
            self.warm_up()

    def _load_bundle(self, path, buckets, device):
        self.model = None
        self.metadata, self.program = load_exported(path, device)
        self.classes = self.metadata.get("classes")
        self.task = self.metadata.get("task", "single")
        spec = _program_input(self.program)
        self.device, self.dtype = spec.device, spec.dtype
        self.imgsz = tuple(self.metadata["imgsz"])
        dim0 = spec.shape[0]
        if isinstance(dim0, int):
            # a dynamic="none" bundle takes exactly one batch size: pad and chunk to it
            self.buckets = [dim0]
        else:
            max_batch = int(self.metadata.get("batch", 32)) or 32
            self.buckets = sorted(buckets) if buckets else default_buckets(max_batch)
        self.program_module = call = self.program.module()

        @torch.inference_mode()
        def predict(x):
            return call(x)

        self._predict = predict

    # -- core ---------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def forward(self, im):
        """Run an NHWC batch (numpy or tensor; one HWC image is a batch of
        one): uint8 for a model, the normalised batch for a bundle (cast to
        the program's dtype); returns logits on the device (a tensor, or
        {target: tensor})."""
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
        if self.program is not None:
            x = x.to(self.dtype)
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

    def _example(self, b: int, seed=None):
        """A host batch of ``b`` requests: zeros, or seeded random values
        (uint8 for a model, f32 in [0, 1) for a bundle, as nkbx's)."""
        h, w = self.imgsz
        if seed is None:
            return np.zeros((b, h, w, 3), dtype=np.uint8 if self.program is None else np.float32)
        rng = np.random.default_rng(seed)
        if self.program is None:
            return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        return rng.random((b, h, w, 3), dtype=np.float32)

    def warm_up(self, batches: Optional[Sequence[int]] = None):
        """Run every bucket once (first launches load the kernels)."""
        for b in batches or self.buckets:
            self.forward(self._example(b))
        self._sync()

    def benchmark(self, batch_size: int = 32, iters: int = 100):
        """p50/p99 latency and throughput for one batch size.

        ``p50_ms``/``p99_ms`` time the full ``forward`` from a host batch
        (copy in, normalise for a model, run, synchronise); ``compute_*``
        stage the batch on the device once and time the rest;
        ``pipelined_*`` run ``iters`` forwards back to back and synchronise
        once."""
        x = self._example(batch_size, seed=0)
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


class _ServingShim(nn.Module):
    """:class:`ExportedModel`'s ``module``: calls the serving path (bucket
    padding, the program's dtype) and holds the loaded program as its child,
    so that ``parameters()`` reaches the program's (``val_epoch`` takes its
    device from them). ``train()``/``eval()`` stop here: the loaded program
    raises on ``eval()``, and a bundle has no train mode."""

    def __init__(self, serving):
        super().__init__()
        self.program = serving.program_module
        self._serving = serving

    def train(self, mode: bool = True):
        self.training = mode
        return self

    def forward(self, x, mask=None):
        return self._serving.forward(x)


class ExportedModel:
    """A ``.nkbx`` bundle in the shape of a
    :class:`~nkbx_torch.models.ClassificationModel` (nkbx's
    ``ExportedModel``): ``module``, ``classes``, ``task``, ``dtype`` (the
    program's input dtype), ``device`` and ``input_size``, so that
    ``build_eval_step``, ``build_predict_fn`` and ``val_epoch`` take it
    unchanged; ``get_model``'s ``scripted: True`` returns one. Its module
    pads and chunks to the bundle's buckets as :class:`ServingModule` does."""

    def __init__(self, path, device=None):
        self.serving = ServingModule(path, warm_up_on_load=False, device=device)
        self.metadata = self.serving.metadata
        self.module = _ServingShim(self.serving)
        self.classes = self.serving.classes
        self.task = self.serving.task
        self.dtype = self.serving.dtype
        self.device = self.serving.device
        self.input_size = self.serving.imgsz

    def __call__(self, x):
        with torch.inference_mode():
            return self.module(x)


def main(argv=None):
    """The serving benchmark CLI (nkbx's ``serving.main``): one JSON line,
    or one a batch size with ``--sweep``."""
    import argparse
    import json

    parser = argparse.ArgumentParser(description="nkbx_torch serving benchmark")
    parser.add_argument("weights", help=".nkbx serving bundle")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--sweep", nargs="*", type=int, default=None,
                        help="benchmark a latency/throughput curve instead of one batch: "
                             "every bucket (bare --sweep) or the given batch sizes "
                             "(--sweep 1 8 32 128); one JSON line per row with pad-miss costs")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    module = ServingModule(args.weights, warm_up_on_load=False, device=args.device)
    if args.sweep is not None:
        for row in module.benchmark_sweep(args.sweep or None, args.iters):
            print(json.dumps(row))
    else:
        module.warm_up([args.batch_size])  # only the benchmarked bucket
        print(json.dumps(module.benchmark(args.batch_size, args.iters)))


if __name__ == "__main__":
    main()
