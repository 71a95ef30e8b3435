"""Readings that set the limits of ``correct``, at a cell's own size on the
card: the control (the reference computed in float8 e4m3, the step below
the configuration's bf16, in the program's place) and, for a training
cell, the half-batch fault (the reference on the first half of each batch,
the mean over those rows), each against the float32 reference.

    python3 -m h100_bench.calibrate --workload <name> --seeds 1 2 3

prints one JSON line a seed with each number and, under ``fails_limits``,
whether the cell's limits fail it. A serving cell's sample is drawn from
the requests of a window of ``BENCHMARK.json``'s ``run_seconds``, as the
benchmark's own runs draw it. A state left unchanged reads 1 on the
training numbers by their definition and needs no run. The program's own
readings come from the benchmark's runs (their ``checks``).
"""

from __future__ import annotations

import argparse
import json
import sys


def train_readings(cell, seed: int, device) -> dict:
    from h100_bench import checks, weights
    from h100_bench.drivers.train import reference

    mix, cfg = cell.mix, cell.config
    b, size, n = mix["batch"], cfg["image_size"], mix["checked_steps"]
    images = weights.uint8_images(mix["pool_batches"] * b, size, seed, device).view(
        mix["pool_batches"], b, size, size, 3)
    labels = weights.labels(mix["pool_batches"] * b, cfg["num_classes"], seed, device).view(
        mix["pool_batches"], b)
    images, labels = images[:n], labels[:n]
    ref = reference(cell, seed, device, images, labels, "f32")
    out = {"control": checks.train_numbers(reference(cell, seed, device, images, labels, "fp8"),
                                           ref),
           "half_batch": checks.train_numbers(
               reference(cell, seed, device, images, labels, "f32", rows=slice(0, b // 2)), ref)}
    return out


def serve_readings(cell, seed: int, device) -> dict:
    from h100_bench import checks, spec, weights
    from h100_bench.drivers.serve import reference, sample, schedule

    mix, seconds = cell.mix, spec.benchmark()["run_seconds"]
    pool = weights.uint8_images(mix["pool_images"], cell.config["image_size"], seed,
                                device).cpu().numpy()
    reqs = schedule(mix, seed, max(1, int(seconds * mix["rate_rps"])))
    picked = [reqs[i] for i in sorted(sample(mix, seed, reqs))]
    ref = reference(cell, seed, device, pool, picked, "f32")
    return {"control": {"logit_gap": checks.logit_gap(
        reference(cell, seed, device, pool, picked, "fp8"), ref)}}


def readings(cell, seed: int, device) -> dict:
    from h100_bench import checks

    got = (train_readings(cell, seed, device) if cell.mix["kind"] == "train"
           else serve_readings(cell, seed, device))
    for numbers in got.values():
        numbers["fails_limits"] = not checks.verdict(numbers, cell.limits)[0]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from h100_bench import spec

    cell = spec.cell(args.workload)
    for seed in args.seeds:
        line = {"workload": cell.name, "seed": seed,
                **readings(cell, seed, torch.device("cuda:0"))}
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
