"""The headline benchmark of the port (the counterpart of ``bench.py``):
ResNet-50 training throughput at 224 px in bf16 on one CUDA card, device
augment included, as one JSON line.

    python -m nkbx_torch.bench [--device cpu]

The program is bench.py's: ``resnet50`` with random weights (seed 0), 1000
classes, exact BatchNorm, HorizontalFlip(p=0.5) + Normalize on the device,
cross-entropy, sgd at lr 0.1, batch 128, and K train steps a call
(``scan_steps``; ``NKBX_BENCH_K``, default 10) over one seeded uint8 batch
repeated K times with every row valid. Two warm-up calls, each followed by a
read of its last loss, then 4 calls behind one such read:
``value = 128 / (t / (4·K))`` images a second.

The line holds bench.py's keys, ``metric``, ``value`` (img/s, 1 decimal),
``unit`` and ``vs_baseline`` (value over :data:`A100_TORCH_AMP_RESNET50_IPS`),
and the card's ``device`` name and ``power_limit_w`` (from ``nvidia-smi``
where it is on PATH, else null): a card's number carries the card.

The parent process is a watchdog: it runs the measurement in a child
(``--child``, its own session) and always prints exactly one line. A child
that exits without its line gives a line with ``value`` null and an
``error`` that a subprocess probe of the card makes precise ("no CUDA card
available" or the child's exit code, then the child's last stderr line). At
the deadline (``NKBX_BENCH_WATCHDOG_S``, default 210 s) the child's whole
process group is killed, so that nothing is left holding the card. A line
whose ``value`` is null exits with 1. The measurement runs on the card; the
CPU only with ``--device cpu``.

:func:`build_program` takes bench.py's sizes as keyword defaults, so that a
test can run the same program at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

# img/s: public torch AMP ResNet-50 @224 training figures on one A100 (NVIDIA
# DeepLearningExamples ConvNets, ResNet-50 v1.5 AMP on a DGX-A100 GPU: ~2,200-2,500;
# MLPerf Training ResNet-50 A100 submissions: ~2,500-2,800 a GPU), their midpoint
A100_TORCH_AMP_RESNET50_IPS = 2500.0
METRIC = "train images/sec/chip (ResNet-50 @224, bf16, incl. on-device augment)"
UNIT = "images/sec/chip"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TIMED_CALLS = 4
WARMUP_CALLS = 2
BENCH_K = 10  # train steps a call unless NKBX_BENCH_K says otherwise (bench.py's)


@dataclasses.dataclass
class Program:
    """What :func:`build_program` makes: the model, the device pipeline, the
    loss, the optimizer, the train step and its state, and the inputs of a
    call: (K, B, ...) image, label and mask for K > 1 steps a call, else
    (B, ...)."""

    model: object
    pipeline: object
    criterion: object
    bundle: object
    step: object
    state: object
    image: object
    label: object
    mask: object
    batch_size: int
    scan_steps: int

    def call(self):
        """One call of the step on the program's inputs (K steps)."""
        self.state, metrics = self.step(self.state, self.image, self.label, self.mask,
                                        1.0, 1.0)
        return metrics


def build_program(model: str = "resnet50", n_classes: int = 1000, size: int = 224,
                  batch_size: int = 128, dtype=None, scan_steps: int | None = None,
                  device=None, flip_p: float = 0.5) -> Program:
    """bench.py's program (bench.py:52-86) through the port, at its sizes by
    default: ``dtype`` None is bf16, ``scan_steps`` None is ``NKBX_BENCH_K``
    or 10, ``device`` None is the card (raising where there is none). The
    weights and the train state's generator come from seed 0, the inputs
    from ``numpy.random.default_rng(0)``, as bench.py draws them."""
    import numpy as np
    import torch

    from nkbx_torch.core.runtime import resolve_device
    from nkbx_torch.models import get_model
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    dev = resolve_device(device)
    k = int(os.environ.get("NKBX_BENCH_K") or BENCH_K) if scan_steps is None else int(scan_steps)
    net = get_model({"task": "single", "model": model, "pretrained": False},
                    [f"c{i}" for i in range(n_classes)], input_size=(size, size), seed=0,
                    dtype=torch.bfloat16 if dtype is None else dtype, device=dev)
    pipeline = Compose([HorizontalFlip(p=flip_p),
                        Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)])
    criterion = get_loss({"task": "single", "type": "CrossEntropyLoss"})
    bundle = get_optimizer({"type": "sgd", "lr": 0.1})
    step = build_train_step(net, criterion, bundle, augment_fn=pipeline.device_apply,
                            scan_steps=k)
    state = TrainState.create(net, seed=0)
    r = np.random.default_rng(0)
    image = r.integers(0, 255, (batch_size, size, size, 3)).astype(np.uint8)
    label = r.integers(0, n_classes, (batch_size,)).astype(np.int64)
    if k > 1:
        image = np.broadcast_to(image, (k,) + image.shape).copy()
        label = np.broadcast_to(label, (k, batch_size)).copy()
    return Program(net, pipeline, criterion, bundle, step, state,
                   torch.from_numpy(image).to(dev), torch.from_numpy(label).to(dev),
                   torch.ones(label.shape, dtype=torch.bool, device=dev), batch_size, k)


def _last_loss(metrics) -> float:
    """The call's last loss on the host: a read that waits for every step
    of the call (each depends on the one before through the state)."""
    return float(metrics["loss"].reshape(-1)[-1])


def measure(program: Program) -> float:
    """Images a second of ``program``: WARMUP_CALLS calls, each read back,
    then TIMED_CALLS calls behind one read."""
    for _ in range(WARMUP_CALLS):
        _last_loss(program.call())
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        metrics = program.call()
    _last_loss(metrics)
    dt = (time.perf_counter() - t0) / (TIMED_CALLS * program.scan_steps)
    return program.batch_size / dt


def power_limit_w(index: int = 0):
    """The card's power limit in W from ``nvidia-smi``; None where it
    cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def result_line(ips: float, device) -> dict:
    """bench.py's four keys and the device's name and power limit."""
    import torch

    dev = torch.device(device)
    line = {"metric": METRIC, "value": round(ips, 1), "unit": UNIT,
            "vs_baseline": round(ips / A100_TORCH_AMP_RESNET50_IPS, 3),
            "device": dev.type, "power_limit_w": None}
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        line.update(device=torch.cuda.get_device_name(index), power_limit_w=power_limit_w(index))
    return line


def main(device=None, **sizes) -> dict:
    """Build the program (``sizes``: :func:`build_program`'s keywords),
    measure it and print its one line; returns the line."""
    program = build_program(device=device, **sizes)
    line = result_line(measure(program), program.model.device)
    print(json.dumps(line), flush=True)
    return line


def error_line(error: str) -> dict:
    return {"metric": METRIC, "value": None, "unit": UNIT, "vs_baseline": None, "error": error}


def _card_alive(timeout_s: float) -> bool:
    """Whether a fresh process finds a CUDA card and runs one op on it."""
    code = ("import torch; assert torch.cuda.is_available(); "
            "print(float(torch.ones(4, device='cuda').sum()))")
    try:
        return subprocess.run([sys.executable, "-c", code], capture_output=True,
                              timeout=timeout_s).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def watchdog(device=None) -> int:
    """Run :func:`main` in a child with a deadline; print exactly one line
    and return the exit code (1 where ``value`` is null)."""
    deadline_s = float(os.environ.get("NKBX_BENCH_WATCHDOG_S", "210"))
    probe_s = float(os.environ.get("NKBX_BENCH_PROBE_TIMEOUT_S", "90"))
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "nkbx_torch.bench", "--child"]
    if device is not None:
        cmd += ["--device", str(device)]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)  # the child leads its own process group
        except ProcessLookupError:  # it ended at the deadline
            pass
        p.communicate()
        line = error_line(f"measurement exceeded the watchdog deadline ({deadline_s:g} s); "
                          "the child's process group was killed")
    else:
        line = next((json.loads(s) for s in reversed(out.splitlines()) if s.startswith("{")),
                    None)
        if line is None:
            on_card = device is None or str(device).startswith("cuda")
            cause = ("no CUDA card available" if on_card and not _card_alive(probe_s)
                     else f"measurement child exited rc={p.returncode} without a JSON line")
            tail = err.strip().splitlines()
            line = error_line(cause + (f" (stderr tail: {tail[-1][:200]})" if tail else ""))
    print(json.dumps(line), flush=True)
    return 0 if line.get("value") is not None else 1


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu: the CPU only when asked")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        main(device=args.device)
        return 0
    return watchdog(args.device)


if __name__ == "__main__":
    sys.exit(cli())
