"""The port's benchmark, ``python -m nkbx_torch.bench`` (bench.py's
counterpart), on the CPU.

- Against nkbx: bench.py's program (bench.py:52-86) at ``resnet_tiny_test``,
  32 px, batch 8, 10 classes, K = 2 steps a call, f32, built by
  :func:`nkbx_torch.bench.build_program` with nkbx's initial weights
  carried by ``from_jax_variables``, and by nkbx's own public functions as
  bench.py builds it; the flips fixed by p = 0 and p = 1. The K losses
  agree within 1e-5 relative, the parameters and running statistics after
  the call within 1e-4.
- The line: ``main(device="cpu")`` at that size prints exactly one line
  with bench.py's keys and the device's name and power limit,
  ``vs_baseline`` within 0.001 of value / 2500.
- No card: the CLI on a host without one prints the error line (``value``
  null, the missing card named) and exits 1; it never measures on the CPU
  unasked.
- The deadline: ``NKBX_BENCH_WATCHDOG_S=1`` gives the deadline's error line
  and exit 1, and no process of the child's is left.
"""

import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nkbx.transforms as JT
from nkbx.models import get_model as jget_model
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx_torch import bench
from nkbx_torch.models import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
SIZES = dict(model="resnet_tiny_test", size=32, batch_size=8, n_classes=10, scan_steps=2,
             dtype=torch.float32)
KEYS = {"metric", "value", "unit", "vs_baseline", "device", "power_limit_w"}


def _nkbx_call(flip_p):
    """(initial variables, the K losses, the variables after one call) of
    bench.py's program in nkbx at SIZES."""
    k, b, size, n = SIZES["scan_steps"], SIZES["batch_size"], SIZES["size"], SIZES["n_classes"]
    model = jget_model({"task": "single", "model": SIZES["model"], "pretrained": False},
                       classes=[f"c{i}" for i in range(n)], input_size=(size, size),
                       dtype=jnp.float32)
    initial = jax.device_get(model.variables)
    pipeline = JT.Compose([JT.HorizontalFlip(p=flip_p),
                           JT.Normalize(mean=bench.IMAGENET_MEAN, std=bench.IMAGENET_STD)])
    criterion = jget_loss({"task": "single", "type": "CrossEntropyLoss"})
    bundle = jget_optimizer(model.params, {"type": "sgd", "lr": 0.1})
    step = jbuild_train_step(model, criterion, bundle, augment_fn=pipeline.device_apply,
                             scan_steps=k)
    state = JState.create(model.params, model.batch_stats, bundle.tx)
    r = np.random.default_rng(0)
    image = jnp.asarray(np.broadcast_to(
        r.integers(0, 255, (b, size, size, 3)).astype(np.uint8), (k, b, size, size, 3)).copy())
    label = jnp.asarray(np.broadcast_to(r.integers(0, n, (b,)).astype(np.int64), (k, b)).copy())
    one = jnp.asarray(1.0)
    state, metrics = step(state, image, label, jnp.ones((k, b), bool), jax.random.PRNGKey(0),
                          one, one)
    after = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return initial, np.asarray(metrics["loss"]), after


@pytest.mark.parametrize("flip_p", [0.0, 1.0])
def test_program_matches_nkbx_bench_program(flip_p):
    initial, want_losses, after = _nkbx_call(flip_p)
    program = bench.build_program(device="cpu", flip_p=flip_p, **SIZES)
    module = program.model.module
    module.load_state_dict(from_jax_variables(initial, reference=module))
    assert program.image.shape == (2, 8, 32, 32, 3) and program.label.dtype == torch.int64
    losses = program.call()["loss"].numpy()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = from_jax_variables(after, reference=module)
    got = module.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)
    assert program.state.step == 2


def test_main_prints_one_line(capsys):
    line = bench.main(device="cpu", **SIZES)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == KEYS
    assert line["metric"] == bench.METRIC and line["unit"] == "images/sec/chip"
    assert line["value"] > 0 and abs(line["vs_baseline"] - line["value"] / 2500) <= 1e-3
    assert line["device"] == "cpu" and line["power_limit_w"] is None


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "nkbx_torch.bench", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_without_a_card_it_prints_the_error_line_and_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _cli()
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["error"].startswith("no CUDA card available"), line
    assert "device='cpu'" in line["error"]  # the child's own error, its stderr tail


def _tagged_pids(tag):
    """Processes whose environment holds ``tag``."""
    found = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if tag.encode() in (d / "environ").read_bytes():
                    found.append(int(d.name))
            except OSError:
                pass
    return found


def test_the_deadline_kills_the_child():
    tag = f"nkbx-bench-{uuid.uuid4().hex}"
    t0 = time.perf_counter()
    proc = _cli("--device", "cpu", env={"NKBX_BENCH_WATCHDOG_S": "1", "NKBX_BENCH_TEST_TAG": tag})
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and "watchdog deadline (1 s)" in line["error"], line
    assert time.perf_counter() - t0 < 60
    assert _tagged_pids(tag) == []
