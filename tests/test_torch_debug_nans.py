"""``debug_nans`` in the port, on the CPU (nkbx's ``train.py`` turns on
``jax_debug_nans`` for it).

- The bare step (``resnet_tiny_test``, sgd at lr 1e30): without the option
  step 0's loss is finite and step 1's is not; with it, step 1 raises
  FloatingPointError naming step 1, before the parameters' update; with
  ``scan_steps=2`` the second of a call's two steps is named.
- With the option off the step never calls the check.
- ``python -m nkbx_torch.train --device cpu`` on a config whose loss turns
  non-finite: with ``debug_nans = True`` it raises; the same config without
  the key trains both epochs as before.
"""

import signal
import textwrap

import cv2
import numpy as np
import pytest
import torch

from nkbx_torch.models import get_model
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
from nkbx_torch.train import engine
from nkbx_torch.train.__main__ import main as cli_main
from nkbx_torch.transforms import Compose, Normalize

LR = 1e30


def _parts(debug_nans, scan_steps=1):
    model = get_model({"model": "resnet_tiny_test"}, list("abc"), input_size=(32, 32),
                      dtype=torch.float32, device="cpu")
    step = build_train_step(model, get_loss({"task": "single", "type": "CrossEntropyLoss"}),
                            get_optimizer({"type": "sgd", "lr": LR}),
                            augment_fn=Compose([Normalize()]).device_apply,
                            scan_steps=scan_steps, debug_nans=debug_nans)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    label = torch.from_numpy(rng.integers(0, 3, 4))
    return TrainState.create(model, seed=0), step, image, label, torch.ones(4, dtype=torch.bool)


def test_the_step_that_turns_non_finite_raises_by_name():
    state, step, image, label, mask = _parts(False)
    losses = []
    for _ in range(2):
        state, m = step(state, image, label, mask, 1.0, 1.0)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[0]) and not np.isfinite(losses[1])

    state, step, image, label, mask = _parts(True)
    state, _ = step(state, image, label, mask, 1.0, 1.0)
    before = {k: v.detach().clone() for k, v in state.module.named_parameters()}
    with pytest.raises(FloatingPointError, match="not finite at train step 1$"):
        step(state, image, label, mask, 1.0, 1.0)
    # the update was not applied (the forward's running statistics did move)
    after = dict(state.module.named_parameters())
    assert state.step == 1 and all(torch.equal(before[k], after[k]) for k in before)


def test_scan_steps_check_each_step():
    state, step, image, label, mask = _parts(True, scan_steps=2)
    with pytest.raises(FloatingPointError, match="train step 1$"):
        step(state, image[None].repeat(2, 1, 1, 1, 1), label[None].repeat(2, 1),
             mask[None].repeat(2, 1), 1.0, 1.0)
    assert state.step == 1


def test_off_the_step_never_checks(monkeypatch):
    def refuse(*a):
        raise AssertionError("check_finite called with debug_nans off")

    monkeypatch.setattr(engine, "check_finite", refuse)
    state, step, image, label, mask = _parts(False)
    for _ in range(2):
        state, _ = step(state, image, label, mask, 1.0, 1.0)
    assert state.step == 2


def _config(tmp_path, debug):
    rng = np.random.default_rng(2)
    for split, n in (("train", 4), ("val", 2)):
        for c in range(3):
            d = tmp_path / split / f"c{c}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                cv2.imwrite(str(d / f"{i}.png"), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    run = tmp_path / f"run_{debug}"
    config = tmp_path / f"config_{debug}.py"
    config.write_text(textwrap.dedent(f"""
        import nkbx.transforms as T

        task = "single"
        n_epochs = 2
        enable_mixed_precision = False
        train_data = {{"type": "ImageFolder", "root": "{tmp_path / 'train'}", "batch_size": 4,
                      "shuffle": True, "num_workers": 1}}
        val_data = {{"type": "ImageFolder", "root": "{tmp_path / 'val'}", "batch_size": 4}}
        train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.Normalize()])
        val_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.Normalize()])
        model = {{"task": "single", "model": "resnet_tiny_test"}}
        optimizer = {{"type": "sgd", "lr": {LR}}}
        criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
        experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
    """) + ("debug_nans = True\n" if debug else ""))
    return config, run


@pytest.mark.parametrize("debug", [True, False])
def test_train_cli_acts_on_debug_nans(debug, tmp_path):
    config, run = _config(tmp_path, debug)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        if debug:
            with pytest.raises(FloatingPointError, match="train step 1$"):
                cli_main(["-cfg", str(config), "--device", "cpu"])
        else:
            cli_main(["-cfg", str(config), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    metrics = run / "metrics.csv"
    assert metrics.exists() != debug
    if not debug:
        assert len(metrics.read_text().splitlines()) == 3  # a header and two epochs
