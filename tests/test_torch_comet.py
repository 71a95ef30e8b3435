"""Comet ML logging in the port (A5's rest) against nkbx's, on the CPU.

A recording fake ``comet_ml`` module (put into ``sys.modules``) stands for the
package, which neither this machine nor the card's has. Each side gets its
own fake; their call lists must be equal: method names and order, positional
and keyword arguments, floats within 1e-6 (NaN equal to NaN), image grids byte
for byte.

- ``TrainLogger.log_epoch`` of nkbx and of the port on the same epoch
  results (made by the port's EpochCollector and compute_metrics from seeded
  steps): single-task and multi-task, exact and bounded, with and without
  gradient norms, ``show_all_classes_in_confusion_matrix`` on and off.
- ``get_comet_experiment``: the constructor's keyword arguments and
  ``set_name`` from one side YAML (also through the port's flat YAML reader
  where PyYAML is missing); without ``comet_ml``, nkbx's warning and None.
- The train CLI (2 epochs of ``resnet_tiny_test``, gradient norms logged)
  with the fake: the experiment, ``log_code`` of the config, the classifier
  and the backbone, and each epoch's calls equal to nkbx's ``log_epoch`` on
  the results the port's trainer logged; ``metrics.csv`` equal to the run
  without a Comet section but for the throughput column (a clock reading).
"""

import copy
import signal
import sys
import types
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nkbx.logging.experiment import LocalExperiment as JLocalExperiment
from nkbx.logging.experiment import TrainLogger as JTrainLogger
from nkbx.logging.experiment import get_comet_experiment as jget_comet_experiment
from nkbx_torch.logging import experiment as E
from nkbx_torch.metrics import compute_metrics
from nkbx_torch.train.engine import EpochCollector

ROOT = Path(__file__).resolve().parents[1]
CLASSES = {"single": ["cat", "dog", "eel"],
           "multi": {"color": ["red", "green", "blue", "black"], "size": ["s", "l"]}}
TOL = 1e-6
NO_COMET = "comet_ml is not installed; continuing with local logging only"


def fake_comet_ml():
    """A ``comet_ml`` module whose ``Experiment`` records every call, in
    order, in the module's ``calls``: (name, args, kwargs)."""
    mod = types.ModuleType("comet_ml")
    mod.calls = []

    class Experiment:
        def __init__(self, **kwargs):
            mod.calls.append(("Experiment", (), dict(kwargs)))

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            return lambda *args, **kwargs: mod.calls.append((name, args, dict(kwargs)))

    mod.Experiment = Experiment
    return mod


def assert_same(got, want, where="call"):
    """``got`` equal to ``want``: containers of the same kind and keys (in
    order), integers and strings exact, floats within TOL, uint8 arrays (the
    grids) byte for byte."""
    if isinstance(want, np.ndarray) and want.dtype == np.uint8:
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8, where
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), where
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype.kind == want.dtype.kind, where
        assert got.shape == want.shape, where
        assert_same(got.tolist(), want.tolist(), where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (bool, np.bool_, str)) or want is None:
        assert got == want, (where, got, want)
    elif isinstance(want, (int, np.integer)):
        assert isinstance(got, (int, np.integer)) and got == want, (where, got, want)
    else:
        w, g = float(want), float(got)
        assert (np.isnan(w) and np.isnan(g)) or abs(g - w) <= TOL * max(1.0, abs(w)), (
            where, got, want)


def assert_same_calls(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g[1:], w[1:], f"call {i} {w[0]}")


def _epoch_results(task, mode, grads, rng, cfg):
    """One fold's epoch results from 3 seeded steps of 6 rows (2 padded in
    the last) through the port's EpochCollector, with their metrics."""
    collector = EpochCollector(task, mode)
    classes = CLASSES[task]
    for i in range(3):
        mask = torch.ones(6, dtype=torch.bool)
        if i == 2:
            mask[-2:] = False

        def head(n):
            logits = torch.from_numpy(rng.normal(size=(6, n)).astype(np.float32))
            return {"confidences": torch.softmax(logits, -1), "predictions": logits.argmax(-1),
                    "ground_truth": torch.from_numpy(rng.integers(0, n, 6)),
                    "loss": torch.tensor(float(rng.random()), dtype=torch.float32)}

        if task == "multi":
            m = {t: head(len(classes[t])) for t in sorted(classes)}
            m["loss"] = sum(m[t]["loss"] for t in sorted(classes))
        else:
            m = head(len(classes))
        m["mask"] = mask
        if grads:
            m["grad_norms"] = {k: torch.tensor(float(rng.random()), dtype=torch.float32)
                               for k in ("backbone/Conv_0/kernel", "head/bias", "head/kernel")}
        collector.log_iter(m)
        collector.log_images_if_needed(rng.integers(0, 256, (5, 8, 6, 3), dtype=np.uint8))
    results = collector.get_epoch_results()
    results["metrics"] = compute_metrics(cfg, results)
    return results


CASES = {  # task, metrics mode, gradient norms, show_all_classes_in_confusion_matrix
    "single": ("single", "exact", False, False),
    "single_grads_show_all": ("single", "exact", True, True),
    "multi_show_all": ("multi", "exact", False, True),
    "multi_grads": ("multi", "exact", True, False),
    "bounded_grads": ("single", "bounded", True, False),
    "bounded_multi_show_all": ("multi", "bounded", False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_epoch_sends_nkbx_calls(case, tmp_path):
    task, mode, grads, show_all = CASES[case]
    classes = CLASSES[task]
    cfg = SimpleNamespace(task=task, log_gradients=grads,
                          show_all_classes_in_confusion_matrix=show_all,
                          target_names=sorted(classes) if task == "multi" else None)
    rng = np.random.default_rng(sorted(CASES).index(case))
    train = _epoch_results(task, mode, grads, rng, cfg)
    val = _epoch_results(task, mode, False, rng, cfg)
    sides = {}
    for side, logger_cls, local in (("nkbx", JTrainLogger, JLocalExperiment),
                                    ("port", E.TrainLogger, E.LocalExperiment)):
        fake = fake_comet_ml()
        (tmp_path / side).mkdir()
        logger = logger_cls(cfg, fake.Experiment(), local(tmp_path / side), classes)
        for epoch in (0, 1):
            logger.log_epoch(epoch, train, val)
        sides[side] = fake.calls[1:]
    assert_same_calls(sides["port"], sides["nkbx"])
    names = [c[0] for c in sides["port"]]
    assert names.count("log_image") == 4 and names.count("log_confusion_matrix") == (
        2 * (len(classes) if task == "multi" else 1))
    grad_calls = [c for c in sides["port"]
                  if c[0] == "log_metric" and c[1][0].startswith("Gradients/")]
    assert len(grad_calls) == (2 * 4 if grads else 0)  # 3 parameters and the total
    caps = {c[2]["max_categories"] for c in sides["port"] if c[0] == "log_confusion_matrix"}
    assert caps == ({len(v) for v in classes.values()} if show_all and task == "multi"
                    else {len(classes)} if show_all else {E.CONFUSION_MAX_CATEGORIES})
    # the port's local outputs: the metrics of both folds, and the Gradients columns
    header = (tmp_path / "port" / "metrics.csv").read_text().splitlines()[0].split("\t")
    assert header[0] == "Epoch" and "train loss" in header and "Val loss" in header
    assert any(h.startswith("Gradients/") for h in header) == grads


def test_log_grads_logs_nan_means_and_returns_an_empty_series_log():
    fake = fake_comet_ml()
    out = E.log_grads(fake.Experiment(), 3, {"Gradients/a": [1.0, np.nan, 3.0]})
    assert out == {} and out["x"] == []  # nkbx's defaultdict(list)
    assert fake.calls[1:] == [("log_metric", ("Gradients/a", 2.0), {"epoch": 3, "step": 3})]


def _side_yaml(tmp_path):
    path = tmp_path / "comet_api_cfg.yml"
    path.write_text("# Comet's credentials\napi_key: abc123\nworkspace: team\n"
                    "project_name: nkbx-runs\nunused: 1\n")
    return path


def test_get_comet_experiment_builds_nkbx_experiment(tmp_path, monkeypatch):
    section = {"comet_api_cfg_path": str(_side_yaml(tmp_path)), "auto_metric_logging": False,
               "name": "train_singletask_run_1"}
    before = dict(section)
    calls = {}
    for side, fn in (("nkbx", jget_comet_experiment), ("port", E.get_comet_experiment)):
        fake = fake_comet_ml()
        monkeypatch.setitem(sys.modules, "comet_ml", fake)
        assert isinstance(fn(section), fake.Experiment)
        calls[side] = fake.calls
    assert section == before  # the config's section is left as it was
    assert_same_calls(calls["port"], calls["nkbx"])
    assert calls["port"] == [
        ("Experiment", (), {"auto_metric_logging": False, "api_key": "abc123",
                            "workspace": "team", "project_name": "nkbx-runs"}),
        ("set_name", ("train_singletask_run_1",), {})]
    # without PyYAML the port reads the side YAML with its flat reader
    fake = fake_comet_ml()
    monkeypatch.setitem(sys.modules, "comet_ml", fake)
    monkeypatch.setitem(sys.modules, "yaml", None)
    E.get_comet_experiment(section)
    assert fake.calls == calls["nkbx"]


def test_get_comet_experiment_without_comet_ml(monkeypatch):
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # the import raises ImportError
    for fn in (jget_comet_experiment, E.get_comet_experiment):
        assert fn(None) is None
        with pytest.warns(UserWarning) as record:
            assert fn({"comet_api_cfg_path": "absent.yml", "name": "x"}) is None
        assert [str(w.message) for w in record] == [NO_COMET]


def _train_cli(cfg_path):
    from nkbx_torch.train.__main__ import main

    handler = signal.getsignal(signal.SIGTERM)
    try:
        main(["-cfg", str(cfg_path), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)


def _csv_without_clock(path):
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    keep = [i for i, name in enumerate(rows[0]) if name != "train images/sec/chip"]
    return [[r[i] for i in keep] for r in rows]


def test_train_cli_logs_to_comet(tmp_path, monkeypatch):
    from test_torch_dist_cli import _config, _folder

    data = _folder(tmp_path / "data", n_train=5, n_val=3)
    section = {"comet_api_cfg_path": str(_side_yaml(tmp_path)), "name": "cli"}
    for name, comet in (("plain", None), ("comet", section)):
        (tmp_path / f"{name}.py").write_text(
            _config(data, tmp_path / name, False, extra="log_gradients = True\n", comet=comet))
    _train_cli(tmp_path / "plain.py")
    logged = []
    log_epoch = E.TrainLogger.log_epoch

    def spy(self, epoch, train_results, val_results):
        logged.append(copy.deepcopy((epoch, train_results, val_results)))
        return log_epoch(self, epoch, train_results, val_results)

    monkeypatch.setattr(E.TrainLogger, "log_epoch", spy)
    fake = fake_comet_ml()
    monkeypatch.setitem(sys.modules, "comet_ml", fake)
    _train_cli(tmp_path / "comet.py")

    assert fake.calls[:2] == [
        ("Experiment", (), {"api_key": "abc123", "workspace": "team",
                            "project_name": "nkbx-runs"}),
        ("set_name", ("cli",), {})]
    assert [c[0] for c in fake.calls[2:5]] == ["log_code"] * 3
    assert [Path(c[1][0]).resolve() for c in fake.calls[2:5]] == [
        (tmp_path / "comet.py").resolve(), ROOT / "nkbx_torch/models/classifier.py",
        ROOT / "nkbx_torch/models/resnet.py"]
    # each epoch's calls are those of nkbx's log_epoch on the results the trainer logged
    assert [e for e, _, _ in logged] == [0, 1]
    cfg = SimpleNamespace(task="single", log_gradients=True)
    jfake = fake_comet_ml()
    (tmp_path / "nkbx_local").mkdir()
    jlogger = JTrainLogger(cfg, jfake.Experiment(), JLocalExperiment(tmp_path / "nkbx_local"),
                           ["c0", "c1", "c2"])
    for epoch, train, val in logged:
        jlogger.log_epoch(epoch, train, val)
    assert_same_calls(fake.calls[5:], jfake.calls[1:])
    assert sum(c[0] == "log_image" for c in fake.calls) == 4
    assert any(c[0] == "log_metric" and c[1][0] == "Gradients/Total" for c in fake.calls)
    # the local outputs are those of the run without Comet
    for f in ("classes.json",):
        assert (tmp_path / "comet" / f).read_text() == (tmp_path / "plain" / f).read_text()
    got, want = (_csv_without_clock(tmp_path / d / "metrics.csv") for d in ("comet", "plain"))
    assert got == want and len(want) == 3 and any(h.startswith("Gradients/") for h in want[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the fake imports: no warning
        E.get_comet_experiment(section)
