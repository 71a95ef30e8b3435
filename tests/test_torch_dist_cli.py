"""The port's CLIs over ranks (A10): the trainer, preemption, eval and
inference, 2 gloo ranks on the CPU against one process.

- The trainer: ``python -m torch.distributed.run --standalone
  --nproc_per_node=2 -m nkbx_torch.train -cfg CONFIG --device cpu`` against
  ``python -m nkbx_torch.train`` on the same config (sgd, a flip on the
  device, a padded last batch, 2 epochs, a frozen first epoch): ``classes.json``
  equal, every ``metrics.csv`` value within 1e-5 relative but the throughput
  column (a clock reading), ``best.pt`` and ``last.pt`` within 1e-5 of each
  tensor's largest value. The 2-rank run has a Comet section and a recording
  fake ``comet_ml`` on its path: rank 0 alone builds the experiment and logs
  to it.
- Preemption: 2 ranks running :func:`nkbx_torch.train.trainer.train` (this
  file as a script); a SIGTERM to rank 1 alone while it reads batch 2 of
  epoch 1 stops both ranks at the same agreed batch (``preempt_sync_every =
  2``); ``--resume`` from that checkpoint ends bit-equal to the
  uninterrupted 2-rank run. A cursor written by 2 ranks replays its epoch,
  with nkbx's warning, in a world of 1.
- Eval and inference: the CLIs with ``mesh = {"data": 2}`` under torchrun
  write the ``metrics.json`` (numbers within 1e-5 relative, integers exact)
  and the predictions CSV (exact) of the CLIs in one process; a rank of the
  last batch holds only padding.
- Refusals of the runtime: torchrun's environment missing, ``LOCAL_RANK``
  past the node's cards, a mesh of another size than the world, several
  ranks of eval without a mesh.
"""

import csv
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


def _folder(root, n_train=7, n_val=4, classes=3, seed=0):
    from nkbx_torch.logging.experiment import write_png

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = int(rng.integers(24, 60)), int(rng.integers(24, 60))
                img = rng.integers(0, 256, (h, w, 3)).astype(np.int32) + 50 * (c - 1)
                write_png(d / f"{i}.png", np.clip(img, 0, 255).astype(np.uint8))
    return root


def _config(data, run, distributed, extra="", comet=None):
    return textwrap.dedent(f"""
        import nkbx.transforms as T

        task = "single"
        n_epochs = 2
        seed = 0
        enable_mixed_precision = False
        distributed = {distributed}
        train_data = {{"type": "ImageFolder", "root": "{data / 'train'}", "batch_size": 8,
                      "shuffle": True, "num_workers": 2}}
        val_data = {{"type": "ImageFolder", "root": "{data / 'val'}", "batch_size": 8}}
        train_pipeline = T.Compose([T.LongestMaxSize({SIZE}), T.PadIfNeeded({SIZE}, {SIZE}),
                                    T.HorizontalFlip(), T.Normalize()])
        val_pipeline = T.Compose([T.LongestMaxSize({SIZE}), T.PadIfNeeded({SIZE}, {SIZE}),
                                  T.Normalize()])
        model = {{"task": "single", "model": "resnet_tiny_test"}}
        optimizer = {{"type": "sgd", "backbone_lr": 0.05, "classifier_lr": 0.05}}
        lr_policy = {{"type": "cosine", "n_epochs": 2}}
        backbone_state_policy = {{0: "freeze", 1: "unfreeze"}}
        criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
        experiment = {{"comet": {comet!r}, "local": {{"path": "{run}"}}}}
    """) + textwrap.dedent(extra)


def _env(paths=(), **extra):
    """The environment of a subprocess: ``paths`` first on PYTHONPATH, then the
    repository; ``extra`` variables set."""
    path = [str(p) for p in paths] + [str(ROOT), os.environ.get("PYTHONPATH", "")]
    return dict(os.environ, OMP_NUM_THREADS="1", **extra, PYTHONPATH=os.pathsep.join(path))


def _run(args, timeout=240, **env):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:{proc.stdout[-3000:]}\nSTDERR:{proc.stderr[-6000:]}"
    return proc


def _torchrun(module, config, n=2, **env):
    return _run(["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={n}",
                 "-m", module, "-cfg", str(config), "--device", "cpu"], **env)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _close_tensors(got, want, rel=1e-5):
    assert got.keys() == want.keys()
    for k in want:
        w = want[k].double()
        err = (got[k].double() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err <= rel, (k, err)


# a recording stand-in for the comet_ml package: each call of an Experiment,
# as a JSON line [method, the first positional argument where it is a string,
# the keyword names], in $FAKE_COMET_DIR/rank$RANK.jsonl
FAKE_COMET = """
import json, os


class Experiment:
    def __init__(self, **kwargs):
        self._record("Experiment", (), kwargs)

    def _record(self, name, args, kwargs):
        path = os.path.join(os.environ["FAKE_COMET_DIR"], f"rank{os.environ['RANK']}.jsonl")
        first = args[0] if args and isinstance(args[0], str) else None
        with open(path, "a") as f:
            f.write(json.dumps([name, first, sorted(kwargs)]) + "\\n")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args, **kwargs: self._record(name, args, kwargs)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The trainer CLI's run dirs: one process and 2 ranks (the latter with
    a Comet section, through the recording fake)."""
    tmp = tmp_path_factory.mktemp("dist_cli")
    data = _folder(tmp / "data")
    out = {"data": data, "tmp": tmp, "comet": tmp / "comet_calls"}
    (tmp / "fake" / "comet_ml").mkdir(parents=True)
    (tmp / "fake" / "comet_ml" / "__init__.py").write_text(FAKE_COMET)
    (tmp / "comet_api.yml").write_text("api_key: k\nworkspace: w\nproject_name: p\n")
    out["comet"].mkdir()
    for name, n in (("one", 1), ("two", 2)):
        cfg = tmp / f"{name}.py"
        comet = ({"comet_api_cfg_path": str(tmp / "comet_api.yml"), "name": "two"}
                 if n > 1 else None)
        cfg.write_text(_config(data, tmp / name, n > 1, comet=comet))
        if n == 1:
            _run(["-m", "nkbx_torch.train", "-cfg", str(cfg), "--device", "cpu"])
        else:
            proc = _torchrun("nkbx_torch.train", cfg, paths=[tmp / "fake"],
                             FAKE_COMET_DIR=str(out["comet"]))
            out["log"] = proc.stdout + proc.stderr
        out[name] = tmp / name
    return out


def test_trainer_world_of_two_equals_world_of_one(runs):
    one, two = runs["one"], runs["two"]
    assert "backend gloo" in runs["log"] and "rank 1 of 2" in runs["log"]
    assert (one / "classes.json").read_text() == (two / "classes.json").read_text()
    a, b = _read_csv(one / "metrics.csv"), _read_csv(two / "metrics.csv")
    assert a[0] == b[0] and len(a) == len(b) == 3  # header and 2 epochs
    for col, name in enumerate(a[0]):
        if name == "train images/sec/chip":  # a clock reading
            continue
        for ra, rb in zip(a[1:], b[1:]):
            x, y = float(ra[col]), float(rb[col])
            assert abs(y - x) <= 1e-5 * max(abs(x), 1e-30), (name, x, y)
    for f in ("best.pt", "last.pt"):
        _close_tensors(torch.load(two / "weights" / f), torch.load(one / "weights" / f))
    for d in ("best", "last"):  # one checkpoint, written by rank 0
        assert (two / "weights" / d / "train_state.pt").is_file()
    assert not list(two.parent.glob("two[0-9]*"))  # no second run directory


def test_trainer_world_of_two_logs_to_comet_on_rank_0_only(runs):
    """Rank 0 builds the experiment, names it, logs the config's and the
    model's sources and each epoch's fan-out; rank 1 makes no call."""
    assert sorted(p.name for p in runs["comet"].iterdir()) == ["rank0.jsonl"]
    calls = [json.loads(line) for line in
             (runs["comet"] / "rank0.jsonl").read_text().splitlines()]
    assert calls[0] == ["Experiment", None, ["api_key", "project_name", "workspace"]]
    assert calls[1] == ["set_name", "two", []]
    assert [c[0] for c in calls[2:5]] == ["log_code"] * 3
    assert [Path(c[1]).name for c in calls[2:5]] == ["two.py", "classifier.py", "resnet.py"]
    epochs = [c for c in calls[5:] if c[0] == "log_image"]
    assert [c[2] for c in epochs] == [["name", "step"]] * 4  # train, validation; 2 epochs
    assert [c[0] for c in calls[5:]].count("log_confusion_matrix") == 2
    assert {c[1] for c in calls[5:] if c[0] == "log_metric"} >= {
        "train loss", "validation loss", "Average epoch train loss",
        "validation balanced accuracy", "train ROC AUC, c0"}


def test_eval_and_inference_over_a_mesh(runs, monkeypatch):
    from nkbx_torch import eval as teval
    from nkbx_torch import inference as tinference

    tmp, data = runs["tmp"], runs["data"]
    best = runs["one"] / "weights" / "best.pt"
    flat = tmp / "flat"
    flat.mkdir()
    for i, p in enumerate(sorted((data / "val").rglob("*.png"))[:11]):  # 8 + 3: rank 1's
        (flat / f"{i:02d}.png").write_bytes(p.read_bytes())           # last rows are padding
    for name, mesh in (("one", ""), ("two", 'mesh = {"data": 2}')):
        (tmp / f"eval_{name}.py").write_text(textwrap.dedent(f"""
            import nkbx.transforms as T

            task = "single"
            enable_mixed_precision = False
            {mesh}
            val_data = {{"type": "ImageFolder", "root": "{data / 'val'}", "batch_size": 8}}
            val_pipeline = T.Compose([T.LongestMaxSize({SIZE}), T.PadIfNeeded({SIZE}, {SIZE}),
                                      T.Normalize()])
            inference_data = {{"folder_path": "{flat}", "batch_size": 8}}
            inference_pipeline = val_pipeline
            classes = ["c0", "c1", "c2"]
            target_column = "label"
            model = {{"task": "single", "model": "resnet_tiny_test", "checkpoint": "{best}"}}
            criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
            save_path = "{tmp / ('out_' + name)}"
        """))
    teval.main(["-cfg", str(tmp / "eval_one.py"), "--device", "cpu"])
    tinference.main(["-cfg", str(tmp / "eval_one.py"), "--device", "cpu"])
    _torchrun("nkbx_torch.eval", tmp / "eval_two.py")
    _torchrun("nkbx_torch.inference", tmp / "eval_two.py")
    want = json.loads((tmp / "out_one" / "metrics.json").read_text())
    got = json.loads((tmp / "out_two" / "metrics.json").read_text())

    def same(x, y, key):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), key
            for k in x:
                same(x[k], y[k], f"{key}/{k}")
        elif isinstance(x, list):
            assert len(x) == len(y), key
            for i, (a, b) in enumerate(zip(x, y)):
                same(a, b, f"{key}[{i}]")
        elif isinstance(x, int) and not isinstance(x, bool):
            assert x == y, key
        elif isinstance(x, float):
            assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-5 * max(abs(x), 1e-30), (
                key, x, y)
        else:
            assert x == y, key

    same(want, got, "metrics")
    rows = [(tmp / f"out_{n}" / "inference_annotations.csv").read_text() for n in ("one", "two")]
    assert rows[0] == rows[1] and len(rows[0].splitlines()) == 12


def test_preemption_stops_every_rank_and_resumes_exactly(runs):
    from test_torch_dist import spawn

    tmp = runs["tmp"]
    res = spawn("preempt", tmp / "preempt", extra=(str(runs["data"]),),
                script=Path(__file__))
    assert res[0]["steps_at_break"] == res[1]["steps_at_break"]
    cursor = json.loads((tmp / "preempt" / "cut" / "weights" / "last.cursor.json").read_text())
    assert cursor["epoch"] == 1 and cursor["batch"] == 2 and cursor["process_count"] == 2
    assert res[0]["steps_at_break"] == 3 + 2  # epoch 0's 3 steps, then 2 of epoch 1
    assert res[0]["resumed_equal"] and res[1]["resumed_equal"]
    assert res[0]["full_steps"] == res[0]["resumed_steps"] == 6

    # a cursor of 2 ranks, resumed by one process: the epoch replays from its start
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_local_experiment
    from nkbx_torch.models import get_model
    from nkbx_torch.train import get_loss
    from nkbx_torch.train.trainer import train
    from nkbx_torch.utils import load_config

    cfg_path = tmp / "preempt" / "one.py"
    cfg_path.write_text(_config(runs["data"], tmp / "preempt" / "replay", False))
    cfg = load_config(cfg_path)
    loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    val = get_dataset({**cfg.val_data, "classes": loader.dataset.classes}, cfg.val_pipeline)
    model = get_model(cfg.model, loader.dataset.classes, input_size=(SIZE, SIZE),
                      dtype=torch.float32, device="cpu")
    with pytest.warns(UserWarning, match="replaying epoch 1 from its beginning"):
        state = train(model, loader, val, get_loss(cfg.criterion), None,
                      get_local_experiment(cfg.experiment["local"]), cfg,
                      resume_from=tmp / "preempt" / "cut" / "weights" / "last")
    assert state.step == 5 + 3  # the saved 5 steps, then epoch 1's 3 from its start


def rank_preempt(out, data):
    """Every rank: an uninterrupted 2-epoch run, a run whose rank 1 gets a
    SIGTERM while it reads batch 2 of epoch 1, and its resume; writes the
    steps and whether the resumed weights equal the uninterrupted ones."""
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_local_experiment
    from nkbx_torch.logging.experiment import LocalExperiment
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import collectives, make_mesh
    from nkbx_torch.train import get_loss, preempt
    from nkbx_torch.train.trainer import train
    from nkbx_torch.utils import load_config

    initialize(True, "cpu")
    mesh = make_mesh()
    out, data = Path(out), Path(data)
    preempt.install()

    def run(name, kill_at=None, resume=None):
        cfg_path = out / f"{name}.py"
        if mesh.rank == 0:
            cfg_path.write_text(_config(data, out / name, True, "preempt_sync_every = 2\n"))
        collectives.barrier()
        cfg = load_config(cfg_path)
        loader = get_dataset(cfg.train_data, cfg.train_pipeline, mesh=mesh)
        val = get_dataset({**cfg.val_data, "classes": loader.dataset.classes},
                          cfg.val_pipeline, mesh=mesh)
        if kill_at is not None:
            epoch_of = loader.epoch

            def epoch(e, start_batch=0):
                it = epoch_of(e, start_batch) if start_batch else epoch_of(e)
                for i, b in enumerate(it):
                    if (e, i) == kill_at and mesh.rank == 1:
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

            loader.epoch = epoch
        model = get_model(cfg.model, loader.dataset.classes, input_size=(SIZE, SIZE),
                          dtype=torch.float32, device="cpu")
        exp = get_local_experiment(cfg.experiment["local"]) if mesh.rank == 0 else None
        path = collectives.broadcast_object(str(exp.path) if exp else None)
        state = train(model, loader, val, get_loss(cfg.criterion), None,
                      exp or LocalExperiment(path), cfg, resume_from=resume, mesh=mesh)
        preempt.reset()
        return state

    full = run("full")
    cut = run("cut", kill_at=(1, 2))
    steps_at_break = cut.step
    resumed = run("resumed", resume=out / "cut" / "weights" / "last")
    want, got = full.module.state_dict(), resumed.module.state_dict()
    equal = all(torch.equal(want[k], got[k]) for k in want)
    (out / f"rank{mesh.rank}.json").write_text(json.dumps({
        "steps_at_break": steps_at_break, "resumed_equal": equal, "full_steps": full.step,
        "resumed_steps": resumed.step}))


def test_runtime_refusals(monkeypatch):
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.eval import start
    from nkbx_torch.parallel import make_mesh
    from nkbx_torch.utils import Config

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        initialize(distributed=True, device="cpu")
    with pytest.raises(ValueError, match=r"mesh data=2 must equal the number of ranks \(1\)"):
        make_mesh(n_data=2)
    assert make_mesh().data == 1
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card of its own: 1 visible"):
        initialize(distributed=True)
    with pytest.raises(RuntimeError, match="without a mesh"):
        start(Config({"task": "single"}), "cpu")


if __name__ == "__main__":
    import torch.distributed as dist

    if sys.argv[1] == "preempt":
        rank_preempt(sys.argv[2], sys.argv[3])
    dist.barrier()
    dist.destroy_process_group()
