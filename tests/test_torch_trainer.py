"""The port's config-driven trainer (``nkbx_torch.train.train`` and its CLI)
on the CPU.

- A 2-epoch lockstep against ``nkbx.train.train``: the tiny Swin of
  tests/test_torch_train.py (embed 16, depths (2, 2), heads (1, 2), window
  2, 32 px) with nkbx's weights carried across, an ImageFolder of 24 train
  and 12 val PNG files the test writes, LongestMaxSize(32) +
  PadIfNeeded(32, 32) + Normalize (no flips: the two draw them from
  different generators by design), f32, batch 5 with a padded last batch,
  nadam with backbone and head lrs, cosine, and a freeze flip {0: freeze, 1:
  unfreeze}. Every value of ``metrics.csv`` (losses, balanced accuracies,
  ROC-AUCs, per class and mean, train and val; not the images a second)
  within 1e-4 relative, and the final weights within 1e-4 (+1e-4 relative)
  but the key biases, whose gradient is rounding noise (see the test).
- Resume: ``resnet_tiny_test`` (BatchNorm, so the masked step, and flips
  drawn from the state's generator), preempted at batch 1 of epoch 1 and
  resumed from ``weights/last``, ends with the weights and running
  statistics of an uninterrupted run within 1e-6; the same with
  ``classifier_dropout`` and ``backbone_dropout`` at 0.1 (the masks come
  from the checkpointed generator).
- One seed fixes a run with dropout: two runs in one process (torch's
  global generator seeded differently) and two CLI runs in fresh processes
  are bit-equal, weights and metrics.csv (but the throughput).
- A mesh ``model`` axis raises by design, naming ROADMAP A10b; ``fsdp``
  passes the check and, without a mesh, raises nkbx's ValueError; a Comet
  section without ``comet_ml`` warns as nkbx does and the CLI writes the
  ``metrics.csv`` of the run without the section. The five train-step keys (EMA, mixup, steps per
  dispatch, accumulation, gradient norms) each train one epoch.
- The CLI, ``python -m nkbx_torch.train -cfg ... --device cpu``, on a
  config that says ``import nkbx.transforms as T``, over BMP files: exit
  without error, ``classes.json``, a 2-row ``metrics.csv``, ``best/``,
  ``last/`` and the weights files, which ``get_model`` loads.
"""

import csv
import signal
import sys
import textwrap
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nkbx.transforms as JT
from nkbx.data import get_dataset as jget_dataset
from nkbx.logging import get_local_experiment as jget_local_experiment
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.swin import SwinTransformer as JSwin
from nkbx.train import get_loss as jget_loss
from nkbx.train import train as jtrain
from nkbx.utils.config import Config as JConfig
from nkbx_torch import transforms as T
from nkbx_torch.data import get_dataset
from nkbx_torch.logging import get_local_experiment
from nkbx_torch.models import from_jax_variables, get_model
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.train import get_loss, preempt
from nkbx_torch.train.__main__ import main as cli_main
from nkbx_torch.train.trainer import check_options, train
from nkbx_torch.utils import Config

TINY = dict(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2)
SIZE = 32
ROOT = Path(__file__).resolve().parents[1]


def _write_folder(root, ext, n_train=8, n_val=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = int(rng.integers(24, 70)), int(rng.integers(24, 70))
                img = rng.integers(0, 256, (h, w, 3)).astype(np.int32) + 50 * (c - 1)
                cv2.imwrite(str(d / f"{i}{ext}"), np.clip(img, 0, 255).astype(np.uint8))
    return root


def _cfg(root, run, M, model=None, flips=False, n_epochs=2):
    """The config dict, with pipelines built from the transforms module M
    (the port's or nkbx's)."""
    geometry = [M.LongestMaxSize(SIZE), M.PadIfNeeded(SIZE, SIZE)]
    return {
        "task": "single", "n_epochs": n_epochs, "seed": 0, "enable_mixed_precision": False,
        "train_data": {"type": "ImageFolder", "root": str(root / "train"), "batch_size": 5,
                       "shuffle": True, "num_workers": 2, "drop_last": False},
        "val_data": {"type": "ImageFolder", "root": str(root / "val"), "batch_size": 5,
                     "shuffle": False, "num_workers": 2},
        "train_pipeline": M.Compose(geometry + ([M.HorizontalFlip()] if flips else [])
                                    + [M.Normalize()]),
        "val_pipeline": M.Compose(geometry + [M.Normalize()]),
        "model": model or {"task": "single", "model": "swin (built by the test)"},
        "optimizer": {"type": "nadam", "backbone_lr": 1e-3, "classifier_lr": 1e-2,
                      "backbone_weight_decay": 0.05, "classifier_weight_decay": 0.01},
        "lr_policy": {"type": "cosine", "n_epochs": n_epochs},
        "backbone_state_policy": {0: "freeze", 1: "unfreeze"},
        "criterion": {"task": "single", "type": "CrossEntropyLoss"},
        "experiment": {"comet": None, "local": {"path": str(run)}},
    }


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return {k: [float(r[k]) if r[k] else np.nan for r in rows] for k in rows[0]}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """Both trainers on the same files from the same weights."""
    tmp = tmp_path_factory.mktemp("lockstep")
    root = _write_folder(tmp, ".png")
    jcfg = JConfig(_cfg(root, tmp / "nkbx", JT))
    jtrain_loader = jget_dataset(jcfg.train_data, jcfg.train_pipeline)
    classes = jtrain_loader.dataset.classes
    jcfg.val_data = {**jcfg.val_data, "classes": classes}
    jmodule = JSingle(backbone=JSwin(dtype=jnp.float32, fused_attention=False, fused_mlp=False,
                                     **TINY), n_classes=len(classes))
    variables = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    variables = jax.device_get(variables)
    jmodel = JModel(jmodule, variables, classes, "single", 32)
    jexp = jget_local_experiment(jcfg.experiment["local"])
    with pytest.warns(UserWarning, match="Partial"):  # nkbx's unmasked-BN notice, no BN here
        jstate = jtrain(jmodel, jtrain_loader, jget_dataset(jcfg.val_data, jcfg.val_pipeline),
                        jget_loss(jcfg.criterion), None, jexp, jcfg)

    cfg = Config(_cfg(root, tmp / "port", T))
    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    cfg.val_data = {**cfg.val_data, "classes": classes}
    backbone = SwinTransformer(dtype=torch.float32, img_size=(SIZE, SIZE), **TINY)
    module = SingletaskClassifier(backbone, len(classes))
    module.load_state_dict(from_jax_variables(variables, reference=module))
    model = ClassificationModel(module.eval(), classes, "single", backbone.num_features,
                                (SIZE, SIZE), torch.float32, torch.device("cpu"))
    exp = get_local_experiment(cfg.experiment["local"])
    state = train(model, train_loader, get_dataset(cfg.val_data, cfg.val_pipeline),
                  get_loss(cfg.criterion), None, exp, cfg)
    want = from_jax_variables({"params": jax.device_get(jstate.params)})
    return exp.path, jexp.path, state, want


def test_metrics_csv_matches_nkbx(lockstep):
    port_dir, nkbx_dir, _, _ = lockstep
    got, want = _read_csv(port_dir / "metrics.csv"), _read_csv(nkbx_dir / "metrics.csv")
    assert got.keys() == want.keys() and len(got["Epoch"]) == 2
    for k in got:
        if k != "train images/sec/chip":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    assert {"train loss", "Val loss", "Val balanced accuracy", "Val ROC AUC"} <= got.keys()


def test_final_weights_match_nkbx(lockstep):
    """The key bias (the middle third of each qkv bias) shifts every score
    of a query by the same amount, so its gradient is 0 but for rounding
    noise, and NAdam turns that noise into steps of up to ±lr: there the
    bound is 2·lr·lr_factor summed over the unfrozen steps (epoch 1: 5
    steps at 1e-3 · 0.5)."""
    _, _, state, want = lockstep
    key_bias_bound = 2 * 1e-3 * 0.5 * 5
    for name, p in state.module.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        bound = 1e-4 + 1e-4 * np.abs(ref)
        if name.endswith("attn.qkv.bias"):
            c = ref.size // 3
            bound[c:2 * c] = key_bias_bound
        assert (np.abs(got - ref) <= bound).all(), (name, np.abs(got - ref).max())


def test_run_artifacts(lockstep):
    port_dir, nkbx_dir, _, _ = lockstep
    assert (port_dir / "classes.json").read_text() == (nkbx_dir / "classes.json").read_text()
    for name in ("best", "last", "best.pt", "last.pt"):
        assert (port_dir / "weights" / name).exists(), name
    assert (port_dir / "train_batch_1.png").exists()


class PreemptAt:
    """A loader that raises the preemption flag as it yields batch ``batch``
    of epoch ``epoch``: the epoch loop sees the flag before it steps that
    batch, so ``batch`` batches of the epoch were consumed."""

    def __init__(self, inner, epoch, batch):
        self.inner, self.at = inner, (epoch, batch)

    def epoch(self, e, start_batch=0):
        for i, b in enumerate(self.inner.epoch(e, start_batch)):
            if (e, i) == self.at:
                preempt._handler(None, None)
            yield b

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _resnet_run(root, run, wrap=None, resume_from=None, dropout=0.0):
    model = {"task": "single", "model": "resnet_tiny_test"}
    if dropout:
        model.update(classifier_dropout=dropout, backbone_dropout=dropout)
    cfg = Config(_cfg(root, run, T, flips=True, model=model))
    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    val_loader = get_dataset({**cfg.val_data, "classes": train_loader.dataset.classes},
                             cfg.val_pipeline)
    model = get_model(cfg.model, train_loader.dataset.classes, input_size=(SIZE, SIZE),
                      dtype=torch.float32, device="cpu")
    exp = get_local_experiment(cfg.experiment["local"])
    loader = wrap(train_loader) if wrap else train_loader
    state = train(model, loader, val_loader, get_loss(cfg.criterion), None, exp, cfg,
                  resume_from=resume_from)
    return exp.path, state


def _preempt_and_resume(tmp_path, dropout=0.0):
    root = _write_folder(tmp_path, ".png", seed=1)
    _, full = _resnet_run(root, tmp_path / "full", dropout=dropout)
    preempt.reset()
    try:
        cut_dir, cut = _resnet_run(root, tmp_path / "cut", wrap=lambda lo: PreemptAt(lo, 1, 1),
                                   dropout=dropout)
    finally:
        preempt.reset()
    cursor = (cut_dir / "weights" / "last.cursor.json").read_text()
    assert '"epoch": 1' in cursor and '"batch": 1' in cursor
    assert len(_read_csv(cut_dir / "metrics.csv")["Epoch"]) == 1
    res_dir, resumed = _resnet_run(root, tmp_path / "resumed",
                                   resume_from=cut_dir / "weights" / "last", dropout=dropout)
    want, got = full.module.state_dict(), resumed.module.state_dict()
    assert resumed.step == full.step
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert not (res_dir / "weights" / "last.cursor.json").exists()


def test_preempted_and_resumed_run_equals_an_uninterrupted_one(tmp_path):
    _preempt_and_resume(tmp_path)


def test_resumed_run_with_dropout_equals_an_uninterrupted_one(tmp_path):
    """The same with ``classifier_dropout`` and ``backbone_dropout`` at 0.1:
    the masks come from the checkpointed generator."""
    _preempt_and_resume(tmp_path, dropout=0.1)


def _state_dicts_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _without_clock(rows):
    return {k: v for k, v in rows.items() if "images/sec" not in k}


DROPOUT_CONFIG = """
import nkbx.transforms as T

task = "single"
n_epochs = 2
seed = 0
enable_mixed_precision = False
train_data = {{"type": "ImageFolder", "root": "{root}/train", "batch_size": 5, "shuffle": True,
              "num_workers": 1}}
val_data = {{"type": "ImageFolder", "root": "{root}/val", "batch_size": 5}}
train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.HorizontalFlip(),
                            T.Normalize()])
val_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.Normalize()])
model = {{"task": "single", "model": "resnet_tiny_test", "classifier_dropout": 0.1,
         "backbone_dropout": 0.1}}
optimizer = {{"type": "adam", "backbone_lr": 1e-3, "classifier_lr": 1e-3}}
lr_policy = {{"type": "cosine", "n_epochs": 2}}
criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
"""


def test_dropout_runs_are_fixed_by_the_seed(tmp_path):
    """Two trainer runs with one seed and ``classifier_dropout`` and
    ``backbone_dropout`` at 0.1 are bit-equal: in one process (torch's
    global generator seeded differently before each), and through the CLI
    in two fresh processes (weights and metrics.csv but the throughput)."""
    import subprocess

    root = _write_folder(tmp_path, ".png", seed=4)
    runs = []
    for i, torch_seed in enumerate((1, 2)):
        torch.manual_seed(torch_seed)
        path, state = _resnet_run(root, tmp_path / f"in_process{i}", dropout=0.1)
        runs.append((state.module.state_dict(), _without_clock(_read_csv(path / "metrics.csv"))))
    assert _state_dicts_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    procs = []
    for i in range(2):
        cfg = tmp_path / f"fresh{i}.py"
        cfg.write_text(DROPOUT_CONFIG.format(root=root, run=tmp_path / f"fresh{i}"))
        procs.append(subprocess.Popen([sys.executable, "-m", "nkbx_torch.train", "-cfg", str(cfg),
                                       "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-3000:]
    a, b = (torch.load(tmp_path / f"fresh{i}" / "weights" / "last.pt", map_location="cpu")
            for i in range(2))
    assert _state_dicts_equal(a, b)
    assert (_without_clock(_read_csv(tmp_path / "fresh0" / "metrics.csv"))
            == _without_clock(_read_csv(tmp_path / "fresh1" / "metrics.csv")))


# the keys of A10b: what the trainer refuses of each (None: nothing; a mesh
# 'model' axis > 1 by design), and a value of the key that it runs
REFUSED = {"fsdp": (None, True), "mesh": ({"data": 2, "model": 2}, {"data": 2, "model": 1})}


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_unported_trainer_options_raise(key):
    refused, runs = REFUSED[key]
    if refused is not None:
        with pytest.raises(NotImplementedError, match="A10b"):
            check_options(Config({"task": "single", key: refused}))
    check_options(Config({"task": "single", key: runs}))
    if key == "fsdp":  # it runs over a mesh (tests/test_torch_fsdp.py); without one, nkbx's error
        with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
            train(None, None, None, None, None, None, Config({"task": "single", key: runs}),
                  mesh=None)


A4_KEYS = {"model_ema_decay": 0.9, "mixup": {"alpha": 0.2, "cutmix_alpha": 1.0},
           "steps_per_dispatch": 2, "grad_accum_steps": 2, "log_gradients": True}


@pytest.mark.parametrize("key", sorted(A4_KEYS))
def test_a4_trainer_options_run(key, tmp_path):
    """Each of the five train-step keys, once refused, passes
    ``check_options`` and trains one CPU epoch of ``resnet_tiny_test`` (batches
    of 4, drop_last so that accumulation halves divide them)."""
    root = _write_folder(tmp_path, ".png", n_train=4, n_val=2, seed=3)
    cfg = Config({**_cfg(root, tmp_path / "run", T, flips=True, n_epochs=1,
                         model={"task": "single", "model": "resnet_tiny_test"}),
                  key: A4_KEYS[key]})
    cfg.train_data = {**cfg.train_data, "batch_size": 4, "drop_last": True}
    check_options(cfg)
    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    val_loader = get_dataset({**cfg.val_data, "classes": train_loader.dataset.classes},
                             cfg.val_pipeline)
    model = get_model(cfg.model, train_loader.dataset.classes, input_size=(SIZE, SIZE),
                      dtype=torch.float32, device="cpu")
    exp = get_local_experiment(cfg.experiment["local"])
    state = train(model, train_loader, val_loader, get_loss(cfg.criterion), None, exp, cfg)
    assert state.step == len(train_loader) == 3
    assert (state.ema_module is not None) == (key == "model_ema_decay")
    rows = _read_csv(exp.path / "metrics.csv")
    assert len(rows["Epoch"]) == 1 and np.isfinite(rows["train loss"]).all()
    grads = [c for c in rows if c.startswith("Gradients/")]
    assert bool(grads) == (key == "log_gradients")
    if grads:  # each parameter's epoch nan-mean under nkbx's path, and their sum's
        assert "Gradients/Total" in grads and "Gradients/head/kernel" in grads
        assert all(np.isfinite(rows[c]).all() for c in grads)


def test_cli_trains_from_a_config_file(tmp_path, monkeypatch):
    root = _write_folder(tmp_path, ".bmp", n_train=4, n_val=2, seed=2)
    config = tmp_path / "config.py"
    config.write_text(textwrap.dedent(f"""
        import nkbx.transforms as T

        task = "single"
        n_epochs = 2
        enable_mixed_precision = False
        train_data = {{"type": "ImageFolder", "root": "{root / 'train'}", "batch_size": 5,
                      "shuffle": True, "num_workers": 2}}
        val_data = {{"type": "ImageFolder", "root": "{root / 'val'}", "batch_size": 5}}
        train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32),
                                    T.HorizontalFlip(), T.Normalize(), T.ToTensorV2()])
        val_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32), T.Normalize()])
        model = {{"task": "single", "model": "resnet_tiny_test"}}
        optimizer = {{"type": "adam", "backbone_lr": 1e-3, "classifier_lr": 1e-3}}
        lr_policy = {{"type": "cosine", "n_epochs": 2}}
        backbone_state_policy = {{0: "freeze", 1: "unfreeze"}}
        criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
        experiment = {{"comet": None, "local": {{"path": "{tmp_path / 'run'}"}}}}
    """))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        cli_main(["-cfg", str(config), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    run = tmp_path / "run"
    assert (run / "classes.json").exists()
    assert len(_read_csv(run / "metrics.csv")["Epoch"]) == 2
    for name in ("best", "last", "best.pt", "last.pt"):
        assert (run / "weights" / name).exists(), name
    model = get_model({"model": "resnet_tiny_test", "checkpoint": str(run / "weights/last.pt")},
                      ["c0", "c1", "c2"], input_size=(32, 32), device="cpu")
    assert torch.isfinite(model(torch.zeros(1, 32, 32, 3))).all()


def test_comet_absent_warns_and_logs_locally(tmp_path, monkeypatch):
    """A config with a Comet section where ``comet_ml`` does not import: the
    CLI prints nkbx's warning, trains, and writes the metrics.csv (but the
    throughput, a clock reading) and classes.json of the run without it."""
    root = _write_folder(tmp_path, ".png", n_train=2, n_val=1, seed=3)
    (tmp_path / "comet_api.yml").write_text("api_key: k\nworkspace: w\nproject_name: p\n")
    for name, comet in (("plain", None), ("comet", {"comet_api_cfg_path": str(
            tmp_path / "comet_api.yml"), "auto_metric_logging": False, "name": "run"})):
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(f"""
            import nkbx.transforms as T

            task = "single"
            n_epochs = 2
            enable_mixed_precision = False
            train_data = {{"type": "ImageFolder", "root": "{root / 'train'}", "batch_size": 4,
                          "shuffle": True, "num_workers": 1}}
            val_data = {{"type": "ImageFolder", "root": "{root / 'val'}", "batch_size": 4}}
            train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32),
                                        T.Normalize()])
            val_pipeline = train_pipeline
            model = {{"task": "single", "model": "resnet_tiny_test"}}
            optimizer = {{"type": "sgd", "backbone_lr": 0.05, "classifier_lr": 0.05}}
            lr_policy = {{"type": "cosine", "n_epochs": 2}}
            criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
            experiment = {{"comet": {comet!r}, "local": {{"path": "{tmp_path / name}"}}}}
        """))
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # the import fails
    handler = signal.getsignal(signal.SIGTERM)
    try:
        cli_main(["-cfg", str(tmp_path / "plain.py"), "--device", "cpu"])
        with pytest.warns(UserWarning, match="^comet_ml is not installed; continuing with "
                                             "local logging only$"):
            cli_main(["-cfg", str(tmp_path / "comet.py"), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    got, want = (_read_csv(tmp_path / d / "metrics.csv") for d in ("comet", "plain"))
    assert got.keys() == want.keys() and len(want["Epoch"]) == 2
    for key in want:
        if key != "train images/sec/chip":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert ((tmp_path / "comet" / "classes.json").read_text()
            == (tmp_path / "plain" / "classes.json").read_text())
