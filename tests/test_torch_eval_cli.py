"""The port's eval and inference CLIs against nkbx's ``eval.py`` and
``inference.py``, and the shipped configs in the port, on the CPU.

- One config file read by both packages (single-task: a CSV-annotated val
  fold; multi-task: two targets), resnet_tiny_test at 32 px in f32, batch 5
  over 12 images (the last batch padded), the same weights in both: nkbx's
  model perturbed from its init, saved by ``save_model_msgpack`` and named by
  the config's ``checkpoint``. ``python -m nkbx_torch.eval --device cpu``
  against ``eval.evaluate``: every metric within 1e-5; ``python -m
  nkbx_torch.inference --device cpu`` against ``inference.inference``:
  identical CSV rows (labels and paths).
- The shipped configs: singletask, multitask, yolo_crops, heavy_augs
  and modern_recipe load, and the trainer takes each, yolo_crops'
  ``export_serving`` included; the eval and inference configs' ``scripted:
  True`` passes the CLIs' option check (tests/test_torch_export.py runs
  them on a bundle), a ``mesh`` raises naming A10; without a card the CLIs
  raise.
"""

import csv
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nkbx.transforms as JT
from nkbx.data import get_dataset as jget_dataset
from nkbx.data import get_inference_dataset as jget_inference_dataset
from nkbx.models import get_model as jget_model
from nkbx.train import get_loss as jget_loss
from nkbx.train.checkpoint import save_model_msgpack
from nkbx.utils import load_config as jload_config
from nkbx_torch import eval as teval
from nkbx_torch import inference as tinference
from nkbx_torch.train.trainer import check_options
from nkbx_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


def _nkbx_cli(name):
    """nkbx's eval.py or inference.py, imported from the repo's root."""
    spec = importlib.util.spec_from_file_location(f"nkbx_cli_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TASKS = {
    "single": dict(classes=["blue", "green", "red"], data="AnnotatedSingletaskDataset",
                   keys='"target_column": "label"', extra='target_column = "label"'),
    "multi": dict(classes={"color": ["blue", "green", "red"], "size": ["big", "small"]},
                  data="AnnotatedMultitaskDataset", keys='"target_names": ["color", "size"]',
                  extra='target_names = ["color", "size"]'),
}


@pytest.fixture(params=sorted(TASKS))
def workspace(request, csv_dataset, tmp_path):
    """A config file for both CLIs and the weights it names."""
    task, spec = request.param, TASKS[request.param]
    classes_path = tmp_path / "classes.json"
    classes_path.write_text(json.dumps(spec["classes"]))
    folder = tmp_path / "unknown"
    folder.mkdir()
    for p in sorted(Path(csv_dataset["image_base_dir"]).iterdir())[:12]:
        (folder / p.name).write_bytes(p.read_bytes())
    donor = jget_model({"task": task, "model": "resnet_tiny_test"}, spec["classes"],
                       input_size=(SIZE, SIZE), seed=4, dtype=jnp.float32)
    rng = np.random.default_rng(3)

    def perturb(path, p):  # running variances kept positive
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(donor.variables))
    # centre each head's logits over the folder's images, so that they do not
    # all land in one class
    pipe = JT.Compose([JT.LongestMaxSize(SIZE), JT.PadIfNeeded(SIZE, SIZE), JT.Normalize()])
    batch = next(iter(jget_inference_dataset({"folder_path": str(folder), "batch_size": 12,
                                              "num_workers": 1}, pipe).epoch(0)))
    logits = donor.apply(variables, pipe.device_apply(jnp.asarray(batch["image"]),
                                                      jax.random.PRNGKey(0), False))
    for name, out in (logits.items() if task == "multi" else [("head", logits)]):
        head = variables["params"]["head" if task == "single" else f"head_{name}"]
        head["bias"] = head["bias"] - np.asarray(out).mean(0)
    save_model_msgpack(tmp_path / "best.msgpack", variables)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""import nkbx.transforms as T

enable_mixed_precision = False
task = "{task}"
{spec["extra"]}
classes = "{classes_path}"
save_path = "{tmp_path / 'port'}"
val_data = {{"type": "{spec['data']}", "annotations_file": "{csv_dataset['annotations_file']}",
            "image_base_dir": "{csv_dataset['image_base_dir']}", {spec['keys']},
            "classes": "{classes_path}", "fold": "val", "batch_size": 5, "shuffle": False,
            "num_workers": 2, "drop_last": False}}
inference_data = {{"folder_path": "{folder}", "batch_size": 5, "num_workers": 2}}
val_pipeline = T.Compose([T.LongestMaxSize({SIZE}), T.PadIfNeeded({SIZE}, {SIZE}), T.Normalize(),
                          T.ToTensorV2()])
inference_pipeline = val_pipeline
model = {{"task": task, "model": "resnet_tiny_test", "checkpoint": "{tmp_path / 'best.msgpack'}"}}
criterion = {{"task": task, "type": "CrossEntropyLoss"}}
""")
    return {"cfg": cfg, "dir": tmp_path, "task": task}


def _close(got, want, where="metrics"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=where)


def test_eval_cli_matches_nkbx(workspace):
    from nkbx.utils import convert_dict_types_recursive

    jcfg = jload_config(str(workspace["cfg"]))
    loader = jget_dataset(jcfg.val_data, jcfg.val_pipeline)
    model = jget_model(jcfg.model, loader.dataset.classes, input_size=(SIZE, SIZE),
                       dtype=jnp.float32)
    want = convert_dict_types_recursive(
        _nkbx_cli("eval").evaluate(model, loader, jget_loss(jcfg.criterion), jcfg))
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.eval", "-cfg", str(workspace["cfg"]),
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads((workspace["dir"] / "port" / "metrics.json").read_text())
    _close(got, json.loads(json.dumps(want)))
    assert len(got["loss"]) == 3  # 12 images in batches of 5


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_inference_cli_matches_nkbx(workspace):
    from nkbx.utils import load_classes

    jcfg = jload_config(str(workspace["cfg"]))
    loader = jget_inference_dataset(jcfg.inference_data, jcfg.inference_pipeline)
    classes = load_classes(jcfg.classes)
    model = jget_model(jcfg.model, classes, input_size=(SIZE, SIZE), dtype=jnp.float32)
    (workspace["dir"] / "nkbx").mkdir()
    _nkbx_cli("inference").inference(model, loader, classes, workspace["dir"] / "nkbx", jcfg)
    tinference.main(["-cfg", str(workspace["cfg"]), "--device", "cpu"])
    want = _rows(workspace["dir"] / "nkbx" / "inference_annotations.csv")
    got = _rows(workspace["dir"] / "port" / "inference_annotations.csv")
    assert got == want and len(got) == 13
    labels = {tuple(r[:-1]) for r in got[1:]}
    assert len(labels) > 1  # the weights do not put every image in one class


def test_cli_options_that_raise(workspace, monkeypatch):
    cfg = load_config(workspace["cfg"])
    cfg.mesh = {"data": 2}
    with pytest.raises(NotImplementedError, match="A10"):
        teval.check_options(cfg)
    for name in ("eval_config", "inference_config"):
        shipped = load_config(ROOT / "configs" / f"{name}.py")
        assert shipped.model["scripted"] is True
        teval.check_options(shipped)  # a serving bundle: ExportedModel
    if not torch.cuda.is_available():
        for cli in (teval, tinference):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cli.main(["-cfg", str(workspace["cfg"])])


@pytest.mark.parametrize("name,loads", [("singletask_config", True), ("multitask_config", True),
                                        ("yolo_crops_config", True),
                                        ("heavy_augs_config", True),
                                        ("modern_recipe_config", True)])
def test_shipped_configs_in_the_port(name, loads):
    path = ROOT / "configs" / f"{name}.py"
    if not loads:
        with pytest.raises(NotImplementedError, match="A9"):
            load_config(path)
        return
    cfg = load_config(path)
    ops = {type(t).__name__ for t in cfg.train_pipeline.device_transforms}
    if name == "modern_recipe_config":
        assert ops == {"RandAugment", "Normalize"}
        check_options(cfg)  # mixup, EMA, steps_per_dispatch: all run in the port
    elif name == "heavy_augs_config":
        assert ops == {"MotionBlur", "RandomBrightnessContrast", "HueSaturationValue",
                       "RandomShadow", "RandomFog", "RandomRain", "CoarseDropout", "Normalize"}
        assert cfg.log_gradients is True and cfg.criterion["type"] == "FocalLoss"
    else:
        assert ops >= {"HorizontalFlip", "RandomBrightnessContrast", "Normalize"}
    assert cfg.model["pretrained"] is True
    if name == "yolo_crops_config":
        assert cfg.export_serving is True  # the trainer writes best.nkbx and last.nkbx
    check_options(cfg)
