"""The port's config migrator (``nkbx_torch/utils/migrate.py``) against
nkbx's (``nkbx/utils/migrate.py``), on the CPU.

- ``migrate_text`` gives nkbx's text and warnings, input for input: the
  reference-style config of ``tests/test_migrate.py``, the legacy and
  ``from albumentations import`` forms, a torch checkpoint, an op the
  transforms lack, a star import, another ``nn`` criterion. The warnings can
  be equal because the two transform namespaces are: a test holds that.
- ``check_config`` refuses a non-dict criterion as nkbx's does.
- The CLI in a subprocess writes nkbx's text, passes ``--check``, and the
  migrated config trains one CPU epoch through ``python -m nkbx_torch.train
  --device cpu``.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import nkbx.transforms as jT
import nkbx_torch.transforms as tT
from nkbx.utils import migrate as jmigrate
from nkbx_torch.logging.experiment import write_png
from nkbx_torch.utils import migrate as tmigrate

# a package's dir() also lists the submodules imported so far, by any test run
# before in this process: import them all, so both packages list theirs
for _pkg in ("nkbx", "nkbx_torch"):
    for _sub in ("adapter", "device", "host", "spec"):
        importlib.import_module(f"{_pkg}.transforms.{_sub}")

REPO = Path(__file__).resolve().parent.parent

REFERENCE_STYLE = '''\
import albumentations as A
import cv2
from albumentations.pytorch import ToTensorV2


device = "cuda:0"
enable_mixed_presicion = True
enable_gradient_scaler = True
compile = False

experiment_name = "migr_run"
experiment = {"comet": None, "local": {"path": "RUNS_DIR"}}
log_gradients = False
task = "single"

train_data = {"type": "ImageFolder", "root": "DATA_ROOT/train",
              "weighted_sampling": True, "shuffle": True, "batch_size": 8,
              "num_workers": 0, "drop_last": True}
val_data = {"type": "ImageFolder", "root": "DATA_ROOT/val", "shuffle": False,
            "batch_size": 8, "num_workers": 0, "drop_last": False}

img_size = 32
train_pipeline = A.Compose([
    A.LongestMaxSize(img_size, always_apply=True),
    A.PadIfNeeded(img_size, img_size, always_apply=True,
                  border_mode=cv2.BORDER_CONSTANT, value=0),
    A.HorizontalFlip(p=0.5),
    A.RandomBrightnessContrast(brightness_limit=(-0.2, 0.2),
                               contrast_limit=(0.1, -0.5), p=0.5),
    A.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    ToTensorV2(),
])
val_pipeline = A.Compose([
    A.LongestMaxSize(img_size, always_apply=True),
    A.PadIfNeeded(img_size, img_size, always_apply=True,
                  border_mode=cv2.BORDER_CONSTANT, value=0),
    A.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    ToTensorV2(),
])

model = {"task": task, "model": "resnet_tiny_test", "pretrained": False,
         "backbone_dropout": 0.1, "classifier_dropout": 0.1,
         "classifier_initialization": "kaiming_normal_"}
optimizer = {"type": "nadam", "lr": 1e-3, "backbone_lr": 1e-3,
             "classifier_lr": 1e-2, "weight_decay": 0.2,
             "backbone_weight_decay": 0.01, "classifier_weight_decay": 0.2}
n_epochs = 1
lr_policy = {"type": "cosine", "n_epochs": n_epochs}
backbone_state_policy = {}
criterion = {"task": task, "type": "CrossEntropyLoss"}
'''

SOURCES = {
    "reference": REFERENCE_STYLE,
    "checkpoint-and-unknown-op": ('import albumentations as A\n'
                                  'model = {"checkpoint": "w/last.pth"}\n'
                                  'train_pipeline = A.Compose([A.FancyPCA(p=1.0)])\n'),
    "unaliased": ('import albumentations\n'
                  'p = albumentations.Compose([albumentations.HorizontalFlip()])\n'),
    "legacy-criterion": ("import torch\nimport torch.nn as nn\n"
                         "criterion = nn.CrossEntropyLoss()\n"),
    "other-criterion": "criterion = nn.BCEWithLogitsLoss(pos_weight=w)\n",
    "from-import": ("from albumentations import Compose, HorizontalFlip\n"
                    "p = Compose([HorizontalFlip(p=0.5)])\n"),
    "star-import": "from albumentations import *\n",
    "cuda-kept": ('import albumentations as A\nx = torch.cuda.is_available()\n'
                  'p = A.Compose([A.Blur(p=0.1), A.ToGray()])\n'),
}


def test_transform_names_equal_nkbx():
    """Equal names: for every input the two migrators warn alike."""
    assert tmigrate._transform_names() == jmigrate._transform_names()
    assert tmigrate._transform_names() == {n for n in dir(jT) if not n.startswith("_")}
    assert "Compose" in tmigrate._transform_names() and tT.Compose


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_migrate_text_is_nkbx(case):
    got_text, got_warn = tmigrate.migrate_text(SOURCES[case])
    want_text, want_warn = jmigrate.migrate_text(SOURCES[case])
    assert got_text == want_text
    assert got_warn == want_warn
    if case in ("checkpoint-and-unknown-op", "other-criterion", "star-import", "cuda-kept"):
        assert got_warn


def test_check_rejects_non_dict_criterion(tmp_path):
    cfg = tmp_path / "c.py"
    cfg.write_text("criterion = 5\n")
    got = tmigrate.check_config(cfg)
    assert got == jmigrate.check_config(cfg) and any("criterion" in p for p in got)


def _folder(root):
    rng = np.random.default_rng(0)
    for fold in ("train", "val"):
        for ci, cls in enumerate(("cat", "dog")):
            d = root / fold / cls
            d.mkdir(parents=True)
            for i in range(8):
                img = rng.integers(0, 255, (32, 32, 3)).astype(np.int32) + (80 if ci else -80)
                write_png(d / f"{i}.png", np.clip(img, 0, 255).astype(np.uint8))
    return root


def test_cli_checks_and_the_migrated_config_trains_in_the_port(tmp_path):
    data = _folder(tmp_path / "data")
    runs = tmp_path / "runs" / "migr_run"
    old = tmp_path / "old_config.py"
    old.write_text(REFERENCE_STYLE.replace("DATA_ROOT", str(data)).replace("RUNS_DIR", str(runs)))
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.utils.migrate", str(old), "--check"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    migrated = tmp_path / "old_config_nkbx.py"
    assert f"Wrote {migrated}" in r.stdout and "check ok" in r.stdout
    assert migrated.read_text() == jmigrate.migrate_text(old.read_text())[0]
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.train", "-cfg", str(migrated),
                        "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, f"STDOUT:{r.stdout[-1500:]}\nSTDERR:{r.stderr[-2500:]}"
    assert json.loads((runs / "classes.json").read_text()) == ["cat", "dog"]
    assert (runs / "weights" / "last").is_dir() and (runs / "weights" / "best.pt").exists()


def test_cli_check_fails_on_a_bad_config(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("criterion = 5\n")
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.utils.migrate", str(bad), "-o",
                        str(tmp_path / "out.py"), "--check"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 1 and "CHECK FAILED: criterion" in r.stderr
