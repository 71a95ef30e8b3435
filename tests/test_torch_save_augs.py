"""The port's ``save_augs`` (``python -m nkbx_torch.save_augs``) against
nkbx's ``save_augs.py``, on the CPU.

- A config whose device stage has no random op (resize, pad, Normalize):
  the PNGs hold nkbx's un-normalised batch, within 1 grey level (the host
  stages agree exactly; Normalize and its inverse round in f32).
- A config with random device ops (flip, brightness/contrast, Normalize):
  the PNGs hold the port's device stage on the same draws, a generator
  seeded 0 over the loader's batches, exactly.
- Without Normalize the stage's 0..255 output is written as it is.
- The CLI in a subprocess writes N files, going on into the next epoch
  where one epoch's valid rows are fewer (padded rows are not written).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from nkbx.data import get_dataset as jget_dataset
from nkbx.utils import load_config as jload_config
from nkbx_torch.data import get_dataset, imread_rgb
from nkbx_torch.logging.experiment import write_png
from nkbx_torch.save_augs import save_augs, unnormalize_params
from nkbx_torch.utils import load_config

REPO = Path(__file__).resolve().parent.parent

CONFIG = '''\
import nkbx.transforms as T

train_data = {{"type": "ImageFolder", "root": "{root}", "batch_size": 4, "shuffle": False,
              "num_workers": 0, "drop_last": False}}
train_pipeline = T.Compose([T.LongestMaxSize(24), T.PadIfNeeded(24, 24){extra}])
'''
PLAIN = ", T.Normalize()"
RANDOM = (", T.HorizontalFlip(p=0.5), T.RandomBrightnessContrast(p=0.8), "
          "T.Normalize(mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))")


def _config(tmp_path, extra, n=5):
    root = tmp_path / "data" / "c0"
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = int(rng.integers(16, 40)), int(rng.integers(16, 40))
        write_png(root / f"{i}.png", rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    cfg = tmp_path / f"cfg{abs(hash(extra)) % 1000}.py"
    cfg.write_text(CONFIG.format(root=tmp_path / "data", extra=extra))
    return cfg


def _written(out, n):
    return [imread_rgb(str(out / f"aug_{i}.png")) for i in range(n)]


def test_no_random_op_gives_nkbx_batch(tmp_path):
    cfg = _config(tmp_path, PLAIN)
    assert save_augs(load_config(cfg), 5, tmp_path / "out", torch.device("cpu")) == 5
    jcfg = jload_config(str(cfg))
    loader = jget_dataset(jcfg.train_data, jcfg.train_pipeline)
    pipe = loader.pipeline
    norm = pipe.device_transforms[-1]
    want = []
    for batch in loader.epoch(0):
        aug = np.asarray(pipe.device_apply(batch["image"], jax.random.PRNGKey(0)))
        imgs = np.clip((aug * np.asarray(norm.std) + np.asarray(norm.mean))
                       * norm.max_pixel_value, 0, 255).astype(np.uint8)
        want += [im for im, v in zip(imgs, batch["mask"]) if v]
    got = _written(tmp_path / "out", 5)
    assert len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == (24, 24, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_random_ops_give_the_port_stage_on_the_same_draws(tmp_path):
    cfg = load_config(_config(tmp_path, RANDOM, n=7))
    assert save_augs(cfg, 6, tmp_path / "out", torch.device("cpu")) == 6
    loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    mean, std, maxv = unnormalize_params(loader.pipeline)
    g = torch.Generator().manual_seed(0)
    want = []
    for batch in loader.epoch(0):
        aug = loader.pipeline.device_apply(torch.from_numpy(batch["image"]), generator=g).numpy()
        imgs = np.clip((aug * std + mean) * maxv, 0, 255).astype(np.uint8)
        want += [im for im, v in zip(imgs, batch["mask"]) if v]
    got = _written(tmp_path / "out", 6)
    for a, b in zip(got, want[:6]):
        np.testing.assert_array_equal(a, b)
    # the draws did something: some rows differ from the plain stage's
    plain = save_augs(load_config(_config(tmp_path / "p", PLAIN, n=7)), 6, tmp_path / "plain",
                      torch.device("cpu"))
    assert plain == 6 and any(not np.array_equal(a, b) for a, b in
                              zip(got, _written(tmp_path / "plain", 6)))


def test_without_normalize_the_stage_output_is_written(tmp_path):
    cfg = load_config(_config(tmp_path, ""))
    assert unnormalize_params(get_dataset(cfg.train_data, cfg.train_pipeline).pipeline)[2] == 1.0
    save_augs(cfg, 3, tmp_path / "out", torch.device("cpu"))
    loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    first = next(iter(loader.epoch(0)))["image"]
    for a, b in zip(_written(tmp_path / "out", 3), first):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,want", [(3, 3), (9, 9)])
def test_cli(tmp_path, n, want):
    cfg = _config(tmp_path, PLAIN)
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.save_augs", "-cfg", str(cfg), "-n",
                        str(n), "-o", str(out), "--device", "cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"Saved {want} augmented samples to {out}" in r.stdout
    assert sorted(p.name for p in out.iterdir()) == sorted(f"aug_{i}.png" for i in range(want))
