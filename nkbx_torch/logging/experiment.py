"""Local experiment logging (counterpart of ``nkbx/logging/experiment.py``,
local only): the run directory, deduplicated by a numeric suffix, with
``weights/``; ``metrics.csv``, tab-separated, Epoch first and the other
columns sorted, rewritten on every call; ``classes.json``; start-up grids
of the raw uint8 batches as PNG files written with ``zlib`` and ``struct``
(nkbx draws them with matplotlib, which the port does not need). The port
logs nothing to Comet: a config's ``comet`` section raises (ROADMAP.md,
A5's rest).
"""

from __future__ import annotations

import csv
import math
import struct
import zlib
from collections.abc import Sequence
from pathlib import Path

import numpy as np

from nkbx_torch.utils import save_classes

COMET_ERROR = ("nkbx_torch logs locally only (metrics.csv, classes.json, image grids); "
               "set experiment['comet'] = None (Comet logging: ROADMAP.md, A5)")


def write_png(path, image: np.ndarray):
    """A uint8 (H, W, 3) RGB or (H, W) grey image as an 8-bit PNG."""
    arr = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))  # filter 0 on every row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _cell(value) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return repr(float(value)) if isinstance(value, (float, np.floating)) else str(value)


class LocalExperiment:
    def __init__(self, path=""):
        self.path = Path(path)
        self.rows: dict = {}  # {epoch: {column: value}}

    def log_image(self, image, name="", step=0):
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        write_png(self.path / f"{name}_{step}.png", arr)

    def _set(self, name, value, epoch, prefix):
        if prefix is not None:
            name = f"{prefix}/{name}"
        if isinstance(value, Sequence) and not isinstance(value, str):
            value = np.mean(value)
        self.rows.setdefault(epoch, {})[name] = value

    def _write(self):
        columns = sorted({c for row in self.rows.values() for c in row})
        with open(self.path / "metrics.csv", "w", newline="") as f:
            out = csv.writer(f, delimiter="\t", lineterminator="\n")
            out.writerow(["Epoch", *columns])
            for e in sorted(self.rows):
                out.writerow([e, *(_cell(self.rows[e].get(c)) for c in columns)])

    def log_metric(self, name, value, epoch=0, step=None, prefix=None):
        self._set(name, value, epoch, prefix)
        self._write()

    def log_metrics(self, metrics_dict, epoch=0, step=None, prefix=None):
        for name, value in metrics_dict.items():
            self._set(name, value, epoch, prefix)
        self._write()


def get_local_experiment(cfg_exp):
    """A new run directory from ``cfg_exp["path"]`` (a numeric suffix when
    it exists), with ``weights/``."""
    if cfg_exp is None or "path" not in cfg_exp:
        raise ValueError("experiment['local'] needs a 'path'")
    exp_path = Path(cfg_exp["path"])
    n = 1
    while exp_path.exists():
        exp_path = Path(str(cfg_exp["path"]) + str(n))
        n += 1
    exp_path.mkdir(parents=True)
    (exp_path / "weights").mkdir()
    return LocalExperiment(exp_path)


def get_comet_experiment(cfg_exp):
    """None for no Comet section; the port has no Comet logging, so a
    section raises."""
    if cfg_exp is not None:
        raise NotImplementedError(COMET_ERROR)
    return None


def make_image_grid(batch, nrow=8, padding=2):
    """A uint8 NHWC batch as one grid image."""
    batch = np.asarray(batch)
    n, h, w, c = batch.shape
    ncol = min(nrow, n)
    nr = -(-n // ncol)
    grid = np.zeros((nr * (h + padding) + padding, ncol * (w + padding) + padding, c),
                    dtype=batch.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = batch[i]
    return grid


def log_images(experiment, name, epoch, batch_to_log):
    if batch_to_log is None:
        return
    experiment.log_image(make_image_grid(batch_to_log), name=name, step=epoch)


def log_targetwise_metrics(experiment, target_name, classes, epoch, metrics, fold="train"):
    target_name = target_name or ""
    acc, roc_auc = metrics["epoch_acc"], metrics["epoch_roc_auc"]
    epoch_loss = metrics["epoch_loss"]
    experiment.log_metric(f"{target_name} Average epoch {fold} loss".lstrip(), epoch_loss,
                          epoch=epoch, step=epoch)
    if len(classes) > 2:
        for roc_auc_, class_name in zip(roc_auc, classes):
            experiment.log_metric(f"{target_name} {fold} ROC AUC, {class_name}".lstrip(),
                                  roc_auc_, epoch=epoch, step=epoch)
        mean_roc_auc = np.nan if np.all(np.isnan(roc_auc)) else np.nanmean(roc_auc)
        experiment.log_metric(f"{target_name} {fold} ROC AUC".lstrip(), mean_roc_auc,
                              epoch=epoch, step=epoch)
    else:
        experiment.log_metric(f"{target_name} {fold} ROC AUC".lstrip(), roc_auc, epoch=epoch,
                              step=epoch)
    experiment.log_metric(f"{target_name} {fold} balanced accuracy".lstrip(), acc, epoch=epoch,
                          step=epoch)


def log_metrics(experiment, target_names, classes, epoch, metrics, fold="train"):
    if target_names is None:
        log_targetwise_metrics(experiment, None, classes, epoch, metrics, fold)
    else:
        for t in target_names:
            log_targetwise_metrics(experiment, t, classes[t], epoch, metrics[t], fold)
    experiment.log_metric(f"{fold} loss", np.mean(metrics["loss"]), epoch=epoch, step=epoch)
    experiment.log_metric(f"{fold} balanced accuracy", metrics["epoch_acc"], epoch=epoch,
                          step=epoch)


def log_grads(experiment, epoch, metrics_grad_log):
    """Each ``Gradients/...`` series of an epoch as its nan-mean (nkbx
    ``log_grads``, which logs them to Comet)."""
    experiment.log_metrics({k: float(np.nanmean(v)) for k, v in metrics_grad_log.items()},
                           epoch=epoch, step=epoch)


class TrainLogger:
    """Epoch-level logging: ``classes.json`` at start, the start-up image
    grids, and the local metrics of every epoch, with the gradient norms'
    ``Gradients/*`` when ``cfg.log_gradients`` is set."""

    def __init__(self, cfg, comet_experiment, local_experiment, classes):
        if cfg.task not in ("single", "multi"):
            raise ValueError(f"Unknown task {cfg.task!r}")
        if comet_experiment is not None:
            raise NotImplementedError(COMET_ERROR)
        self.cfg = cfg
        self.task = cfg.task
        self.classes = classes
        self.target_names = sorted(classes) if self.task == "multi" else None
        self.local_experiment = local_experiment
        save_classes(self.classes, self.local_experiment.path / "classes.json")

    def log_images_at_start(self, loader, n_batches=3):
        for batch_num, batch in enumerate(loader.epoch(0)):
            if batch_num + 1 > n_batches:
                break
            log_images(self.local_experiment, "train_batch", batch_num + 1, batch["image"])

    def log_epoch(self, epoch, train_results, val_results):
        log_metrics(self.local_experiment, self.target_names, self.classes, epoch,
                    train_results["metrics"], "train")
        log_metrics(self.local_experiment, self.target_names, self.classes, epoch,
                    val_results["metrics"], "Val")
        if getattr(self.cfg, "log_gradients", False) and "metrics_grad_log" in train_results:
            log_grads(self.local_experiment, epoch, train_results["metrics_grad_log"])
