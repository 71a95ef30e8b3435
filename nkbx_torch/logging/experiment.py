"""Experiment logging (counterpart of ``nkbx/logging/experiment.py``):
local files and optional Comet ML.

Locally: the run directory, deduplicated by a numeric suffix, with
``weights/``; ``metrics.csv``, tab-separated, Epoch first and the other
columns sorted, rewritten on every call; ``classes.json``; start-up grids
of the raw uint8 batches as PNG files written with ``zlib`` and ``struct``
(nkbx draws them with matplotlib, which the port does not need).

Comet ML, where a config's ``experiment["comet"]`` section is set:
:func:`get_comet_experiment` imports ``comet_ml`` inside the call (without
it, nkbx's warning and local logging only) and builds the experiment from
the section and its side YAML (``comet_api_cfg_path``: ``api_key``,
``workspace``, ``project_name``). :class:`TrainLogger` then sends nkbx's
epoch fan-out there, in nkbx's order: the epoch's image grids, the
per-target metrics of both folds, the validation confusion matrices (exact,
multi-task or bounded) and the gradient norms.
"""

from __future__ import annotations

import csv
import math
import struct
import warnings
import zlib
from collections import defaultdict
from collections.abc import Sequence
from pathlib import Path

import numpy as np

from nkbx_torch.utils import save_classes

CONFUSION_MAX_CATEGORIES = 25  # Comet's default max_categories, as nkbx passes it


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
    """A Comet ML experiment from a config's ``comet`` section (nkbx
    ``get_comet_experiment``): None for no section, or with a warning where
    ``comet_ml`` does not import. Otherwise the side YAML at
    ``comet_api_cfg_path`` (PyYAML where it imports, else the port's flat
    reader) gives ``api_key``, ``workspace`` and ``project_name``; the other
    keys but ``name`` go to ``Experiment``, then ``set_name(name)``."""
    if cfg_exp is None:
        return None
    try:
        from comet_ml import Experiment as CometExperiment
    except ImportError:
        warnings.warn("comet_ml is not installed; continuing with local logging only")
        return None
    from nkbx_torch.utils.flat_yaml import load_yaml

    cfg_exp = dict(cfg_exp)
    comet_cfg = load_yaml(cfg_exp.pop("comet_api_cfg_path"))
    for key in ("api_key", "workspace", "project_name"):
        cfg_exp[key] = comet_cfg[key]
    name = cfg_exp.pop("name")
    exp = CometExperiment(**cfg_exp)
    exp.set_name(name)
    return exp


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


def log_confusion_matrices(experiment, target_names, classes, epoch, results,
                           fold="validation", show_all=False):
    """The epoch's confusion matrices (nkbx ``log_confusion_matrices``): from
    the labels and predictions of exact results, one a target; from the
    counts of bounded results, which are the matrix. ``max_categories`` is
    the class count with ``show_all``, else Comet's default."""
    def cap(cls):
        return len(cls) if show_all else CONFUSION_MAX_CATEGORIES

    if "bounded_metrics" in results:
        counts = results["confusion_counts"]
        items = ([(None, counts)] if target_names is None
                 else [(t, counts[t]) for t in target_names])
        for t, m in items:
            cls = classes if t is None else classes[t]
            tag = f"{fold} {t} " if t else f"{fold} "
            experiment.log_confusion_matrix(
                matrix=np.asarray(m).tolist(), labels=tuple(map(str, cls)),
                max_categories=cap(cls), title=f"{tag}confusion matrix".replace("  ", " "),
                file_name=f"{tag.strip().replace(' ', '-')}-confusion-matrix.json", epoch=epoch)
        return
    if target_names is None:
        experiment.log_confusion_matrix(
            results["ground_truth"], results["predictions"], labels=tuple(map(str, classes)),
            max_categories=cap(classes), title=f"{fold} confusion matrix",
            file_name=f"{fold}-confusion-matrix.json", epoch=epoch)
        return
    for t in target_names:
        experiment.log_confusion_matrix(
            results["ground_truth"][t], results["predictions"][t],
            labels=tuple(map(str, classes[t])), max_categories=cap(classes[t]),
            title=f"{fold} {t} confusion matrix", file_name=f"{fold}-{t}-confusion-matrix.json",
            epoch=epoch)


def _grad_means(metrics_grad_log) -> dict:
    return {k: float(np.nanmean(v)) for k, v in metrics_grad_log.items()}


def log_grads(experiment, epoch, metrics_grad_log):
    """Each ``Gradients/...`` series of an epoch as its nan-mean, one
    ``log_metric`` a series (nkbx ``log_grads``, Comet's side); returns a
    new empty series log, as nkbx's does."""
    for key, value in _grad_means(metrics_grad_log).items():
        experiment.log_metric(key, value, epoch=epoch, step=epoch)
    return defaultdict(list)


class TrainLogger:
    """Epoch-level logging: ``classes.json`` at start, the start-up image
    grids, and every epoch the local metrics, with the gradient norms'
    ``Gradients/*`` when ``cfg.log_gradients`` is set; then, given a Comet
    experiment, nkbx's fan-out to it (the module's docstring)."""

    def __init__(self, cfg, comet_experiment, local_experiment, classes):
        if cfg.task not in ("single", "multi"):
            raise ValueError(f"Unknown task {cfg.task!r}")
        self.cfg = cfg
        self.task = cfg.task
        self.classes = classes
        self.target_names = sorted(classes) if self.task == "multi" else None
        self.comet_experiment = comet_experiment
        self.local_experiment = local_experiment
        self.show_full_conf_matrix = getattr(cfg, "show_all_classes_in_confusion_matrix", False)
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
        grads = (train_results.get("metrics_grad_log")
                 if getattr(self.cfg, "log_gradients", False) else None)
        if grads is not None:  # one rewrite of metrics.csv
            self.local_experiment.log_metrics(_grad_means(grads), epoch=epoch, step=epoch)
        comet = self.comet_experiment
        if comet is None:
            return
        log_images(comet, "train", epoch, train_results["images"])
        log_images(comet, "validation", epoch, val_results["images"])
        log_metrics(comet, self.target_names, self.classes, epoch, train_results["metrics"],
                    "train")
        log_metrics(comet, self.target_names, self.classes, epoch, val_results["metrics"],
                    "validation")
        log_confusion_matrices(comet, self.target_names, self.classes, epoch, val_results,
                               "validation", self.show_full_conf_matrix)
        if grads is not None:
            log_grads(comet, epoch, grads)
