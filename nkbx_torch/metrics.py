"""Epoch metrics (counterpart of ``nkbx/metrics.py``): balanced accuracy
and one-vs-rest ROC-AUC, with nkbx's NaN and class-absence semantics.

- multiclass (more than 2 classes): a per-class ROC-AUC vector, NaN for a
  class absent from the ground truth (with a warning), all NaN when fewer
  than two classes are present;
- binary: one ROC-AUC of the positive-class column, NaN when the ground
  truth holds one class;
- ``epoch_loss``: the mean of the per-step losses.

The exact path needs no sklearn: balanced accuracy is the mean recall over
the classes present in the ground truth (sklearn's
``balanced_accuracy_score``), and ROC-AUC is the Mann-Whitney statistic
from average ranks (``scipy.stats.rankdata``), which is the area under the
trapezoidal ROC that sklearn integrates, ties included.

The bounded path folds each batch into O(C^2 + C·N_BINS) counts on the
card (confusion matrix and per-class score histograms): balanced accuracy
exact, ROC-AUC exact for scores on the bin grid and within ~1/N_BINS
otherwise.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

_GT_WARNING = (
    "\nNumber of classes in ground truth is less than number of classes "
    "in predicted confidences.\nSome of ROC AUC metric values will be NaN\n"
)


def balanced_accuracy(ground_truth, predictions) -> float:
    """Mean recall over the classes present in ``ground_truth``."""
    gt, pred = np.asarray(ground_truth), np.asarray(predictions)
    present = np.unique(gt)
    return float(np.mean([np.mean(pred[gt == c] == c) for c in present]))


def roc_auc(is_positive, scores) -> float:
    """Area under the ROC of ``scores`` for the boolean ``is_positive``:
    (sum of the positives' average ranks - P(P+1)/2) / (P·N)."""
    from scipy.stats import rankdata

    pos = np.asarray(is_positive, dtype=bool)
    n_pos = int(pos.sum())
    n_neg = pos.size - n_pos
    ranks = rankdata(np.asarray(scores, dtype=np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _roc_auc(ground_truth, confidences: np.ndarray):
    """Per-class OvR vector for multiclass, a scalar for binary; NaN where
    the ground truth lacks a class."""
    gt = np.asarray(ground_truth)
    n_classes = confidences.shape[1]
    present = np.unique(gt)
    if len(present) < n_classes:
        warnings.warn(_GT_WARNING)
    if n_classes <= 2:
        if len(present) < 2:
            return np.nan
        return roc_auc(gt == 1, confidences[:, 1])
    per_class = np.full(n_classes, np.nan)
    if len(present) > 1:
        for cls in present:
            per_class[cls] = roc_auc(gt == cls, confidences[:, cls])
    return per_class


def compute_targetwise_metrics(epoch_results, target_name=None):
    """Metrics of one target from the exact per-sample epoch results."""

    def pick(key):
        v = epoch_results[key]
        return v if target_name is None else v[target_name]

    confidences = np.array(pick("confidences"))
    ground_truth = pick("ground_truth")
    return {
        "epoch_acc": balanced_accuracy(ground_truth, pick("predictions")),
        "epoch_roc_auc": _roc_auc(ground_truth, confidences),
        "epoch_loss": np.mean(pick("running_loss")),
    }


def compute_metrics(cfg, epoch_results: dict):
    """Single task: one metric dict; multi: per-target dicts and the mean
    balanced accuracy. From the exact results or the bounded ones (the
    ``bounded_metrics`` key)."""
    task = cfg.task if hasattr(cfg, "task") else cfg["task"]
    bounded = epoch_results.get("bounded_metrics")
    if task == "single":
        out = dict(bounded) if bounded is not None else compute_targetwise_metrics(epoch_results)
        out["loss"] = epoch_results["running_loss"]
        return out
    if task == "multi":
        targets = cfg.target_names if hasattr(cfg, "target_names") else cfg["target_names"]
        if bounded is not None:
            out = {t: dict(bounded[t]) for t in targets}
        else:
            out = {t: compute_targetwise_metrics(epoch_results, t) for t in targets}
        out["loss"] = epoch_results["running_loss"]["loss"]
        out["epoch_acc"] = np.mean([out[t]["epoch_acc"] for t in targets])
        return out
    raise ValueError(f"Unknown task type {task} for metric computation")


# --- bounded accumulation on the card -------------------------------------------------

N_BINS = 8192


def make_bounded_state(n_classes: int, device=None):
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "counts": torch.zeros(n_classes, n_classes, **i32),  # [true, pred]
        "pos_hist": torch.zeros(n_classes, N_BINS, **i32),
        "neg_hist": torch.zeros(n_classes, N_BINS, **i32),
        "loss_sum": torch.zeros((), dtype=torch.float32, device=device),
        "n_batches": torch.zeros((), **i32),
    }


@torch.no_grad()
def bounded_update(state, confidences, predictions, ground_truth, mask, loss):
    """Fold one batch into ``state`` (in place, on its device) and return it.
    Takes (B, ...) or stacked (K, B, ...) batches; the loss is a scalar or a
    (K,) vector."""
    n_classes = state["counts"].shape[0]
    confidences = confidences.reshape(-1, n_classes).float()
    valid = mask.reshape(-1).to(torch.int32)
    gt = ground_truth.reshape(-1).long()
    pred = predictions.reshape(-1).long()
    loss = torch.as_tensor(loss, dtype=torch.float32, device=confidences.device)

    state["counts"].index_put_((gt, pred), valid, accumulate=True)
    bins = (confidences * N_BINS).to(torch.int32).clamp(0, N_BINS - 1).long()  # (B, C)
    cls = torch.arange(n_classes, device=bins.device).expand_as(bins)
    is_pos = (gt[:, None] == cls).to(torch.int32) * valid[:, None]
    state["pos_hist"].index_put_((cls, bins), is_pos, accumulate=True)
    state["neg_hist"].index_put_((cls, bins), (1 - is_pos) * valid[:, None], accumulate=True)
    state["loss_sum"] += loss.sum()
    state["n_batches"] += loss.numel()
    return state


def _auc_from_hists(pos, neg):
    """Tie-corrected ROC-AUC from score histograms."""
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        return np.nan
    neg_below = np.concatenate([[0], np.cumsum(neg)[:-1]])
    return float((pos * (neg_below + 0.5 * neg)).sum() / (P * N))


def bounded_targetwise_metrics(state):
    """A target's folded state to the :func:`compute_targetwise_metrics`
    dict, with the exact path's NaN and class-absence semantics."""
    host = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state.items()}
    counts, pos, neg = host["counts"], host["pos_hist"], host["neg_hist"]
    n_classes = counts.shape[0]
    support = counts.sum(axis=1)
    present = support > 0
    with np.errstate(invalid="ignore"):
        recall = np.diag(counts) / support
    epoch_acc = float(np.mean(recall[present]))
    if present.sum() < n_classes:
        warnings.warn(_GT_WARNING)
    if n_classes <= 2:
        roc = np.nan if present.sum() < 2 else _auc_from_hists(pos[1], neg[1])
    else:
        roc = np.full(n_classes, np.nan)
        if present.sum() > 1:
            for c in np.nonzero(present)[0]:
                roc[c] = _auc_from_hists(pos[c], neg[c])
    return {"epoch_acc": epoch_acc, "epoch_roc_auc": roc,
            "epoch_loss": float(host["loss_sum"] / np.maximum(host["n_batches"], 1))}
