"""Losses: cross-entropy (class weights, label smoothing), focal, multi-task
(counterpart of ``nkbx/train/losses.py``).

Every criterion takes a validity ``mask`` (the loader pads the final batch
to a fixed shape); masked-out rows contribute nothing. Losses are computed
in f32 over f32 logits.

- ``cross_entropy``: torch ``CrossEntropyLoss(weight, label_smoothing)``
  semantics, weighted mean sum(w_y * nll_y) / sum(w_y) over valid rows;
- ``focal_loss``: -alpha_y * (1 - p_y)^gamma * log(p_y), mean over valid,
  unignored rows (0 when there is none);
- ``MultitaskCriterion``: per-target losses plus their sum under ``"loss"``.
"""

from __future__ import annotations

import torch

DEFAULT_FOCAL_GAMMA = 2.0


def _log_softmax(logits):
    return torch.log_softmax(logits.float(), dim=-1)


def cross_entropy(logits, labels, weight=None, mask=None, label_smoothing: float = 0.0):
    """Mean-reduced CE over valid rows. With ``label_smoothing`` the smoothed
    eps/C mass on each class carries that class's weight:
    (1-eps)*w[y]*nll + eps/C * sum_c w_c*(-log p_c), normalised by sum w[y]."""
    log_p = _log_softmax(logits)
    nll = -log_p.gather(-1, labels[:, None].long())[:, 0]
    w = torch.ones_like(nll) if weight is None else weight.to(log_p)[labels.long()]
    if label_smoothing > 0.0:
        wc = torch.ones_like(log_p[0]) if weight is None else weight.to(log_p)
        smooth = (-log_p * wc).sum(-1) / log_p.shape[-1]
        per_sample = (1.0 - label_smoothing) * w * nll + label_smoothing * smooth
    else:
        per_sample = w * nll
    if mask is not None:
        m = mask.to(per_sample.dtype)
        per_sample = per_sample * m
        w = w * m
    return per_sample.sum() / torch.clamp(w.sum(), min=1e-12)


def focal_loss(logits, labels, alpha=None, gamma: float = DEFAULT_FOCAL_GAMMA,
               ignore_index: int = -100, mask=None, reduction: str = "mean"):
    """Focal loss (https://arxiv.org/abs/1708.02002)."""
    log_p = _log_softmax(logits)
    valid = labels != ignore_index
    if mask is not None:
        valid = valid & mask.bool()
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    log_pt = log_p.gather(-1, safe[:, None])[:, 0]
    a = torch.ones_like(log_pt) if alpha is None else alpha.to(log_pt)[safe]
    loss = (1.0 - log_pt.exp()) ** gamma * (-a * log_pt)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    n = valid.float().sum()
    return torch.where(n > 0, loss.sum() / torch.clamp(n, min=1.0), torch.zeros_like(n))


class SingletaskCriterion:
    """Callable (logits, labels, mask) -> scalar loss."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, pred, true, mask=None):
        return self.fn(pred, true, mask=mask)


class MultitaskCriterion:
    """Per-target loss dict plus the summed ``"loss"``, targets in sorted
    order."""

    def __init__(self, criterion: SingletaskCriterion):
        self.criterion = criterion

    def __call__(self, pred: dict, true: dict, mask=None):
        if pred.keys() != true.keys():
            raise KeyError(f"targets differ: {sorted(pred)} vs {sorted(true)}")
        out, total = {}, 0.0
        for name in sorted(pred):
            out[name] = self.criterion(pred[name], true[name], mask=mask)
            total = total + out[name]
        out["loss"] = total
        return out


def get_loss(cfg_loss: dict, device=None):
    """Config -> criterion. ``cfg_loss``: {"task": "single"|"multi", "type":
    "CrossEntropyLoss"|"FocalLoss", optional "weight" and
    "label_smoothing" (CE), "alpha" and "gamma" (focal)}. Class weights live
    on ``device``."""
    kind = cfg_loss["type"]

    def vec(key):
        if key not in cfg_loss:
            return None
        return torch.as_tensor(cfg_loss[key], dtype=torch.float32, device=device)

    if kind == "CrossEntropyLoss":
        weight, smoothing = vec("weight"), float(cfg_loss.get("label_smoothing", 0.0))

        def fn(logits, labels, mask=None):
            return cross_entropy(logits, labels, weight=weight, mask=mask,
                                 label_smoothing=smoothing)
    elif kind == "FocalLoss":
        alpha, gamma = vec("alpha"), cfg_loss.get("gamma", DEFAULT_FOCAL_GAMMA)

        def fn(logits, labels, mask=None):
            return focal_loss(logits, labels, alpha=alpha, gamma=gamma, mask=mask)
    else:
        raise NotImplementedError(f"Unknown loss type in config: {kind}")
    base = SingletaskCriterion(fn)
    return MultitaskCriterion(base) if cfg_loss.get("task", "single") == "multi" else base
