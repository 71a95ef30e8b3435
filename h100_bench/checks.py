"""The numbers that decide ``correct``, each held to its limit.

Training (the first three steps of the window's own step function against
the plain float32 reference from the same weights, batches and flips):

- ``loss_gap``: the largest of the three steps' |loss - reference loss| /
  |reference loss|;
- ``grad_gap``: the first step's gradient as the optimizer got it, by the
  worst leaf: |norm - reference norm| / max(reference norm of the leaf,
  the median leaf's reference norm);
- ``change_gap``: the same of each parameter's change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf whose gradient is nought but for rounding,
  such as an attention key's bias under softmax, moves under NAdam by
  round-off alone).

Serving (a seeded sample of the window's requests, the largest among
them, against the reference's forward of the same images):

- ``logit_gap``: the widest |logit - reference logit| of an image, over
  the root mean square of that image's reference logits, the worst image.

A limit file (``limits/<cell>.json``) gives each number's limit and the
readings it was set from.
"""

from __future__ import annotations

import math
import statistics

import torch


def norms(tensors: dict) -> dict:
    """{name: float64 L2 norm}."""
    names = list(tensors)
    vals = torch._foreach_norm([tensors[n].detach().float() for n in names], 2)
    return dict(zip(names, (float(v) for v in torch.stack(vals).double().cpu())))


def change_norms(after: dict, before: dict) -> dict:
    return {n: float(torch.linalg.vector_norm((after[n].detach().double() - before[n].double())))
            for n in before}


def worst_leaf_gap(prog: dict, ref: dict, names=None) -> tuple:
    """(gap, leaf): the largest |prog norm - ref norm| / max(ref norm,
    median ref norm) over ``names`` (every leaf by default)."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[n] for n in ref)
    worst = (0.0, "")
    for n in names:
        den = max(ref[n], med, 1e-30)
        gap = abs(prog[n] - ref[n]) / den
        if not math.isfinite(prog[n]):
            gap = math.inf
        if gap > worst[0] or not worst[1]:
            worst = (gap, n)
    return worst


def moved_leaves(ref_grad_norms: dict, floor: float = 1e-3) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [n for n, v in ref_grad_norms.items() if v >= floor * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (three floats), ``grad_norms`` and
    ``change_norms`` ({leaf: norm})."""
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad_norms"], ref["grad_norms"])
    moved = moved_leaves(ref["grad_norms"])
    change_gap, change_leaf = worst_leaf_gap(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_where": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "leaves_left_out": len(ref["grad_norms"]) - len(moved)}}


def logit_gap(prog_logits, ref_logits) -> float:
    """Worst image's widest |logit gap| over its reference logits' RMS."""
    worst = 0.0
    for p, r in zip(prog_logits, ref_logits):
        p, r = p.double(), r.double()
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            return math.inf
        rms = r.square().mean(dim=1).sqrt().clamp(min=1e-30)
        worst = max(worst, float(((p - r).abs().amax(dim=1) / rms).max()))
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(every number under its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
             if not k.startswith("_")}
    ok = all(math.isfinite(s["value"]) and s["value"] <= s["limit"] for s in shown.values())
    return ok, shown
