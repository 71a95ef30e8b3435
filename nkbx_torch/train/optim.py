"""Optimizers and LR schedules with nkbx's semantics (counterpart of
``nkbx/train/optim.py``).

Two parameter groups, backbone and classifier (``param_labels``), each with
its own lr and weight decay; the kinds adam / sparse_adam (dense adam) /
radam / nadam / sgd; the epoch schedules step / multistep / cosine.

As in nkbx, each kind computes a unit-lr update *direction*, and the step
scales it by ``-lr_group * lr_factor * freeze_scale`` (the freeze scale only
for the backbone), so schedule changes and freeze flips need no optimizer
surgery. The directions are plain tensor functions that mirror nkbx's
optax chains term by term (optax ``scale_by_adam``/``scale_by_radam``
defaults, nkbx's torch-exact NAdam), held to nkbx by a lockstep test:

- adam / radam / sgd: coupled weight decay, wd*p added to the gradient
  before the freeze mask, so a frozen group feeds zeros into its moments
  (``torch.optim``'s own ``weight_decay`` would keep feeding wd*p at lr 0);
- nadam: decoupled weight decay, wd*p added to the direction, which the lr
  scaling (and so the freeze) then gates;
- sgd is nkbx's ``optax.identity()``: plain gradient steps. A config's
  ``momentum`` is ignored there and here (a fault of the reference that
  the port keeps, ROADMAP.md section C).

bf16 master parameters (``TrainState.create(master_dtype=torch.bfloat16)``,
nkbx's ``bf16_master_weights``) keep bf16 moments, and the direction rounds
to bf16 where optax's does: the moments as ``(1 - b) * g + b * m`` (three
roundings), the bias corrections and wd first rounded to bf16 (JAX's
weak-typed Python scalars), the coupled wd as ``g + wd * p`` (two
roundings). The step ``p - lr * lr_factor * freeze * u`` is computed in f32
and rounded once, as nkbx's trainer does with its f32 ``lr_factor`` and
``freeze_scale`` arrays. f32 parameters keep the fused foreach forms.

Freeze semantics (``freeze_scale`` 0 freezes the backbone): ``"decay"``
feeds the frozen group zero gradients, so its Adam moments decay;
``"torch"`` skips the frozen group entirely, so its moments and step count
stay where they were, as torch does for ``requires_grad=False`` params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple

import torch

GROUPS = ("backbone", "classifier")
_COUPLED_WD = {"adam", "radam", "sparse_adam", "sgd"}
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_NADAM_PSI = 4e-3


class OptimizerBundle(NamedTuple):
    kind: str  # adam | sparse_adam | radam | nadam | sgd
    lrs: dict  # {"backbone": lr, "classifier": lr}
    coupled_wds: dict  # wd added to the gradient (adam, radam, sgd)
    decoupled_wds: dict  # wd added to the direction (nadam)


@dataclasses.dataclass
class GroupState:
    """One group's optimizer state: the step count, Adam's moments (one
    tensor per parameter), and NAdam's running product of momenta."""

    count: int = 0
    mu: List[torch.Tensor] = dataclasses.field(default_factory=list)
    nu: List[torch.Tensor] = dataclasses.field(default_factory=list)
    mu_product: float = 1.0


def get_optimizer(cfg_optimizer: dict) -> OptimizerBundle:
    """Two-group optimizer from an nkbx config: ``type``, ``lr`` and
    ``weight_decay``, each overridable per group (``backbone_lr``,
    ``classifier_weight_decay``, ...)."""
    kind = cfg_optimizer["type"].lower()
    if kind not in _DIRECTIONS:
        raise NotImplementedError(f"Unknown optimizer in config: {cfg_optimizer['type']}")
    base_lr = cfg_optimizer.get("lr", 0.001)
    base_wd = cfg_optimizer.get("weight_decay", 0.0)
    lrs = {g: float(cfg_optimizer.get(f"{g}_lr", base_lr)) for g in GROUPS}
    wds = {g: float(cfg_optimizer.get(f"{g}_weight_decay", base_wd)) for g in GROUPS}
    coupled = kind in _COUPLED_WD
    return OptimizerBundle(kind=kind, lrs=lrs,
                           coupled_wds={g: wds[g] if coupled else 0.0 for g in GROUPS},
                           decoupled_wds={g: 0.0 if coupled else wds[g] for g in GROUPS})


def init_opt_state(groups: Dict[str, list]) -> Dict[str, GroupState]:
    """Zero moments for every parameter of ``groups`` ({label: [params]});
    every kind keeps the same state."""
    return {label: GroupState(mu=[torch.zeros_like(p) for p in params],
                              nu=[torch.zeros_like(p) for p in params])
            for label, params in groups.items()}


def _c(x: float, like: list) -> float:
    """The scalar ``x`` as the tensors of ``like`` see it: rounded to their
    dtype, as JAX rounds a weak-typed Python scalar (f32 tensors round it
    themselves)."""
    dt = like[0].dtype
    return x if dt == torch.float32 else float(torch.tensor(x, dtype=dt))


def _lowp(ts: list) -> bool:
    return bool(ts) and ts[0].dtype != torch.float32


def _moments(st: GroupState, g):
    """Adam's moment updates (optax ``update_moment``): mu <- b1 mu +
    (1-b1) g, nu <- b2 nu + (1-b2) g²; returns the new step count."""
    st.count += 1
    if _lowp(st.mu):
        for m, gm, b in ((st.mu, g, _B1), (st.nu, torch._foreach_mul(g, g), _B2)):
            new = torch._foreach_mul(gm, _c(1.0 - b, m))
            torch._foreach_mul_(m, _c(b, m))
            torch._foreach_add_(m, new)
        return st.count
    torch._foreach_mul_(st.mu, _B1)
    torch._foreach_add_(st.mu, g, alpha=1.0 - _B1)
    torch._foreach_mul_(st.nu, _B2)
    torch._foreach_addcmul_(st.nu, g, g, value=1.0 - _B2)
    return st.count


def _adam_ratio(st: GroupState, t: int):
    """mu_hat / (sqrt(nu_hat) + eps), bias-corrected at step t."""
    num = torch._foreach_div(st.mu, _c(1.0 - _B1 ** t, st.mu))
    den = torch._foreach_sqrt(torch._foreach_div(st.nu, _c(1.0 - _B2 ** t, st.nu)))
    torch._foreach_add_(den, _EPS)
    torch._foreach_div_(num, den)
    return num


def _adam(g, st, params, wd):
    return _adam_ratio(st, _moments(st, g))


def _radam(g, st, params, wd):
    """optax ``scale_by_radam``: the rectified ratio once the variance is
    tractable (rho >= 5), else the bias-corrected first moment."""
    t = _moments(st, g)
    ro_inf = 2.0 / (1.0 - _B2) - 1.0
    b2t = _B2 ** t
    ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
    if ro < 5.0:
        return torch._foreach_div(st.mu, _c(1.0 - _B1 ** t, st.mu))
    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
    out = _adam_ratio(st, t)
    torch._foreach_mul_(out, r)
    return out


def _nadam(g, st, params, wd):
    """torch-exact NAdam (nkbx ``scale_by_torch_nadam``, optim.py:56-99):
    annealed momentum mu_t = b1 (1 - 0.5 * 0.96^(t psi)), bias-corrected by
    the running product of the mu_i; then decoupled weight decay."""
    t = _moments(st, g)
    mu_t = _B1 * (1.0 - 0.5 * 0.96 ** (t * _NADAM_PSI))
    mu_t1 = _B1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * _NADAM_PSI))
    st.mu_product *= mu_t
    m_hat = torch._foreach_mul(st.mu, mu_t1 / (1.0 - st.mu_product * mu_t1))
    torch._foreach_add_(m_hat, g, alpha=(1.0 - mu_t) / (1.0 - st.mu_product))
    den = torch._foreach_sqrt(torch._foreach_div(st.nu, 1.0 - _B2 ** t))
    torch._foreach_add_(den, _EPS)
    torch._foreach_div_(m_hat, den)
    if wd:
        torch._foreach_add_(m_hat, params, alpha=wd)
    return m_hat


def _sgd(g, st, params, wd):
    return g


_DIRECTIONS: Dict[str, Callable] = {"adam": _adam, "sparse_adam": _adam, "radam": _radam,
                                    "nadam": _nadam, "sgd": _sgd}


@torch.no_grad()
def apply_updates(bundle: OptimizerBundle, opt_state: Dict[str, GroupState],
                  groups: Dict[str, list], lr_factor: float, freeze_scale: float,
                  freeze_semantics: str = "decay"):
    """One optimizer step over ``groups`` ({label: [params]}) from their
    ``.grad`` (None counts as zeros; the grads are not modified): coupled wd,
    the freeze mask, the direction, then ``p -= lr_group * lr_factor *
    freeze * direction``. Returns {label: [gradients]} after the coupled wd
    and the freeze mask, the gradients nkbx logs (``log_gradients``)."""
    out = {}
    for label, params in groups.items():
        if not params:
            continue
        fs = float(freeze_scale) if label == "backbone" else 1.0
        g = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        wd = bundle.coupled_wds[label]
        if wd and _lowp(params):
            g = torch._foreach_add(g, torch._foreach_mul(params, _c(wd, params)))
        elif wd:
            g = torch._foreach_add(g, params, alpha=wd)
        if fs != 1.0:
            g = torch._foreach_mul(g, fs)
        out[label] = g
        if freeze_semantics == "torch" and fs == 0.0:
            continue  # torch skips frozen params: stale moments and step count
        u = _DIRECTIONS[bundle.kind](g, opt_state[label], params, bundle.decoupled_wds[label])
        step = bundle.lrs[label] * float(lr_factor) * fs
        if step and _lowp(params) and params[0].device.type == "cpu":
            # the CPU rounds ``alpha`` to bf16 first; the card's foreach add,
            # like this form, takes p + alpha * u in f32 and rounds once
            for p, x in zip(params, u):
                p.copy_(p.float().add_(x, alpha=-step))
        elif step:
            torch._foreach_add_(params, u, alpha=-step)
    return out


# --- epoch LR schedules (stepped once per epoch) -------------------------------


def get_scheduler(lr_policy: dict) -> Callable[[int], float]:
    """factor(epoch), the multiplicative LR factor."""
    if not lr_policy:
        return lambda epoch: 1.0
    kind = lr_policy["type"]
    if kind == "step":
        step_size, gamma = lr_policy["step_size"], lr_policy["gamma"]
        return lambda epoch: gamma ** (epoch // step_size)
    if kind == "multistep":
        steps, gamma = sorted(lr_policy["steps"]), lr_policy["gamma"]
        return lambda epoch: gamma ** sum(1 for s in steps if epoch >= s)
    if kind == "cosine":
        t_max = lr_policy["n_epochs"]
        return lambda epoch: 0.5 * (1.0 + math.cos(math.pi * epoch / t_max))
    raise NotImplementedError(f"Learning rate policy {kind} not implemented.")


def backbone_state_factor(backbone_state_policy: dict, epoch: int, prev: float = 1.0) -> float:
    """The freeze scale of an epoch from a {epoch: 'freeze'|'unfreeze'}
    policy: the entry at the largest key <= epoch wins, else ``prev``."""
    state = None
    for e in sorted(k for k in backbone_state_policy if k <= epoch):
        state = backbone_state_policy[e]
    if state is None:
        return prev
    return 0.0 if state == "freeze" else 1.0
