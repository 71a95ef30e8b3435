"""TrainState: the module (f32 master parameters), the optimizer state, the
step count and the device generator of the random device ops (counterpart
of ``nkbx/train/state.py``).

PyTorch runs eagerly and updates in place, so the state is one mutable
object that the train step advances; nothing is donated or copied.

With ``ema=True`` the state also keeps the model's EMA shadow (nkbx's
``ema_params`` and ``ema_batch_stats``): a second module, a copy of the
first that starts at its weights, whose parameters and BatchNorm running
means and variances the train step moves toward the trained ones. The eval
step and the checkpoints take it as a model.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from nkbx_torch.models.classifier import param_labels
from nkbx_torch.train.optim import GROUPS, GroupState, init_opt_state


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    groups: Dict[str, list]  # {"backbone": [params], "classifier": [params]}
    opt_state: Dict[str, GroupState]
    generator: torch.Generator  # on the module's device: flips and other draws
    step: int = 0
    ema_module: Optional[nn.Module] = None  # the EMA shadow, or None
    _ema_pairs: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, model, seed: int = 0, ema: bool = False):
        """State for ``model`` (a ClassificationModel or a module): the
        parameter groups by ``param_labels``, zero moments (every optimizer
        kind keeps the same state), a generator on the parameters' device
        seeded with ``seed``, and with ``ema`` the EMA shadow at the
        module's weights."""
        module = getattr(model, "module", model)
        labels = param_labels(module)
        groups = {g: [p for n, p in module.named_parameters() if labels[n] == g] for g in GROUPS}
        device = next(module.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        state = cls(module, groups, init_opt_state(groups), generator)
        if ema:
            state.ema_module = make_shadow(module)
        return state

    @torch.no_grad()
    def update_ema(self, decay: float):
        """``e <- e * decay + p * (1 - decay)`` over :meth:`ema_pairs`, two
        products and a sum as nkbx rounds them (engine.py:255-265)."""
        shadow, live = self.ema_pairs()
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, torch._foreach_mul(live, 1.0 - decay))

    def ema_pairs(self):
        """(shadow tensors, live tensors): the parameters, then the running
        means and variances, in the module's order (empty without EMA). The
        lists are made once: every update and load writes these tensors in
        place."""
        if self.ema_module is None:
            return [], []
        if self._ema_pairs is None:
            self._ema_pairs = (_averaged(self.ema_module), _averaged(self.module))
        return self._ema_pairs


def make_shadow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` (its weights and buffers, in eval mode, without
    gradients) to hold the EMA."""
    shadow = copy.deepcopy(module).eval()
    for p in shadow.parameters():
        p.requires_grad_(False)
        p.grad = None
    return shadow


_STATS = ("running_mean", "running_var")


def _averaged(module: nn.Module):
    """The tensors of ``module`` that the EMA averages: every parameter and
    the BatchNorm running statistics (nkbx's ``params`` and
    ``batch_stats``), not the integer counters."""
    return ([p.data for p in module.parameters()]
            + [b for n, b in module.named_buffers() if n.rsplit(".", 1)[-1] in _STATS])
