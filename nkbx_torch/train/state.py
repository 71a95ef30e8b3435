"""TrainState: the module (f32 master parameters), the optimizer state, the
step count and the device generator of the random device ops (counterpart
of ``nkbx/train/state.py``).

PyTorch runs eagerly and updates in place, so the state is one mutable
object that the train step advances; nothing is donated or copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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

    @classmethod
    def create(cls, model, seed: int = 0, ema: bool = False):
        """State for ``model`` (a ClassificationModel or a module): the
        parameter groups by ``param_labels``, zero moments (every optimizer
        kind keeps the same state), and a generator on the parameters'
        device seeded with ``seed``."""
        if ema:
            raise NotImplementedError("EMA of the weights is not ported to nkbx_torch yet "
                                      "(ROADMAP.md)")
        module = getattr(model, "module", model)
        labels = param_labels(module)
        groups = {g: [p for n, p in module.named_parameters() if labels[n] == g] for g in GROUPS}
        device = next(module.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(module, groups, init_opt_state(groups), generator)
