"""NAdam (Dozat 2016) as ``torch.optim.NAdam`` computes it (momentum decay
4e-3, betas 0.9 / 0.999, eps 1e-8), with decoupled weight decay: the
parameter shrinks by ``lr * weight_decay`` before the step."""

from __future__ import annotations

import torch


def make(groups: list) -> torch.optim.Optimizer:
    return torch.optim.NAdam(groups, betas=(0.9, 0.999), eps=1e-8, momentum_decay=4e-3,
                             decoupled_weight_decay=True)
