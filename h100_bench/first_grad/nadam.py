"""The first gradient as NAdam got it, worked out from the program's
optimizer state after one step: the first moment is then (1 - beta1) g
(beta1 = 0.9; nadam's weight decay is decoupled, so the moment saw the
bare gradient)."""

from __future__ import annotations

BETA1 = 0.9


def first_gradient(state) -> dict:
    """{parameter name: gradient} of the train state after its first step."""
    out = {}
    for group, names in state.names.items():
        for name, mu in zip(names, state.opt_state[group].mu):
            out[name] = mu / (1.0 - BETA1)
    return out
