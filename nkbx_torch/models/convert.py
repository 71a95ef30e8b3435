"""Carry nkbx (flax) weights across to the port.

The port's module names follow the flax tree, so the conversion is a walk:
``params/backbone/stage0_block0/attn/qkv/kernel`` becomes
``backbone.stage0_block0.attn.qkv.weight``. Per leaf:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``;
- ``bias`` and ``relative_position_bias_table`` as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim} has no port layout")
    if name == "scale":
        return "weight", value
    if name in ("bias", "relative_position_bias_table"):
        return name, value
    raise KeyError(f"flax leaf {name!r} has no counterpart in the port")


def from_jax_variables(variables: dict, reference=None) -> dict:
    """nkbx ``{'params': ...}`` tree of numpy arrays -> port ``state_dict``.

    With ``reference`` (a port module or its state_dict), a port entry that
    the tree leaves unset, a converted entry the port does not have, or a
    shape that differs raises."""
    stats = variables.get("batch_stats")
    if stats:
        raise NotImplementedError("batch_stats have no counterpart in the ported families")
    out = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            else:
                name, arr = _leaf(key, np.asarray(value, np.float32))
                out[".".join(prefix + (name,))] = torch.from_numpy(np.array(arr, order="C"))

    walk(variables["params"], ())
    if reference is not None:
        ref = reference.state_dict() if hasattr(reference, "state_dict") else reference
        missing = sorted(set(ref) - set(out))
        leftover = sorted(set(out) - set(ref))
        if missing or leftover:
            raise KeyError(f"flax tree and port differ: missing {missing}, "
                           f"leftover {leftover}")
        bad = [k for k in ref if tuple(ref[k].shape) != tuple(out[k].shape)]
        if bad:
            raise ValueError("shape mismatch: " + ", ".join(
                f"{k} port {tuple(ref[k].shape)} vs flax {tuple(out[k].shape)}" for k in bad))
    return out
