"""Carry nkbx (flax) weights across to the port.

The port's module names follow the flax tree, so the conversion is a walk:
``params/backbone/stage0_block0/attn/qkv/kernel`` becomes
``backbone.stage0_block0.attn.qkv.weight``. Per leaf:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- attention DenseGeneral ``kernel``: query/key/value (C, H, D) -> ``weight``
  (H*D, C), ``out`` (H, D, C) -> ``weight`` (C, H*D); their (H, D) ``bias``
  -> (H*D,) (nkbx/models/convert.py:486-509 documents the flax layouts);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm and BatchNorm ``scale`` -> ``weight``;
- BatchNorm ``batch_stats`` ``mean`` -> ``running_mean``, ``var`` ->
  ``running_var``;
- other ``bias``, ``relative_position_bias_table``, ``cls_token``,
  ``pos_embed`` and ``layer_scale`` as they are.

A depthwise Conv kernel (kh, kw, 1, C) takes the same rank-4 rule, to the
(C, 1, kh, kw) weight of a grouped ``nn.Conv2d``; so does the ResNet s2d
stem's (4, 4, 12, 64) kernel, to its OIHW (64, 12, 4, 4) weight.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(path: tuple, value: np.ndarray):
    name = path[-1]
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3 and path[-2] == "out":
            return "weight", value.reshape(-1, value.shape[-1]).T
        if value.ndim == 3:
            return "weight", value.reshape(value.shape[0], -1).T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim} has no port layout")
    if name == "scale":
        return "weight", value
    if name == "bias":
        return name, value.reshape(-1)
    if name in ("relative_position_bias_table", "cls_token", "pos_embed", "layer_scale"):
        return name, value
    raise KeyError(f"flax leaf {name!r} has no counterpart in the port")


_STATS = {"mean": "running_mean", "var": "running_var"}


def _stat_leaf(path: tuple, value: np.ndarray):
    if path[-1] not in _STATS:
        raise KeyError(f"flax batch_stats leaf {path[-1]!r} has no counterpart in the port")
    return _STATS[path[-1]], value


def from_jax_variables(variables: dict, reference=None) -> dict:
    """nkbx ``{'params': ..., 'batch_stats': ...}`` tree of numpy arrays -> port
    ``state_dict`` (parameters and running statistics).

    With ``reference`` (a port module or its state_dict), a port entry that
    the tree leaves unset, a converted entry the port does not have, or a
    shape that differs raises."""
    out = {}

    def walk(tree, prefix, leaf):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,), leaf)
            else:
                name, arr = leaf(prefix + (key,), np.asarray(value, np.float32))
                out[".".join(prefix + (name,))] = torch.from_numpy(np.array(arr, order="C"))

    walk(variables["params"], (), _leaf)
    walk(variables.get("batch_stats") or {}, (), _stat_leaf)
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
