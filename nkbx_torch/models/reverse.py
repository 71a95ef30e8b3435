"""nkbx trees back to the torch layouts (counterpart of
``nkbx/models/reverse.py``): a timm/torchvision/unicom backbone
``state_dict``, or a whole reference classifier (``emb_model.*`` +
``classifier[.<t>].1.*``).

Every forward converter of :mod:`nkbx_torch.models.convert` is an element
permutation of the torch tensors (transposes, reshapes, slices, the s2d
stem's regroup), so the inverse is traced, not written per family: the
template of :mod:`nkbx_torch.models.torch_ref` is filled with unique int64
element ids, the port's own ``convert_torch_state_dict`` runs once, and
where the ids land is the inverse map. Id 0 marks what the converter
synthesises (the s2d stem's dead taps, the zero bias of a bias-free conv):
it is dropped on the way back. A converter that duplicates or only partly
consumes a tensor fails loudly. The ids stay int64 through the converter
(it passes dtypes through); ``load_torch_checkpoint`` and
``from_jax_variables`` cast to float32 and are kept off this path.

Keys the forward conversion never consumes (heads nkbx replaces,
``num_batches_tracked``, Swin's recomputed buffers) are not emitted: load
the result with ``strict=False``; ``skipped`` lists them.

:func:`load_weights` reads what the port and nkbx train: the port's
``weights/best.pt``/``last.pt``, its ``weights/best/``/``last/`` directories
(``train_state.pt``; ``ema=True`` takes the EMA shadow), and an nkbx
``.msgpack``. An orbax directory raises: the port reads no orbax.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from nkbx_torch.models import convert


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _lookup(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(
                f"converted tree is missing {'/'.join(path)} — was the model "
                f"trained with non-default structure flags (e.g. a ResNet "
                f"with s2d_stem=False)? The reverse trace assumes the same "
                f"structure convert_torch_state_dict produces.")
        node = node[p]
    return node


def template_state_dict(name: str):
    """The torch-layout template of backbone ``name``: its replica's
    ``state_dict``, on the meta device (keys, shapes and dtypes only)."""
    from nkbx_torch.models.torch_ref import build_replica

    with torch.device("meta"):
        return build_replica(name).state_dict()


def reverse_state_dict(template, forward, converted, name: str):
    """The inverse of ``forward`` (a ``{key: array} -> {'params',
    'batch_stats'}`` converter) applied to ``converted``, traced through the
    ``template`` state dict. Returns ``(state_dict, skipped)``: float numpy
    arrays in the template's dtypes, and the template keys with no source."""
    trace_sd, spans, total = {}, {}, 1  # id 0: synthesised, no torch source
    for k, v in template.items():
        n = v.numel()
        trace_sd[k] = np.arange(total, total + n, dtype=np.int64).reshape(tuple(v.shape))
        spans[k] = (total, total + n)
        total += n
    traced = forward(trace_sd)

    # float32 carries every consumed leaf exactly: each is a float32 tensor of
    # the template (integer buffers are never consumed; checked below)
    flat = np.zeros(total, dtype=np.float32)
    written = np.zeros(total, dtype=bool)
    traced_paths = {path for path, _ in _walk(traced)}
    extra = [p for p, _ in _walk(converted) if p not in traced_paths]
    if extra:
        raise ValueError(
            f"the converted tree holds leaves the {name!r} forward converter "
            f"never produces ({', '.join('/'.join(p) for p in extra[:5])}"
            f"{', ...' if len(extra) > 5 else ''}) — wrong --model for these "
            f"weights? Silently dropping them would corrupt the export.")
    for path, ids in _walk(traced):
        ids = np.asarray(ids)
        val = np.asarray(_lookup(converted, path))
        if ids.shape != tuple(val.shape):
            raise ValueError(f"shape mismatch at {'/'.join(path)}: converter produces "
                             f"{ids.shape}, converted tree holds {val.shape}")
        ids, val = ids.ravel(), val.astype(np.float32).ravel()
        if not np.issubdtype(ids.dtype, np.integer):
            # a leaf the converter synthesised wholesale: no torch slot for it
            if np.any(val):
                warnings.warn(
                    f"{'/'.join(path)} has no torch-side tensor (the forward "
                    f"conversion synthesizes it) but carries trained non-zero "
                    f"values — they cannot be represented in the {name!r} "
                    f"torch layout and are dropped", stacklevel=3)
            continue
        live = ids > 0
        if written[ids[live]].any():
            raise ValueError(
                f"{'/'.join(path)} re-places torch elements another leaf "
                f"already carried — the forward converter duplicates source "
                f"elements (weight tying?) and is no longer a permutation; "
                f"the generic reverse cannot decide which trained copy wins")
        flat[ids[live]] = val[live]
        written[ids[live]] = True

    out, skipped = {}, []
    for k, v in template.items():
        lo, hi = spans[k]
        w = written[lo:hi]
        if hi == lo or not w.any():
            skipped.append(k)
            continue
        if not w.all():
            raise ValueError(
                f"template key {k!r} is only partially consumed by the "
                f"forward converter ({int(w.sum())}/{hi - lo} elements) — "
                f"the conversion is no longer a per-key permutation and the "
                f"generic reverse cannot invert it")
        if not v.dtype.is_floating_point:
            raise ValueError(
                f"template key {k!r} is {v.dtype} but was consumed by the "
                f"forward converter — the float32 scatter path only supports "
                f"floating-point weights")
        out[k] = flat[lo:hi].reshape(tuple(v.shape)).astype(
            torch.empty((), dtype=v.dtype).numpy().dtype)
    return out, skipped


def reverse_torch_state_dict(name: str, converted):
    """nkbx backbone tree (``{'params', 'batch_stats'}``) -> timm-layout
    ``state_dict`` of float numpy arrays and the ``skipped`` template keys
    (torch's ``missing_keys`` on a ``strict=False`` load)."""
    return reverse_state_dict(template_state_dict(name),
                              lambda sd: convert.convert_torch_state_dict(name, sd),
                              converted, name)


def reverse_reference_checkpoint(backbone_name: str, variables):
    """nkbx classifier variables (``params.backbone`` + ``head`` or
    ``head_<t>``) -> the reference classifier's state dict: ``emb_model.*``
    and ``classifier.1.{weight,bias}`` (single task) or
    ``classifier.<t>.1.*``. Returns ``(state_dict, skipped)``."""
    params = variables["params"]
    if "backbone" not in params:
        raise ValueError(
            "expected full classifier variables with a 'backbone' subtree — "
            "for a bare backbone tree use reverse_torch_state_dict")
    backbone_sd, skipped = reverse_torch_state_dict(
        backbone_name, {"params": params["backbone"],
                        "batch_stats": dict(variables.get("batch_stats") or {}).get(
                            "backbone", {})})
    out = {f"emb_model.{k}": v for k, v in backbone_sd.items()}
    heads = {k: v for k, v in params.items() if k.startswith("head")}
    if not heads:
        raise ValueError("no 'head'/'head_<target>' subtree in params")
    for hk, head in heads.items():
        # Dense (in, out) -> Linear (out, in), at index 1 of Sequential(Dropout, Linear)
        prefix = "classifier.1" if hk == "head" else f"classifier.{hk[len('head_'):]}.1"
        out[f"{prefix}.weight"] = np.ascontiguousarray(
            np.asarray(head["kernel"], dtype=np.float64).T.astype(np.float32))
        out[f"{prefix}.bias"] = np.asarray(head["bias"], dtype=np.float32)
    return out, [f"emb_model.{k}" for k in skipped]


def _no_ema(path):
    return ValueError(
        f"{path} holds no separate EMA shadow (ema_params). Full "
        f"train-state artifacts (orbax weights/best|last) carry one "
        f"when the run trained with model_ema_decay; the portable "
        f"best/last.msgpack of an EMA run already holds the EMA "
        f"weights AS its params (nkbx/train/trainer.py) — for those, "
        f"drop --ema.")


def load_weights(path, ema: bool = False, n_heads: int | None = None) -> dict:
    """``{'params', 'batch_stats'}`` of a trained model (nkbx's
    ``load_nkbx_weights``): the port's ``best.pt``/``last.pt`` (a module's
    state dict), a port checkpoint directory (``train_state.pt``; with
    ``ema`` its EMA shadow), or an nkbx ``.msgpack`` (with ``ema`` its
    ``ema_params``). ``ema=True`` raises nkbx's message where the file has no
    shadow (a ``best.pt`` of an EMA run already holds the EMA weights). A
    ViT's attention needs ``n_heads`` to split its heads."""
    from nkbx_torch.models.pretrained import read_msgpack
    from nkbx_torch.train.checkpoint import STATE_FILE

    p = Path(path)
    if p.suffix == ".msgpack":
        restored = read_msgpack(p)
        if ema:
            if not restored.get("ema_params"):
                raise _no_ema(path)
            return {"params": restored["ema_params"],
                    "batch_stats": restored.get("ema_batch_stats") or {}}
        return {"params": restored["params"], "batch_stats": restored.get("batch_stats") or {}}
    if p.is_dir():
        if not (p / STATE_FILE).exists():
            raise NotImplementedError(
                f"{path} is a directory without {STATE_FILE}: an orbax checkpoint of nkbx, "
                "which nkbx_torch cannot read (no orbax); save nkbx's weights as a .msgpack "
                "(nkbx.train.checkpoint.save_model_msgpack) and convert that")
        payload = torch.load(p / STATE_FILE, map_location="cpu", weights_only=True)
        if ema and "ema" not in payload:
            raise _no_ema(path)
        sd = payload["ema" if ema else "module"]
    else:
        if ema:
            raise _no_ema(path)
        sd = torch.load(p, map_location="cpu", weights_only=True)
    return convert.to_jax_variables(sd, n_heads)
