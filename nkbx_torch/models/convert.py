"""Carry weights across to the port: nkbx (flax) trees, timm-layout torch
files, and ``pos_embed`` at another token grid.

**flax -> port** (:func:`from_jax_variables`). The port's module names
follow the flax tree, so the conversion is a walk:
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

**Resampling on load** (:func:`resample_pos_embed`,
:func:`adapt_variables_tree`; nkbx convert.py:65-156): a ViT ``pos_embed``
saved at another token count is resampled bicubically (antialiased, as
timm's ``resample_abs_pos_embed``); any other shape that differs raises.

**timm layout -> nkbx tree** (:func:`convert_torch_state_dict`,
:func:`convert_reference_checkpoint`; nkbx convert.py:196-1062): a
timm/torchvision/unicom ``state_dict`` becomes nkbx's ``{'params',
'batch_stats'}`` tree of numpy arrays, one builder a family, leaf for leaf
what nkbx's converter builds, so that the file written from it
(:func:`nkbx_torch.models.pretrained.write_msgpack`) is the file nkbx
writes. Nothing is downloaded. The CLI::

    python -m nkbx_torch.models.convert --model NAME --weights FILE [--out PATH]
        [--reference-checkpoint]
    python -m nkbx_torch.models.convert --to-torch --model NAME --weights W --out OUT.pth
        [--ema]

writes ``$NKBX_PRETRAINED_DIR/<name>.msgpack`` (what ``pretrained=True``
loads) or ``--out`` (with ``--reference-checkpoint``, a whole reference
classifier for the config's ``checkpoint`` key). ``--to-torch`` goes the
other way (:mod:`nkbx_torch.models.reverse`, through
:func:`to_jax_variables` for the port's own files).
"""

from __future__ import annotations

import argparse
import math
import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F


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


def flax_param_path(name: str, param) -> str:
    """The flax path of the port parameter ``name``, joined with ``/`` as
    nkbx names its gradient norms (``backbone/stage0_block0/attn/qkv/kernel``
    for ``backbone.stage0_block0.attn.qkv.weight``): :func:`from_jax_variables`
    read backwards. A ``weight`` of rank 1 was a norm's ``scale``, of a
    higher rank a ``kernel``."""
    *prefix, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if param.dim() == 1 else "kernel"
    return "/".join(prefix + [leaf])


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


_ATTENTION = ("query", "key", "value", "out")
_STAT_OF = {v: k for k, v in _STATS.items()}


def to_jax_variables(state, n_heads: int | None = None) -> dict:
    """A port ``state_dict`` (or module) -> nkbx's ``{'params', 'batch_stats'}``
    tree of float32 numpy arrays: :func:`from_jax_variables` read backwards,
    the paths as :func:`flax_param_path` names them, ``running_mean``/``running_var``
    to ``batch_stats`` ``mean``/``var``. An attention ``query``/``key``/
    ``value``/``out`` leaf takes its (H, D) split from ``n_heads``, which a
    module gives itself (its attention's ``n_heads``)."""
    if isinstance(state, torch.nn.Module):
        if n_heads is None:
            n_heads = next((m.n_heads for m in state.modules() if hasattr(m, "n_heads")), None)
        state = state.state_dict()
    params, stats = {}, {}
    for name, t in state.items():
        *prefix, leaf = name.split(".")
        value = torch.as_tensor(t).detach().float().cpu().numpy()
        if leaf in _STAT_OF:
            _set(stats, tuple(prefix) + (_STAT_OF[leaf],), value)
            continue
        if leaf == "weight":
            leaf = "scale" if value.ndim == 1 else "kernel"
        path = tuple(prefix) + (leaf,)
        if prefix and prefix[-1] in _ATTENTION and path[-1] in ("kernel", "bias"):
            if n_heads is None:
                raise ValueError(f"{name}: an attention leaf needs n_heads")
            if path[-1] == "bias":
                value = value if prefix[-1] == "out" else value.reshape(n_heads, -1)
            elif prefix[-1] == "out":  # weight (C, H*D) -> (H, D, C)
                value = value.T.reshape(n_heads, -1, value.shape[0])
            else:  # weight (H*D, C) -> (C, H, D)
                value = value.T.reshape(value.shape[1], n_heads, -1)
        elif path[-1] == "kernel":
            value = value.T if value.ndim == 2 else value.transpose(2, 3, 1, 0)
        _set(params, path, np.ascontiguousarray(value))
    return {"params": params, "batch_stats": stats}


# --- pos_embed at another token grid ---------------------------------------------


def resample_pos_embed(stored, n_new: int) -> torch.Tensor:
    """A ViT position embedding (1, n_old, D) resampled to (1, n_new, D)
    float32: the square token grid through ``F.interpolate(mode="bicubic",
    antialias=True, align_corners=False)``, a class-token prefix passed
    through. The prefix is 1 (a class token) or 0 (unicom), the one that
    makes both token counts perfect squares (nkbx convert.py:65-107)."""
    stored = torch.as_tensor(stored, dtype=torch.float32).cpu()
    _, n_old, d = stored.shape
    for prefix in (1, 0):
        g_old = math.isqrt(max(n_old - prefix, 0))
        g_new = math.isqrt(max(n_new - prefix, 0))
        if g_old ** 2 == n_old - prefix and g_new ** 2 == n_new - prefix:
            break
    else:
        raise ValueError(
            f"cannot resample pos_embed from {n_old} to {n_new} tokens: no "
            f"prefix length makes both grids square (non-square input sizes "
            f"are not supported for pretrained ViT resampling)")
    grid = stored[:, prefix:].reshape(1, g_old, g_old, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(g_new, g_new), mode="bicubic", antialias=True,
                         align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, g_new * g_new, d)
    return torch.cat([stored[:, :prefix], grid], dim=1)


def adapt_variables_tree(loaded, target, where=()):
    """Fit loaded weights onto a model's template (nkbx convert.py:110-156):
    nested mappings (a flax tree) or flat ones (a state dict, dotted names).
    Shape-equal leaves pass through; a ``pos_embed`` whose token count
    differs is resampled (:func:`resample_pos_embed`); a missing or extra
    entry or any other shape that differs raises, with nkbx's words."""
    if isinstance(target, Mapping):
        if not isinstance(loaded, Mapping):
            raise ValueError(
                f"checkpoint structure mismatch at {'/'.join(where) or '<root>'}: "
                f"model expects a subtree, checkpoint holds a leaf")
        missing = [k for k in target if k not in loaded]
        if missing:
            raise ValueError(
                f"checkpoint is missing {'/'.join(where + (str(missing[0]),))} "
                f"(and {len(missing) - 1} more) — was it saved from a "
                f"different architecture?")
        extra = [k for k in loaded if k not in target]
        if extra:
            raise ValueError(
                f"checkpoint holds {'/'.join(where + (str(extra[0]),))} "
                f"(and {len(extra) - 1} more) the model has no slot for — "
                f"wrong backbone name for these weights?")
        return {k: adapt_variables_tree(loaded[k], target[k], where + (k,)) for k in target}
    lshape = tuple(getattr(loaded, "shape", ()))
    tshape = tuple(getattr(target, "shape", ()))
    if lshape == tshape:
        return loaded
    if (where and str(where[-1]).split(".")[-1] == "pos_embed" and len(lshape) == 3
            and len(tshape) == 3 and lshape[0] == tshape[0] == 1 and lshape[2] == tshape[2]):
        return resample_pos_embed(loaded, tshape[1])
    raise ValueError(
        f"shape mismatch at {'/'.join(where)}: checkpoint holds {lshape}, "
        f"model expects {tshape}. The checkpoint was made for a different "
        f"input size or architecture variant (only ViT pos_embed token "
        f"counts are adapted automatically; e.g. a unicom feature head is "
        f"bound to its training input size).")


# --- timm-layout state dicts -> nkbx trees ---------------------------------------


def _conv_w(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))  # OIHW -> HWIO


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


class _Tree:
    """The ``params`` and ``batch_stats`` a family converter builds from a
    torch state dict: each helper sets nkbx's leaves in nkbx's order, so the
    tree's maps keep the order nkbx's file has. Views, no copies: a Dense
    kernel is the transpose of the torch weight."""

    def __init__(self, state_dict):
        self.sd = {k: np.asarray(v) for k, v in state_dict.items()}
        self.params, self.stats = {}, {}

    def set(self, path, value):
        _set(self.params, path, value)

    def conv(self, path, key):
        self.set(path + ("kernel",), _conv_w(self.sd[key]))

    def dense(self, t, path, bias=True):
        self.set(path + ("kernel",), np.transpose(self.sd[f"{t}.weight"], (1, 0)))
        if bias:
            self.set(path + ("bias",), self.sd[f"{t}.bias"])

    def ln(self, t, path):
        self.set(path + ("scale",), self.sd[f"{t}.weight"])
        self.set(path + ("bias",), self.sd[f"{t}.bias"])

    def bn(self, t, path):
        self.ln(t, path)
        _set(self.stats, path + ("mean",), self.sd[f"{t}.running_mean"])
        _set(self.stats, path + ("var",), self.sd[f"{t}.running_var"])

    def conv_bn(self, path, conv_key, bn_key):
        """A ConvBN: ``path/Conv_0`` from the torch conv, ``path/BatchNorm_0``
        from the torch BatchNorm."""
        self.conv(path + ("Conv_0",), conv_key)
        self.bn(bn_key, path + ("BatchNorm_0",))

    def se(self, f, t):
        """A SqueezeExcite (timm's ``se.conv_reduce``/``se.conv_expand``)."""
        for conv, name in (("Conv_0", "conv_reduce"), ("Conv_1", "conv_expand")):
            self.conv((f, "SqueezeExcite_0", conv), f"{t}.se.{name}.weight")
            self.set((f, "SqueezeExcite_0", conv, "bias"), self.sd[f"{t}.se.{name}.bias"])

    def out(self):
        return self.params, self.stats


def s2d_conv1_weight(w_hwio):
    """A (7, 7, C, O) stem kernel regrouped for the space-to-depth stem:
    zero-padded to 8x8 at offset (1, 1), each spatial dim split into (tap,
    parity) and the 2x2 parity folded into channels -> (4, 4, 4C, O), which
    computes conv7x7/s2 pad 3 as conv4x4/s1 pad (2, 1) over the
    space_to_depth(2) input (nkbx convert.py:207-218)."""
    w = np.asarray(w_hwio)
    kh, kw, c, o = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem expects a 7x7 kernel, got {w.shape}")
    wp = np.zeros((8, 8, c, o), w.dtype)
    wp[1:8, 1:8] = w
    return wp.reshape(4, 2, 4, 2, c, o).transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, o)


def convert_resnet_state_dict(state_dict, stage_sizes, tiered_stem=False, s2d_stem=True):
    """timm ResNet: the 7x7 stem (regrouped for the s2d stem unless
    ``s2d_stem=False``) or the tiered 3-conv stem (``conv1.{0,3,6}``, the
    last BatchNorm ``bn1``); ``layer{L}.{B}`` -> ``BasicBlock_k`` /
    ``Bottleneck_k`` numbered across stages; SE fc1/fc2 and both downsample
    layouts ('d' variants: the conv at ``.1``, the BatchNorm at ``.2``)."""
    t = _Tree(state_dict)
    sd = t.sd
    is_bottleneck = any(".conv3.weight" in k for k in sd)
    block_name = "Bottleneck" if is_bottleneck else "BasicBlock"
    if tiered_stem:
        t.conv_bn(("ConvBN_0",), "conv1.0.weight", "conv1.1")
        t.conv_bn(("ConvBN_1",), "conv1.3.weight", "conv1.4")
        t.conv_bn(("ConvBN_2",), "conv1.6.weight", "bn1")
    else:
        w = _conv_w(sd["conv1.weight"])
        t.set(("ConvBN_0", "Conv_0", "kernel"), s2d_conv1_weight(w) if s2d_stem else w)
        t.bn("bn1", ("ConvBN_0", "BatchNorm_0"))
    k = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for b in range(n_blocks):
            src, f = f"layer{stage}.{b}", f"{block_name}_{k}"
            for ci in range(1, (3 if is_bottleneck else 2) + 1):
                t.conv_bn((f, f"ConvBN_{ci - 1}"), f"{src}.conv{ci}.weight", f"{src}.bn{ci}")
            if f"{src}.se.fc1.weight" in sd:
                for fc in ("fc1", "fc2"):
                    t.conv((f, "se", fc), f"{src}.se.{fc}.weight")
                    t.set((f, "se", fc, "bias"), sd[f"{src}.se.{fc}.bias"])
            if f"{src}.downsample.0.weight" in sd:
                t.conv_bn((f, "downsample"), f"{src}.downsample.0.weight",
                          f"{src}.downsample.1")
            elif f"{src}.downsample.1.weight" in sd:
                t.conv_bn((f, "downsample"), f"{src}.downsample.1.weight",
                          f"{src}.downsample.2")
            k += 1
    return t.out()


# name: (stage sizes, tiered stem)
_RESNET_SPECS = {
    "resnet_tiny_test": ((1, 1), False),
    "resnet14t": ((1, 1, 1, 1), True),
    "resnet18": ((2, 2, 2, 2), False),
    "resnet18d": ((2, 2, 2, 2), True),
    "resnet26": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet34d": ((3, 4, 6, 3), True),
    "resnet50": ((3, 4, 6, 3), False),
    "resnet50d": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), False),
    "resnet152": ((3, 8, 36, 3), False),
    "resnext50_32x4d": ((3, 4, 6, 3), False),
    "resnext101_32x8d": ((3, 4, 23, 3), False),
    "wide_resnet50_2": ((3, 4, 6, 3), False),
    "seresnet50": ((3, 4, 6, 3), False),
    "seresnext50_32x4d": ((3, 4, 6, 3), False),
}

# timm's blocks.{stage} counts
_MBV3_STAGES = {
    "mobilenetv3_large_100": [1, 2, 3, 4, 2, 3],
    "mobilenetv3_small_100": [1, 2, 3, 2, 3],
}


def convert_mobilenetv3_state_dict(state_dict, stage_blocks):
    """timm MobileNetV3: ``conv_stem``/``bn1``; ``blocks.{s}.{i}``, the
    depthwise-separable first block (``conv_dw``/``bn1``,
    ``conv_pw``/``bn2``) and inverted residuals (``conv_pw``/``bn1``,
    ``conv_dw``/``bn2``, optional SE, ``conv_pwl``/``bn3``) ->
    ``InvertedResidual_k``; the trailing ConvBnAct; ``conv_head`` -> the
    ``Dense_0`` feature head."""
    t = _Tree(state_dict)
    sd = t.sd
    t.conv_bn(("ConvBN_0",), "conv_stem.weight", "bn1")
    k = 0
    for s, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            src, f = f"blocks.{s}.{b}", f"InvertedResidual_{k}"
            if f"{src}.conv_pwl.weight" in sd:
                t.conv_bn((f, "ConvBN_0"), f"{src}.conv_pw.weight", f"{src}.bn1")
                t.conv_bn((f, "ConvBN_1"), f"{src}.conv_dw.weight", f"{src}.bn2")
                proj, proj_src = "ConvBN_2", (f"{src}.conv_pwl.weight", f"{src}.bn3")
            else:
                t.conv_bn((f, "ConvBN_0"), f"{src}.conv_dw.weight", f"{src}.bn1")
                proj, proj_src = "ConvBN_1", (f"{src}.conv_pw.weight", f"{src}.bn2")
            if f"{src}.se.conv_reduce.weight" in sd:
                t.se(f, src)
            t.conv_bn((f, proj), *proj_src)
            k += 1
    last = f"blocks.{len(stage_blocks)}.0"
    t.conv_bn(("ConvBN_1",), f"{last}.conv.weight", f"{last}.bn1")
    w = sd["conv_head.weight"]  # (O, I, 1, 1): a 1x1 on pooled features is a Dense
    t.set(("Dense_0", "kernel"), np.transpose(w[:, :, 0, 0], (1, 0)))
    t.set(("Dense_0", "bias"), sd.get("conv_head.bias", np.zeros(w.shape[0], np.float32)))
    return t.out()


# name: (dim, depth, heads)
_VIT_SPECS = {
    "vit_tiny_patch16_224": (192, 12, 3),
    "vit_small_patch16_224": (384, 12, 6),
    "vit_small_patch32_224": (384, 12, 6),
    "vit_base_patch16_224": (768, 12, 12),
    "vit_base_patch32_224": (768, 12, 12),
    "vit_large_patch16_224": (1024, 24, 16),
    "deit_tiny_patch16_224": (192, 12, 3),
    "deit_small_patch16_224": (384, 12, 6),
    "deit_base_patch16_224": (768, 12, 12),
    "vit_tiny_patch16_384": (192, 12, 3),
    "vit_small_patch16_384": (384, 12, 6),
    "vit_small_patch32_384": (384, 12, 6),
    "vit_base_patch16_384": (768, 12, 12),
    "vit_base_patch32_384": (768, 12, 12),
    "vit_large_patch16_384": (1024, 24, 16),
    "vit_large_patch32_384": (1024, 24, 16),
}

_UNICOM_SPECS = {
    "unicom ViT-B/32": (768, 12, 12),
    "unicom ViT-B/16": (768, 12, 12),
    "unicom ViT-L/14": (1024, 24, 16),
}


def _put_vit_block(t, src, f, dim, n_heads):
    """One timm/unicom transformer block (``norm1``, the fused ``attn.qkv``
    rows [q; k; v], ``attn.proj``, ``norm2``, ``mlp.fc1``/``fc2``) onto
    ``TransformerBlock_i``: flax's attention kernels (in, heads, head_dim)
    and ``out`` (heads, head_dim, in)."""
    sd, hd = t.sd, dim // n_heads
    t.ln(f"{src}.norm1", (f, "LayerNorm_0"))
    t.ln(f"{src}.norm2", (f, "LayerNorm_1"))
    qkv_w, qkv_b = sd[f"{src}.attn.qkv.weight"], sd[f"{src}.attn.qkv.bias"]
    attn = (f, "MultiHeadDotProductAttention_0")
    for j, nm in enumerate(("query", "key", "value")):
        w = qkv_w[j * dim:(j + 1) * dim]
        t.set(attn + (nm, "kernel"), np.transpose(w, (1, 0)).reshape(dim, n_heads, hd))
        t.set(attn + (nm, "bias"), qkv_b[j * dim:(j + 1) * dim].reshape(n_heads, hd))
    t.set(attn + ("out", "kernel"),
          np.transpose(sd[f"{src}.attn.proj.weight"], (1, 0)).reshape(n_heads, hd, dim))
    t.set(attn + ("out", "bias"), sd[f"{src}.attn.proj.bias"])
    t.dense(f"{src}.mlp.fc1", (f, "Dense_0"))
    t.dense(f"{src}.mlp.fc2", (f, "Dense_1"))


def convert_vit_state_dict(state_dict, dim, depth, n_heads):
    """timm ViT: ``cls_token``, ``pos_embed``, ``patch_embed.proj``,
    ``blocks.{i}``, the final ``norm`` -> ``LayerNorm_0``."""
    t = _Tree(state_dict)
    t.set(("cls_token",), t.sd["cls_token"])
    t.set(("pos_embed",), t.sd["pos_embed"])
    t.conv(("patch_embed",), "patch_embed.proj.weight")
    t.set(("patch_embed", "bias"), t.sd["patch_embed.proj.bias"])
    for i in range(depth):
        _put_vit_block(t, f"blocks.{i}", f"TransformerBlock_{i}", dim, n_heads)
    t.ln("norm", ("LayerNorm_0",))
    return t.out()


def convert_unicom_state_dict(state_dict, dim, depth, n_heads):
    """deepglint/unicom VisionTransformer: ``pos_embed`` (no class token),
    ``patch_embed.proj`` (its bias zeros where the conv has none),
    ``blocks.{i}``, ``norm``, and the ``feature`` Sequential: Linear (no
    bias), BatchNorm1d, Linear (no bias), BatchNorm1d -> ``feature_fc1``,
    ``feature_bn1``, ``feature_fc2``, ``feature_bn2``."""
    t = _Tree(state_dict)
    sd = t.sd
    t.set(("pos_embed",), sd["pos_embed"])
    t.conv(("patch_embed",), "patch_embed.proj.weight")
    t.set(("patch_embed", "bias"),
          sd.get("patch_embed.proj.bias",
                 np.zeros(sd["patch_embed.proj.weight"].shape[0], np.float32)))
    for i in range(depth):
        _put_vit_block(t, f"blocks.{i}", f"TransformerBlock_{i}", dim, n_heads)
    t.ln("norm", ("norm",))
    for fc, bn, f_fc, f_bn in (("feature.0", "feature.1", "feature_fc1", "feature_bn1"),
                               ("feature.2", "feature.3", "feature_fc2", "feature_bn2")):
        t.dense(fc, (f_fc,), bias=False)
        t.bn(bn, (f_bn,))
    return t.out()


# timm's blocks.{s} counts (after depth scaling)
_EFFNET_STAGES = {
    "efficientnet_b0": [1, 2, 2, 3, 3, 4, 1],
    "efficientnet_b1": [2, 3, 3, 4, 4, 5, 2],
    "efficientnet_b2": [2, 3, 3, 4, 4, 5, 2],
    "efficientnet_b3": [2, 3, 3, 5, 5, 6, 2],
    "efficientnet_b4": [2, 4, 4, 6, 6, 8, 2],
    "efficientnet_b5": [3, 5, 5, 7, 7, 9, 3],
    "efficientnet_b6": [3, 6, 6, 8, 8, 11, 3],
    "efficientnet_b7": [4, 7, 7, 10, 10, 13, 4],
}


def convert_efficientnet_state_dict(state_dict, stage_blocks):
    """timm EfficientNet: MobileNetV3's builder layout with SE in every block
    (``MBConv_k``) and ``conv_head``/``bn2`` -> the trailing ConvBN."""
    t = _Tree(state_dict)
    sd = t.sd
    t.conv_bn(("ConvBN_0",), "conv_stem.weight", "bn1")
    k = 0
    for s, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            src, f = f"blocks.{s}.{b}", f"MBConv_{k}"
            if f"{src}.conv_pwl.weight" in sd:
                t.conv_bn((f, "ConvBN_0"), f"{src}.conv_pw.weight", f"{src}.bn1")
                t.conv_bn((f, "ConvBN_1"), f"{src}.conv_dw.weight", f"{src}.bn2")
                proj, proj_src = "ConvBN_2", (f"{src}.conv_pwl.weight", f"{src}.bn3")
            else:
                t.conv_bn((f, "ConvBN_0"), f"{src}.conv_dw.weight", f"{src}.bn1")
                proj, proj_src = "ConvBN_1", (f"{src}.conv_pw.weight", f"{src}.bn2")
            t.se(f, src)
            t.conv_bn((f, proj), *proj_src)
            k += 1
    t.conv_bn(("ConvBN_1",), "conv_head.weight", "bn2")
    return t.out()


# name: (depths, dims)
_CONVNEXT_SPECS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}


def convert_convnext_state_dict(state_dict, depths):
    """timm ConvNeXt: ``stem.0``/``stem.1``; ``stages.{s}.downsample.{0,1}``
    for s >= 1 -> ``LayerNorm_i``/``Conv_i``; ``stages.{s}.blocks.{b}`` ->
    ``ConvNeXtBlock_k``; the final ``head.norm`` (or an older ``norm``) ->
    ``head_norm``."""
    t = _Tree(state_dict)
    sd = t.sd

    def conv_bias(path, src):
        t.conv(path, f"{src}.weight")
        t.set(path + ("bias",), sd[f"{src}.bias"])

    conv_bias(("Conv_0",), "stem.0")
    t.ln("stem.1", ("LayerNorm_0",))
    k = 0
    for s, depth in enumerate(depths):
        if s > 0:
            t.ln(f"stages.{s}.downsample.0", (f"LayerNorm_{s}",))
            conv_bias((f"Conv_{s}",), f"stages.{s}.downsample.1")
        for b in range(depth):
            src, f = f"stages.{s}.blocks.{b}", f"ConvNeXtBlock_{k}"
            conv_bias((f, "Conv_0"), f"{src}.conv_dw")
            t.ln(f"{src}.norm", (f, "LayerNorm_0"))
            t.dense(f"{src}.mlp.fc1", (f, "Dense_0"))
            t.dense(f"{src}.mlp.fc2", (f, "Dense_1"))
            t.set((f, "layer_scale"), sd[f"{src}.gamma"])
            k += 1
    t.ln("head.norm" if "head.norm.weight" in sd else "norm", ("head_norm",))
    return t.out()


# name: (embed_dim, depths, heads)
_SWIN_SPECS = {
    "swin_tiny_patch4_window7_224": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small_patch4_window7_224": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base_patch4_window7_224": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "swin_large_patch4_window7_224": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
    "swin_base_patch4_window12_384": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "swin_large_patch4_window12_384": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}


def convert_swin_state_dict(state_dict, depths):
    """microsoft/timm Swin V1: ``patch_embed.{proj,norm}``;
    ``layers.{i}.blocks.{j}`` -> ``stage{i}_block{j}``; the patch merge after
    stage i at ``layers.{i}.downsample`` (original and timm < 0.9) or at the
    input of stage i + 1 (timm >= 0.9), told apart once for the whole file;
    the final ``norm``. Buffers (relative_position_index, attn_mask) are
    recomputed, the head dropped."""
    t = _Tree(state_dict)
    t.conv(("patch_embed",), "patch_embed.proj.weight")
    t.set(("patch_embed", "bias"), t.sd["patch_embed.proj.bias"])
    t.ln("patch_embed.norm", ("patch_norm",))
    pre09 = "layers.0.downsample.reduction.weight" in t.sd
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, f = f"layers.{i}.blocks.{j}", f"stage{i}_block{j}"
            t.ln(f"{src}.norm1", (f, "norm1"))
            t.set((f, "attn", "relative_position_bias_table"),
                  t.sd[f"{src}.attn.relative_position_bias_table"])
            t.dense(f"{src}.attn.qkv", (f, "attn", "qkv"))
            t.dense(f"{src}.attn.proj", (f, "attn", "proj"))
            t.ln(f"{src}.norm2", (f, "norm2"))
            t.dense(f"{src}.mlp.fc1", (f, "fc1"))
            t.dense(f"{src}.mlp.fc2", (f, "fc2"))
        if i != len(depths) - 1:
            ds = f"layers.{i}.downsample" if pre09 else f"layers.{i + 1}.downsample"
            t.ln(f"{ds}.norm", (f"downsample{i}", "norm"))
            t.dense(f"{ds}.reduction", (f"downsample{i}", "reduction"), bias=False)
    t.ln("norm", ("norm",))
    return t.out()


_EFFNETV2_SPECS = ("efficientnetv2_s", "efficientnetv2_m", "efficientnetv2_l")


def _effnetv2_spec(name: str):
    from nkbx_torch.models import efficientnet

    return getattr(efficientnet, name).keywords["spec"]


def convert_efficientnetv2_state_dict(state_dict, spec):
    """timm EfficientNetV2, ``blocks.{s}.{b}``: ConvBnAct (fused, expand 1:
    ``conv``/``bn1``) and EdgeResidual (fused: ``conv_exp``/``bn1``,
    ``conv_pwl``/``bn2``) -> ``FusedMBConv_k``; InvertedResidual
    (``conv_pw``/``bn1``, ``conv_dw``/``bn2``, SE, ``conv_pwl``/``bn3``) ->
    ``MBConv_k``."""
    t = _Tree(state_dict)
    t.conv_bn(("ConvBN_0",), "conv_stem.weight", "bn1")
    kf = km = 0
    for s, (block, expand, _k, _stride, repeats, _out, _se) in enumerate(spec):
        for b in range(repeats):
            src = f"blocks.{s}.{b}"
            if block == "fused":
                f = f"FusedMBConv_{kf}"
                kf += 1
                if expand == 1:
                    t.conv_bn((f, "ConvBN_0"), f"{src}.conv.weight", f"{src}.bn1")
                else:
                    t.conv_bn((f, "ConvBN_0"), f"{src}.conv_exp.weight", f"{src}.bn1")
                    t.conv_bn((f, "ConvBN_1"), f"{src}.conv_pwl.weight", f"{src}.bn2")
            else:
                f = f"MBConv_{km}"
                km += 1
                t.conv_bn((f, "ConvBN_0"), f"{src}.conv_pw.weight", f"{src}.bn1")
                t.conv_bn((f, "ConvBN_1"), f"{src}.conv_dw.weight", f"{src}.bn2")
                t.se(f, src)
                t.conv_bn((f, "ConvBN_2"), f"{src}.conv_pwl.weight", f"{src}.bn3")
    t.conv_bn(("ConvBN_1",), "conv_head.weight", "bn2")
    return t.out()


_DENSENET_CONFIGS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}


def convert_densenet_state_dict(state_dict, block_config):
    """torchvision/timm DenseNet: ``features.conv0``/``norm0``,
    ``features.denseblock{b}.denselayer{l}.{norm1,conv1,norm2,conv2}``,
    ``features.transition{t}.{norm,conv}``, ``features.norm5``."""
    t = _Tree(state_dict)
    t.conv(("stem_conv",), "features.conv0.weight")
    t.bn("features.norm0", ("stem_norm",))
    for b, n_layers in enumerate(block_config, start=1):
        for li in range(1, n_layers + 1):
            src, f = f"features.denseblock{b}.denselayer{li}", f"block{b - 1}_layer{li - 1}"
            t.bn(f"{src}.norm1", (f, "bottleneck", "BatchNorm_0"))
            t.conv((f, "bottleneck", "Conv_0"), f"{src}.conv1.weight")
            t.bn(f"{src}.norm2", (f, "conv", "BatchNorm_0"))
            t.conv((f, "conv", "Conv_0"), f"{src}.conv2.weight")
        if b != len(block_config):
            src, f = f"features.transition{b}", f"transition{b - 1}"
            t.bn(f"{src}.norm", (f, "BatchNorm_0"))
            t.conv((f, "Conv_0"), f"{src}.conv.weight")
    t.bn("features.norm5", ("final_norm",))
    return t.out()


# name -> the family converter's call on a numpy state dict
_FAMILIES = (
    (_RESNET_SPECS, lambda sd, spec: convert_resnet_state_dict(sd, *spec)),
    (_MBV3_STAGES, convert_mobilenetv3_state_dict),
    (_VIT_SPECS, lambda sd, spec: convert_vit_state_dict(sd, *spec)),
    (_EFFNET_STAGES, convert_efficientnet_state_dict),
    (_CONVNEXT_SPECS, lambda sd, spec: convert_convnext_state_dict(sd, spec[0])),
    (_UNICOM_SPECS, lambda sd, spec: convert_unicom_state_dict(sd, *spec)),
    (_DENSENET_CONFIGS, convert_densenet_state_dict),
    ({n: n for n in _EFFNETV2_SPECS},
     lambda sd, name: convert_efficientnetv2_state_dict(sd, _effnetv2_spec(name))),
    (_SWIN_SPECS, lambda sd, spec: convert_swin_state_dict(sd, spec[1])),
)


def convert_torch_state_dict(name: str, state_dict) -> dict:
    """A timm-layout state dict (numpy arrays or torch tensors) of backbone
    ``name`` -> nkbx's ``{'params', 'batch_stats'}`` tree, what nkbx's
    ``convert_torch_state_dict`` builds (convert.py:320-368)."""
    state_dict = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
                  for k, v in state_dict.items()}
    for specs, convert in _FAMILIES:
        if name in specs:
            params, stats = convert(state_dict, specs[name])
            return {"params": params, "batch_stats": stats}
    raise NotImplementedError(f"no timm-layout converter for {name!r} (have: "
                              f"{sorted(n for specs, _ in _FAMILIES for n in specs)})")


def convert_reference_checkpoint(backbone_name: str, state_dict) -> dict:
    """A whole reference-trained classifier (``emb_model.<backbone>`` and
    ``classifier.1.*`` single-task or ``classifier.<target>.1.*``
    multi-task) -> ``{'params': {'backbone', 'head' | 'head_<t>'},
    'batch_stats': {'backbone'}}``, for the config's ``checkpoint`` key
    (nkbx convert.py:747-783)."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
          for k, v in state_dict.items()}
    emb = {k[len("emb_model."):]: v for k, v in sd.items() if k.startswith("emb_model.")}
    if not emb:
        raise ValueError("no 'emb_model.*' keys — not a reference classifier checkpoint "
                         "(for bare backbone weights use convert_torch_state_dict)")
    converted = convert_torch_state_dict(backbone_name, emb)
    params = {"backbone": converted["params"]}
    stats = {"backbone": converted["batch_stats"]} if converted.get("batch_stats") else {}
    if "classifier.1.weight" in sd:  # single-task Sequential(Dropout, Linear)
        params["head"] = {"kernel": np.asarray(sd["classifier.1.weight"]).T,
                          "bias": np.asarray(sd["classifier.1.bias"])}
    else:  # multi-task ModuleDict of Sequentials
        targets = sorted({k.split(".")[1] for k in sd
                          if k.startswith("classifier.") and k.endswith(".1.weight")})
        if not targets:
            raise ValueError("no 'classifier.*' head keys in the checkpoint")
        for tgt in targets:
            params[f"head_{tgt}"] = {"kernel": np.asarray(sd[f"classifier.{tgt}.1.weight"]).T,
                                     "bias": np.asarray(sd[f"classifier.{tgt}.1.bias"])}
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path) -> dict:
    """A torch checkpoint file -> a flat ``{key: numpy array}`` state dict:
    a raw state dict or one wrapped under ``state_dict``/``model``,
    ``module.`` prefixes stripped, floating tensors as float32
    (``torch.load(weights_only=True)``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(obj)}")
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = v.float().numpy() if v.dtype.is_floating_point else v.numpy()
        out[k] = np.asarray(v)
    return out


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def main(argv=None):
    from nkbx_torch.models.pretrained import default_filename, write_msgpack

    ap = argparse.ArgumentParser(
        description="Convert a timm-layout torch backbone file to nkbx's msgpack (what "
                    "model.pretrained=True loads from $NKBX_PRETRAINED_DIR), or a whole "
                    "reference classifier for the config's model.checkpoint key; or, with "
                    "--to-torch, trained weights back to the torch layouts (a timm backbone "
                    "state_dict, or the reference classifier checkpoint when the weights "
                    "hold a backbone+head tree). Nothing is downloaded.")
    ap.add_argument("--model", required=True,
                    help="backbone name, e.g. resnet50 or 'unicom ViT-B/32'")
    ap.add_argument("--weights", help="torch checkpoint file (.pth/.pt/.bin); with "
                                      "--to-torch: the port's weights/best.pt (or last.pt), "
                                      "a weights/best|last directory, or an nkbx .msgpack")
    ap.add_argument("--out", help="output .msgpack path (default: "
                                  "$NKBX_PRETRAINED_DIR/<name>.msgpack); with --to-torch: "
                                  "the output .pth path (required)")
    ap.add_argument("--reference-checkpoint", action="store_true",
                    help="the weights file is a whole reference-trained classifier "
                         "(emb_model.* + classifier.*): convert backbone and head; load the "
                         "output through the config's model.checkpoint key")
    ap.add_argument("--to-torch", action="store_true",
                    help="reverse direction: trained weights -> torch state_dict (.pth). A "
                         "classifier tree (backbone + head) becomes a reference-layout "
                         "checkpoint (emb_model.* + classifier.*); a bare backbone tree a "
                         "timm-layout backbone state_dict. Load with strict=False (the keys "
                         "torch keeps for itself are printed)")
    ap.add_argument("--ema", action="store_true",
                    help="with --to-torch: export the EMA shadow of a weights/best|last "
                         "directory (or an nkbx msgpack's ema_params) instead of the raw "
                         "weights")
    args = ap.parse_args(argv)
    if args.to_torch:
        from nkbx_torch.models.reverse import (load_weights, reverse_reference_checkpoint,
                                               reverse_torch_state_dict)

        if not args.weights or not args.out:
            raise SystemExit("--to-torch requires --weights (a weights/best|last directory, "
                             "best.pt or .msgpack) and --out (.pth path)")
        spec = _VIT_SPECS.get(args.model) or _UNICOM_SPECS.get(args.model)
        variables = load_weights(args.weights, ema=args.ema, n_heads=spec[2] if spec else None)
        if "backbone" in variables["params"]:
            sd, skipped = reverse_reference_checkpoint(args.model, variables)
        else:
            sd, skipped = reverse_torch_state_dict(args.model, variables)
        torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
                   args.out)
        print(f"wrote {args.out} ({len(sd)} tensors; load with strict=False)")
        if skipped:
            print(f"not emitted (torch keeps its own): {', '.join(skipped)}")
        return args.out
    if not args.weights:
        raise SystemExit("--weights is required: nkbx_torch downloads nothing (nkbx's "
                         "timm/unicom fetch is not ported); give the torch file you have")
    sd = load_torch_checkpoint(args.weights)
    if args.reference_checkpoint:
        if not args.out:
            # the classifier tree is not a pretrained-backbone file: the default path
            # would overwrite the backbone msgpack that pretrained=True loads
            raise SystemExit("--reference-checkpoint requires --out (load the result "
                             "through the config's model.checkpoint key)")
        converted = convert_reference_checkpoint(args.model, sd)
    else:
        converted = convert_torch_state_dict(args.model, sd)
    out = args.out
    if not out:
        d = os.environ.get("NKBX_PRETRAINED_DIR")
        if not d:
            raise SystemExit("--out not given and $NKBX_PRETRAINED_DIR not set")
        os.makedirs(d, exist_ok=True)
        out = os.path.join(d, default_filename(args.model))
    write_msgpack(converted, out)
    print(f"wrote {out} ({_count_leaves(converted)} tensors)")
    return out


if __name__ == "__main__":
    main()
