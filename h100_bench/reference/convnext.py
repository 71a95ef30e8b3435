"""Plain float32 ConvNeXt classifier (Liu et al., "A ConvNet for the
2020s", CVPR 2022): a 4x4 stride-4 stem with a LayerNorm; four stages of
blocks (7x7 depthwise convolution, LayerNorm, a 4x GELU MLP, a per-channel
layer-scale, the residual), each stage after the first entered through a
LayerNorm and a 2x2 stride-2 convolution; the global mean, a LayerNorm and
a linear head. Every LayerNorm has eps 1e-6.

Parameter names follow the program's module tree (``backbone.
ConvNeXtBlock_4.Dense_0.weight``, ``backbone.LayerNorm_2``, ``backbone.
Conv_2``, ``backbone.head_norm``), so that the benchmark can hand both
sides the same seeded tensors by name. No stochastic depth (rate 0).

Also the family's work counts: multiply-adds an image and the shapes of
the LN->MLP calls.
"""

from __future__ import annotations

import torch
from torch import nn

from h100_bench.reference.common import QUANTISERS, conv2d, gelu, layer_norm, linear


def _param_module(**shapes):
    m = nn.Module()
    for k, s in shapes.items():
        setattr(m, k, nn.Parameter(torch.empty(*s)))
    return m


class _Block(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.Conv_0 = _param_module(weight=(dim, 1, 7, 7), bias=(dim,))
        self.layer_scale = nn.Parameter(torch.empty(dim))
        self.LayerNorm_0 = _param_module(weight=(dim,), bias=(dim,))
        self.Dense_0 = _param_module(weight=(4 * dim, dim), bias=(4 * dim,))
        self.Dense_1 = _param_module(weight=(dim, 4 * dim), bias=(dim,))

    def forward(self, x, q, eps):
        """x: NHWC."""
        c = x.shape[-1]
        y = conv2d(x.permute(0, 3, 1, 2), self.Conv_0.weight, self.Conv_0.bias, q, padding=3,
                   groups=c).permute(0, 2, 3, 1)
        y = layer_norm(y, self.LayerNorm_0.weight, self.LayerNorm_0.bias, eps)
        y = linear(gelu(linear(y, self.Dense_0.weight, self.Dense_0.bias, q)),
                   self.Dense_1.weight, self.Dense_1.bias, q)
        return x + y * self.layer_scale


class _Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dims, depths = cfg["dims"], cfg["depths"]
        self.Conv_0 = _param_module(weight=(dims[0], 3, 4, 4), bias=(dims[0],))
        self.LayerNorm_0 = _param_module(weight=(dims[0],), bias=(dims[0],))
        self.order = []
        block = 0
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                self.add_module(f"LayerNorm_{s}", _param_module(weight=(dims[s - 1],),
                                                                bias=(dims[s - 1],)))
                self.add_module(f"Conv_{s}", _param_module(weight=(dim, dims[s - 1], 2, 2),
                                                           bias=(dim,)))
                self.order.append(("down", s))
            for _ in range(depth):
                self.add_module(f"ConvNeXtBlock_{block}", _Block(dim))
                self.order.append(("block", block))
                block += 1
        self.head_norm = _param_module(weight=(dims[-1],), bias=(dims[-1],))


class ConvNeXtClassifier(nn.Module):
    """x: (B, H, W, 3) normalised float32 NHWC -> (B, classes) logits."""

    def __init__(self, cfg, precision: str = "f32"):
        super().__init__()
        self.eps = cfg["layer_norm_eps"]
        self.q = QUANTISERS[precision]
        self.backbone = _Backbone(cfg)
        self.head = _param_module(weight=(cfg["num_classes"], cfg["dims"][-1]),
                                  bias=(cfg["num_classes"],))

    def forward(self, x):
        bb, q, eps = self.backbone, self.q, self.eps

        def down(x, conv, stride):
            return conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, q,
                          stride=stride).permute(0, 2, 3, 1)

        x = down(x, bb.Conv_0, 4)
        x = layer_norm(x, bb.LayerNorm_0.weight, bb.LayerNorm_0.bias, eps)
        for kind, i in bb.order:
            if kind == "down":
                ln = getattr(bb, f"LayerNorm_{i}")
                x = down(layer_norm(x, ln.weight, ln.bias, eps), getattr(bb, f"Conv_{i}"), 2)
            else:
                x = getattr(bb, f"ConvNeXtBlock_{i}")(x, q, eps)
        x = layer_norm(x.mean(dim=(1, 2)), bb.head_norm.weight, bb.head_norm.bias, eps)
        return linear(x, self.head.weight, self.head.bias, q)


def build(cfg, precision: str = "f32") -> nn.Module:
    return ConvNeXtClassifier(cfg, precision)


def _stages(cfg):
    """(side, dim, depth) of each stage at the configured image size."""
    side = cfg["image_size"] // 4
    out = []
    for s, (depth, dim) in enumerate(zip(cfg["depths"], cfg["dims"])):
        if s > 0:
            side //= 2
        out.append((side, dim, depth))
    return out


def macs_per_image(cfg) -> int:
    """Multiply-adds of one image's forward: the stem, per block HW x (49 C
    + 8 C^2) (the depthwise 7x7 and the two 4x pointwise layers), the three
    2x2 downsamplings, the head."""
    dims = cfg["dims"]
    side = cfg["image_size"] // 4
    total = side * side * 3 * 16 * dims[0]
    for s, (side, dim, depth) in enumerate(_stages(cfg)):
        if s > 0:
            total += side * side * 4 * dims[s - 1] * dim
        total += depth * side * side * (49 * dim + 8 * dim * dim)
    return total + dims[-1] * cfg["num_classes"]


def ln_mlp_calls(cfg, images: int) -> list:
    """One LN->MLP call a block over every pixel of its stage; the shortcut
    is the block's input, a tensor apart from the call's (the depthwise
    convolution's output), and the call applies the layer-scale."""
    out = []
    for side, dim, depth in _stages(cfg):
        out += [dict(rows=images * side * side, c=dim, f=4 * dim, shortcut=True,
                     gamma=True)] * depth
    return out


def attention_calls(cfg, images: int) -> list:
    return []
