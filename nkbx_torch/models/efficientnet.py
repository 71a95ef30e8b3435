"""EfficientNet B0-B7 (MBConv with SE and swish, by width and depth
multipliers) and EfficientNetV2 S/M/L (FusedMBConv early stages), NHWC.
Counterpart of ``nkbx/models/efficientnet.py``, with the submodule names of
its flax tree (``MBConv_4.ConvBN_1.Conv_0.weight``,
``MBConv_4.SqueezeExcite_0.Conv_0.bias``, ``FusedMBConv_2.ConvBN_0``), so
that weights and running statistics carry across by a tree walk
(:mod:`nkbx_torch.models.convert`).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import (ConvBN, Dropout, SqueezeExcite, global_avg_pool,
                                      make_divisible)
from nkbx_torch.models.mobilenetv3 import reset_mobile_parameters

# (expand_ratio, kernel, stride, repeats, out_channels)
_B0_SPEC: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 3, 1, 1, 16),
    (6, 3, 2, 2, 24),
    (6, 5, 2, 2, 40),
    (6, 3, 2, 3, 80),
    (6, 5, 1, 3, 112),
    (6, 5, 2, 4, 192),
    (6, 3, 1, 1, 320),
)


def _round_channels(c, width_mult, divisor=8):
    return int(make_divisible(c * width_mult, divisor))


def _round_repeats(r, depth_mult):
    return int(math.ceil(r * depth_mult))


class MBConv(nn.Module):
    """The 1x1 expansion to inp·expand_ratio (where the ratio is not 1), the
    k x k depthwise ConvBN, SqueezeExcite (reduced to max(1, int(inp ·
    se_ratio)), swish, sigmoid gate), the 1x1 projection without
    activation, and the residual at stride 1 with equal widths (nkbx
    efficientnet.py:41-63)."""

    def __init__(self, features_in: int, expand_ratio: int, kernel: int, strides: int, out: int,
                 se_ratio: float = 0.25, dtype=torch.float32, ghost_bn: int = 0):
        super().__init__()
        g, mid = ghost_bn, features_in * expand_ratio
        self.residual = strides == 1 and features_in == out
        convs = []
        if expand_ratio != 1:
            convs.append(ConvBN(features_in, mid, 1, 1, act=F.silu, dtype=dtype, ghost_bn=g))
        convs.append(ConvBN(mid, mid, kernel, strides, groups=mid, act=F.silu, dtype=dtype,
                            ghost_bn=g))
        self.SqueezeExcite_0 = SqueezeExcite(mid, max(1, int(features_in * se_ratio)),
                                             gate=torch.sigmoid, act=F.silu, dtype=dtype)
        convs.append(ConvBN(mid, out, 1, 1, act=False, dtype=dtype, ghost_bn=g))
        self._convs = [f"ConvBN_{i}" for i in range(len(convs))]
        for name, conv in zip(self._convs, convs):
            self.add_module(name, conv)

    def forward(self, x, mask=None):
        y = x
        for name in self._convs[:-1]:
            y = getattr(self, name)(y, mask)
        y = getattr(self, self._convs[-1])(self.SqueezeExcite_0(y), mask)
        return y + x if self.residual else y


class FusedMBConv(nn.Module):
    """The V2 fused block: one dense k x k ConvBN (swish) in place of the
    expansion and the depthwise pair, then the 1x1 projection; with
    expand_ratio 1 the k x k conv projects itself (nkbx
    efficientnet.py:140-163)."""

    def __init__(self, features_in: int, expand_ratio: int, kernel: int, strides: int, out: int,
                 dtype=torch.float32, ghost_bn: int = 0):
        super().__init__()
        g = ghost_bn
        self.residual = strides == 1 and features_in == out
        if expand_ratio != 1:
            mid = features_in * expand_ratio
            self.ConvBN_0 = ConvBN(features_in, mid, kernel, strides, act=F.silu, dtype=dtype,
                                   ghost_bn=g)
            self.ConvBN_1 = ConvBN(mid, out, 1, 1, act=False, dtype=dtype, ghost_bn=g)
        else:
            self.ConvBN_0 = ConvBN(features_in, out, kernel, strides, act=F.silu, dtype=dtype,
                                   ghost_bn=g)
            self.ConvBN_1 = None

    def forward(self, x, mask=None):
        y = self.ConvBN_0(x, mask)
        if self.ConvBN_1 is not None:
            y = self.ConvBN_1(y, mask)
        return y + x if self.residual else y


class _Net(nn.Module):
    """The stem ConvBN_0 (3x3/2, swish), the blocks, ConvBN_1 (1x1 to
    num_features, swish), the global pool and the dropout."""

    def _finish(self, ch, drop_rate, dtype, ghost_bn):
        self.ConvBN_1 = ConvBN(ch, self.num_features, 1, 1, act=F.silu, dtype=dtype,
                               ghost_bn=ghost_bn)
        # as in nkbx, the dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def _add(self, block):
        """Register ``block`` under flax's name: its class, numbered per class."""
        kind = type(block).__name__
        name = f"{kind}_{sum(n.startswith(kind + '_') for n in self._blocks)}"
        self.add_module(name, block)
        self._blocks.append(name)

    def reset_parameters(self, generator: torch.Generator):
        reset_mobile_parameters(self, generator)

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC -> (B, num_features) float32. ``mask`` (B, 1, 1,
        1) weights padded rows out of every BatchNorm's statistics in
        training."""
        x = self.ConvBN_0(x, mask)
        for name in self._blocks:
            x = getattr(self, name)(x, mask)
        return self.dropout(global_avg_pool(self.ConvBN_1(x, mask))).float()


class EfficientNet(_Net):
    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0, drop_rate: float = 0.0,
                 dtype=torch.float32, ghost_bn: int = 0, img_size=(224, 224)):
        super().__init__()
        g = ghost_bn
        self.num_features = _round_channels(1280, width_mult)
        ch = _round_channels(32, width_mult)
        self.ConvBN_0 = ConvBN(3, ch, 3, 2, act=F.silu, dtype=dtype, ghost_bn=g)
        self._blocks = []
        for expand, kernel, stride, repeats, out in _B0_SPEC:
            out_c = _round_channels(out, width_mult)
            for i in range(_round_repeats(repeats, depth_mult)):
                self._add(MBConv(ch, expand, kernel, stride if i == 0 else 1, out_c,
                                 dtype=dtype, ghost_bn=g))
                ch = out_c
        self._finish(ch, drop_rate, dtype, g)


# (block, expand, kernel, stride, repeats, out_channels, se_ratio)
V2_S_SPEC: Sequence = (
    ("fused", 1, 3, 1, 2, 24, 0.0),
    ("fused", 4, 3, 2, 4, 48, 0.0),
    ("fused", 4, 3, 2, 4, 64, 0.0),
    ("mb", 4, 3, 2, 6, 128, 0.25),
    ("mb", 6, 3, 1, 9, 160, 0.25),
    ("mb", 6, 3, 2, 15, 256, 0.25),
)
V2_M_SPEC: Sequence = (
    ("fused", 1, 3, 1, 3, 24, 0.0),
    ("fused", 4, 3, 2, 5, 48, 0.0),
    ("fused", 4, 3, 2, 5, 80, 0.0),
    ("mb", 4, 3, 2, 7, 160, 0.25),
    ("mb", 6, 3, 1, 14, 176, 0.25),
    ("mb", 6, 3, 2, 18, 304, 0.25),
    ("mb", 6, 3, 1, 5, 512, 0.25),
)
V2_L_SPEC: Sequence = (
    ("fused", 1, 3, 1, 4, 32, 0.0),
    ("fused", 4, 3, 2, 7, 64, 0.0),
    ("fused", 4, 3, 2, 7, 96, 0.0),
    ("mb", 4, 3, 2, 10, 192, 0.25),
    ("mb", 6, 3, 1, 19, 224, 0.25),
    ("mb", 6, 3, 2, 25, 384, 0.25),
    ("mb", 6, 3, 1, 7, 640, 0.25),
)


class EfficientNetV2(_Net):
    def __init__(self, spec=V2_S_SPEC, stem_width: int = 24, drop_rate: float = 0.0,
                 dtype=torch.float32, ghost_bn: int = 0, img_size=(224, 224)):
        super().__init__()
        g = ghost_bn
        self.num_features = 1280
        self.ConvBN_0 = ConvBN(3, stem_width, 3, 2, act=F.silu, dtype=dtype, ghost_bn=g)
        self._blocks = []
        ch = stem_width
        for block, expand, kernel, stride, repeats, out, se in spec:
            for i in range(repeats):
                s = stride if i == 0 else 1
                if block == "fused":
                    self._add(FusedMBConv(ch, expand, kernel, s, out, dtype=dtype, ghost_bn=g))
                else:
                    self._add(MBConv(ch, expand, kernel, s, out, se_ratio=se, dtype=dtype,
                                     ghost_bn=g))
                ch = out
        self._finish(ch, drop_rate, dtype, g)


efficientnet_b0 = partial(EfficientNet, width_mult=1.0, depth_mult=1.0)
efficientnet_b1 = partial(EfficientNet, width_mult=1.0, depth_mult=1.1)
efficientnet_b2 = partial(EfficientNet, width_mult=1.1, depth_mult=1.2)
efficientnet_b3 = partial(EfficientNet, width_mult=1.2, depth_mult=1.4)
efficientnet_b4 = partial(EfficientNet, width_mult=1.4, depth_mult=1.8)
efficientnet_b5 = partial(EfficientNet, width_mult=1.6, depth_mult=2.2)
efficientnet_b6 = partial(EfficientNet, width_mult=1.8, depth_mult=2.6)
efficientnet_b7 = partial(EfficientNet, width_mult=2.0, depth_mult=3.1)
efficientnetv2_s = partial(EfficientNetV2, spec=V2_S_SPEC)
efficientnetv2_m = partial(EfficientNetV2, spec=V2_M_SPEC)
efficientnetv2_l = partial(EfficientNetV2, spec=V2_L_SPEC, stem_width=32)

NAMES = tuple(f"efficientnet_b{i}" for i in range(8)) + tuple(
    f"efficientnetv2_{s}" for s in "sml")
