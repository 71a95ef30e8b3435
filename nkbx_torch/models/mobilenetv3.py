"""MobileNetV3 (large, small), NHWC. Counterpart of
``nkbx/models/mobilenetv3.py``, with the submodule names of its flax tree
(``InvertedResidual_3.ConvBN_1.Conv_0.weight``,
``InvertedResidual_3.SqueezeExcite_0.Conv_1.bias``, ``Dense_0``), so that
weights and running statistics carry across by a tree walk
(:mod:`nkbx_torch.models.convert`).

The depthwise convolutions are ``ConvBN(groups=channels)``; every
BatchNorm is :class:`~nkbx_torch.models.common.TorchBatchNorm` (exact or
masked; ``ghost_bn`` as in the other families). The feature head is nkbx's:
global pool, ``Dense_0`` to ``head_features``, hard_swish, dropout.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import torch
from torch import nn

from nkbx_torch.models.common import (ConvBN, Dense, Dropout, SqueezeExcite, TorchBatchNorm,
                                      global_avg_pool, hard_swish, init_conv_, init_dense_,
                                      make_divisible)

# (kernel, exp_size, out, use_se, activation, stride)
_LARGE_SPEC: Sequence[Tuple[int, int, int, bool, str, int]] = (
    (3, 16, 16, False, "re", 1),
    (3, 64, 24, False, "re", 2),
    (3, 72, 24, False, "re", 1),
    (5, 72, 40, True, "re", 2),
    (5, 120, 40, True, "re", 1),
    (5, 120, 40, True, "re", 1),
    (3, 240, 80, False, "hs", 2),
    (3, 200, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1),
    (3, 480, 112, True, "hs", 1),
    (3, 672, 112, True, "hs", 1),
    (5, 672, 160, True, "hs", 2),
    (5, 960, 160, True, "hs", 1),
    (5, 960, 160, True, "hs", 1),
)

_SMALL_SPEC: Sequence[Tuple[int, int, int, bool, str, int]] = (
    (3, 16, 16, True, "re", 2),
    (3, 72, 24, False, "re", 2),
    (3, 88, 24, False, "re", 1),
    (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1),
    (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1),
    (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2),
    (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1),
)


def _act(name):
    return hard_swish if name == "hs" else True  # True: ConvBN's relu


def reset_mobile_parameters(net: nn.Module, generator: torch.Generator):
    """flax's initialisers, drawn from ``generator``: lecun-normal convolution
    and Dense kernels, zero biases, BatchNorm ones/zeros and running
    statistics 0/1."""
    for mod in net.modules():
        if isinstance(mod, nn.Conv2d):
            init_conv_(mod, generator)
        elif isinstance(mod, nn.Linear):
            init_dense_(mod, generator)
        elif isinstance(mod, TorchBatchNorm):
            mod.reset_parameters()


class InvertedResidual(nn.Module):
    """The 1x1 expansion (where exp_size differs from the input), the k x k
    depthwise ConvBN, SqueezeExcite after it (reduced to
    make_divisible(exp_size // 4), relu, hard_sigmoid gate), the 1x1
    projection without activation, and the residual at stride 1 with equal
    widths (nkbx mobilenetv3.py:54-77)."""

    def __init__(self, features_in: int, kernel: int, exp_size: int, out: int, use_se: bool,
                 act_name: str, strides: int, dtype=torch.float32, ghost_bn: int = 0):
        super().__init__()
        act, g = _act(act_name), ghost_bn
        self.residual = strides == 1 and features_in == out
        convs = []
        if exp_size != features_in:
            convs.append(ConvBN(features_in, exp_size, 1, 1, act=act, dtype=dtype, ghost_bn=g))
        convs.append(ConvBN(exp_size, exp_size, kernel, strides, groups=exp_size, act=act,
                            dtype=dtype, ghost_bn=g))
        self.SqueezeExcite_0 = (SqueezeExcite(exp_size, make_divisible(exp_size // 4),
                                              dtype=dtype) if use_se else None)
        convs.append(ConvBN(exp_size, out, 1, 1, act=False, dtype=dtype, ghost_bn=g))
        self._convs = [f"ConvBN_{i}" for i in range(len(convs))]
        for name, conv in zip(self._convs, convs):
            self.add_module(name, conv)

    def forward(self, x, mask=None):
        y = x
        for name in self._convs[:-1]:
            y = getattr(self, name)(y, mask)
        if self.SqueezeExcite_0 is not None:
            y = self.SqueezeExcite_0(y)
        y = getattr(self, self._convs[-1])(y, mask)
        return y + x if self.residual else y


class MobileNetV3(nn.Module):
    def __init__(self, spec=_LARGE_SPEC, width_mult: float = 1.0, last_conv: int = 960,
                 head_features: int = 1280, drop_rate: float = 0.0, dtype=torch.float32,
                 ghost_bn: int = 0, img_size=(224, 224)):
        super().__init__()
        wm, g = width_mult, ghost_bn
        self.num_features = head_features
        ch = make_divisible(16 * wm)
        self.ConvBN_0 = ConvBN(3, ch, 3, 2, act=hard_swish, dtype=dtype, ghost_bn=g)
        self._blocks = []
        for k, e, o, se, a, s in spec:
            out = make_divisible(o * wm)
            name = f"InvertedResidual_{len(self._blocks)}"
            self.add_module(name, InvertedResidual(ch, k, make_divisible(e * wm), out, se, a, s,
                                                   dtype, g))
            self._blocks.append(name)
            ch = out
        last = make_divisible(last_conv * wm)
        self.ConvBN_1 = ConvBN(ch, last, 1, 1, act=hard_swish, dtype=dtype, ghost_bn=g)
        self.Dense_0 = Dense(last, head_features, dtype=dtype)
        # as in nkbx, the dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator):
        reset_mobile_parameters(self, generator)

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC -> (B, num_features) float32. ``mask`` (B, 1, 1,
        1) weights padded rows out of every BatchNorm's statistics in
        training."""
        x = self.ConvBN_0(x, mask)
        for name in self._blocks:
            x = getattr(self, name)(x, mask)
        x = global_avg_pool(self.ConvBN_1(x, mask))
        return self.dropout(hard_swish(self.Dense_0(x))).float()


mobilenetv3_large_100 = partial(MobileNetV3, spec=_LARGE_SPEC, last_conv=960, head_features=1280)
mobilenetv3_small_100 = partial(MobileNetV3, spec=_SMALL_SPEC, last_conv=576, head_features=1024)

NAMES = ("mobilenetv3_large_100", "mobilenetv3_small_100")
