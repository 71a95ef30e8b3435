"""DenseNet (121, 169, 201), NHWC. Counterpart of ``nkbx/models/densenet.py``,
with the submodule names of its flax tree (``stem_conv``, ``stem_norm``,
``block2_layer5.bottleneck.BatchNorm_0``, ``block2_layer5.conv.Conv_0``,
``transition1.Conv_0``, ``final_norm``), so that weights and running
statistics carry across by a tree walk (:mod:`nkbx_torch.models.convert`).

Each layer is pre-activation, as torchvision's ``_DenseLayer``: BatchNorm,
relu, then the convolution (1x1 to 4·growth, then 3x3 to growth), its
output concatenated onto the running features; a transition is BatchNorm,
relu, a 1x1 convolution to half the channels and a 2x2 average pool. Every
BatchNorm is :class:`~nkbx_torch.models.common.TorchBatchNorm` and takes the
sample ``mask`` in training.

``buffer_concat`` is accepted so that nkbx's ``backbone_opts`` load, and
changes nothing: nkbx's field selects a second lowering of a dense block (one
buffer of the block's final width, written a slice at a time) that gives the
same values and the same tree, and that nkbx measured as slower than the
concat path (its field comment: each slice write copies the whole buffer).
Written without in-place writes, the same lowering in PyTorch copies the
whole buffer at every layer too, so the port keeps the one concat path.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import Dropout, TorchBatchNorm, global_avg_pool, init_conv_


class _BNReluConv(nn.Module):
    """Pre-activation ``BatchNorm_0`` -> relu -> ``Conv_0`` (k x k, no bias,
    symmetric k//2 padding), the convolution in ``dtype``."""

    def __init__(self, features_in: int, features: int, kernel_size: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = TorchBatchNorm(features_in, dtype=dtype)
        self.Conv_0 = nn.Conv2d(features_in, features, kernel_size, padding=kernel_size // 2,
                                bias=False)

    def forward(self, x, mask=None):
        x = torch.relu(self.BatchNorm_0(x, mask=mask if self.training else None))
        c = self.Conv_0
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), c.weight.to(self.dtype),
                     padding=c.padding)
        return y.permute(0, 2, 3, 1)


class DenseLayer(nn.Module):
    """``bottleneck`` (1x1 to bn_size·growth) then ``conv`` (3x3 to growth);
    returns the growth channels alone, the caller joins them on."""

    def __init__(self, features_in: int, growth_rate: int, bn_size: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.bottleneck = _BNReluConv(features_in, bn_size * growth_rate, 1, dtype)
        self.conv = _BNReluConv(bn_size * growth_rate, growth_rate, 3, dtype)

    def forward(self, x, mask=None):
        return self.conv(self.bottleneck(x, mask), mask)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 init_features: int = 64, drop_rate: float = 0.0, dtype=torch.float32,
                 buffer_concat: bool = False, img_size=(224, 224)):
        super().__init__()
        # buffer_concat: nkbx's field, accepted and not used (see the module doc)
        self.dtype, self.growth_rate = dtype, growth_rate
        self.block_config = tuple(block_config)
        self.stem_conv = nn.Conv2d(3, init_features, 7, stride=2, padding=3, bias=False)
        self.stem_norm = TorchBatchNorm(init_features, dtype=dtype)
        c = init_features
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                self.add_module(f"block{i}_layer{j}",
                                DenseLayer(c, growth_rate, dtype=dtype))
                c += growth_rate
            if i != len(self.block_config) - 1:
                self.add_module(f"transition{i}", _BNReluConv(c, c // 2, 1, dtype))
                c //= 2
        self.final_norm = TorchBatchNorm(c, dtype=dtype)
        self.num_features = c
        # as in nkbx, the dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal
        convolution kernels, BatchNorm ones/zeros and running statistics
        0/1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                init_conv_(mod, generator)
            elif isinstance(mod, TorchBatchNorm):
                mod.reset_parameters()

    def _block(self, i: int, x, mask):
        for j in range(self.block_config[i]):
            x = torch.cat([x, getattr(self, f"block{i}_layer{j}")(x, mask)], dim=-1)
        return x

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC -> (B, num_features) float32. ``mask`` (B, 1,
        1, 1) weights padded rows out of every BatchNorm's statistics in
        training."""
        dt = self.dtype
        c = self.stem_conv
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), c.weight.to(dt), stride=c.stride,
                     padding=c.padding).permute(0, 2, 3, 1)
        x = torch.relu(self.stem_norm(x, mask=mask if self.training else None))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for i in range(len(self.block_config)):
            x = self._block(i, x, mask)
            if i != len(self.block_config) - 1:
                x = getattr(self, f"transition{i}")(x, mask)
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        x = torch.relu(self.final_norm(x, mask=mask if self.training else None))
        return self.dropout(global_avg_pool(x)).float()


densenet121 = partial(DenseNet, block_config=(6, 12, 24, 16))
densenet169 = partial(DenseNet, block_config=(6, 12, 32, 32))
densenet201 = partial(DenseNet, block_config=(6, 12, 48, 32))

NAMES = ("densenet121", "densenet169", "densenet201")
