"""The ResNet family (resnet14t ... resnet152, ResNeXt, wide, SE and 'd'
variants), NHWC. Counterpart of ``nkbx/models/resnet.py``, with the submodule
names of its flax tree (``ConvBN_0.Conv_0.weight``,
``Bottleneck_3.ConvBN_1.BatchNorm_0.running_var``, ``downsample``,
``se.fc1``), so that weights and running statistics carry across by a tree
walk (:mod:`nkbx_torch.models.convert`).

Every convolution computes in the compute dtype on the channels-last NCHW
view ``x.permute(0, 3, 1, 2)``; every BatchNorm is
:class:`~nkbx_torch.models.common.TorchBatchNorm` (exact, masked or ghost).

``fused_bottleneck=True`` (with ``ghost_bn=g``) runs each stride-1 identity
Bottleneck block in training through the fused chain
(:func:`nkbx_torch.ops.bottleneck.fused_chain`: K9/K10 on the card) with
tile-local statistics, wherever nkbx's rule
:func:`~nkbx_torch.ops.bottleneck.stat_band` gives a band; every other block,
and every block in eval mode, takes the plain ghost-BN path, as in nkbx.

nkbx's max-throughput opt-ins: ``remat_stages`` runs the blocks of those
stages under :func:`~nkbx_torch.models.common.remat` (recomputed in the
backward, K9 included; the same names and numbers, running statistics
updated once), and ``input_norm=(mean, std)`` folds Normalize into the s2d
stem (:class:`_MaskedS2DConv`), so that the model takes the raw [0, 255]
batch.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import ConvBN, TorchBatchNorm, init_conv_, lecun_normal_, remat
from nkbx_torch.ops.bottleneck import fused_chain, stat_band


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _avg_down_pool(x):
    """timm's avg_down shortcut pool on NHWC x: AvgPool2d(2, 2, ceil_mode=True,
    count_include_pad=False); for odd H/W the trailing row/col pools over its
    1-wide valid window."""
    return _nhwc(F.avg_pool2d(_nchw(x), 2, 2, ceil_mode=True, count_include_pad=False))


def space_to_depth(x, block: int = 2):
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C); channel order (row, col, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def _s2d_tap_mask(c: int) -> np.ndarray:
    """(4, 4, 4c, 1) 0/1 mask of the live taps of the s2d stem kernel (HWIO):
    the 4x4-over-blocks kernel covers an 8x8 window, the 7x7 conv's taps sit
    at offsets 1..7, so the taps at offset 0 are dead."""
    m = np.zeros((4, 4, 2, 2, c), np.float32)
    for u in range(4):
        for v in range(4):
            for r in range(2):
                for s in range(2):
                    if 2 * u + r > 0 and 2 * v + s > 0:
                        m[u, v, r, s] = 1.0
    return m.reshape(4, 4, 4 * c)[..., None]


class _MaskedS2DConv(nn.Module):
    """4x4/s1 conv over the space-to-depth input with padding ((2, 1), (2, 1))
    and the dead taps zeroed in the forward (so their gradient is 0): exactly
    the 7x7/s2 pad-3 stem conv. ``weight`` (features, 4c, 4, 4) is the OIHW
    form of nkbx's (4, 4, 4c, features) kernel.

    ``input_norm=(mean, std)`` (pixel units, [0, 255]) folds Normalize into
    the conv, as nkbx's ``_MaskedS2DConv`` does (resnet.py:55-113): the
    kernel is scaled by 1/std per input channel in f32 and then cast, and the
    mean comes off through a bias map, so the layer computes
    conv((x - mean) / std) on the raw batch, borders included. The map is the
    conv of a 12x12 constant mean image, its rows and columns 0-3 and 8-11
    kept and row/column 5 repeated between them: every output position sees
    the taps of one of those."""

    def __init__(self, features_in: int, features: int, dtype=torch.float32, input_norm=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, features_in, 4, 4))
        mask = _s2d_tap_mask(features_in // 4).transpose(3, 2, 0, 1)
        self.register_buffer("tap_mask", torch.from_numpy(np.ascontiguousarray(mask)),
                             persistent=False)
        self.folded = input_norm is not None
        if self.folded:
            mean, std = (np.asarray(v, np.float32) for v in input_norm)
            reps = features_in // 3  # the s2d channel order is (row, col, c)
            self.register_buffer("norm_inv", torch.from_numpy(np.tile(1.0 / std, reps)),
                                 persistent=False)
            self.register_buffer("norm_mean", torch.from_numpy(np.tile(mean, reps)),
                                 persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's lecun-normal kernel (fan-in 4·4·4c), as ``nn.Conv``'s."""
        w = self.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)

    @staticmethod
    def _conv(x, k):
        return _nhwc(F.conv2d(F.pad(_nchw(x), (2, 1, 2, 1)), k))

    def forward(self, x):
        k32 = self.weight * self.tap_mask
        if not self.folded:
            return self._conv(x.to(self.dtype), k32.to(self.dtype))
        k = (k32 * self.norm_inv[None, :, None, None]).to(self.dtype)
        s = 12
        probe = self._conv(self.norm_mean.expand(1, s, s, -1).to(self.dtype), k)

        def tile(t, dim, n):
            mid = t.narrow(dim, 5, 1).expand(*[n - 8 if d == dim else -1 for d in range(4)])
            return torch.cat([t.narrow(dim, 0, 4), mid, t.narrow(dim, s - 4, 4)], dim)

        bias_map = tile(tile(probe, 1, x.shape[1]), 2, x.shape[2])
        return self._conv(x.to(self.dtype), k) - bias_map


class S2DStemConvBN(nn.Module):
    """The space-to-depth stem: ``Conv_0`` (masked 4x4) + ``BatchNorm_0`` +
    relu, the tree paths of a ConvBN."""

    def __init__(self, features_in: int, features: int, dtype=torch.float32, ghost_bn: int = 0,
                 input_norm=None):
        super().__init__()
        self.Conv_0 = _MaskedS2DConv(features_in, features, dtype, input_norm)
        self.BatchNorm_0 = TorchBatchNorm(features, dtype=dtype, ghost_bn=ghost_bn)

    def forward(self, x, mask=None):
        y = self.BatchNorm_0(self.Conv_0(x), mask=mask if self.training else None)
        return torch.relu(y)


def _downsample(features_in, out, strides, avg_down, dtype, ghost_bn):
    """The projection shortcut: a 1x1 ConvBN, strided, or after the avg-down pool."""
    return ConvBN(features_in, out, 1, 1 if avg_down else strides, act=False, dtype=dtype,
                  ghost_bn=ghost_bn)


def _shortcut(block, x, mask):
    if block.downsample is None:
        return x
    ds = _avg_down_pool(x) if block.avg_down and block.strides > 1 else x
    return block.downsample(ds, mask)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, features_in: int, features: int, strides: int = 1, dtype=torch.float32,
                 ghost_bn: int = 0, avg_down: bool = False):
        super().__init__()
        self.strides, self.avg_down = strides, avg_down
        g = ghost_bn
        self.ConvBN_0 = ConvBN(features_in, features, 3, strides, dtype=dtype, ghost_bn=g)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, act=False, dtype=dtype, ghost_bn=g)
        self.downsample = (_downsample(features_in, features, strides, avg_down, dtype, g)
                           if features_in != features or strides != 1 else None)

    def forward(self, x, mask=None):
        y = self.ConvBN_1(self.ConvBN_0(x, mask), mask)
        return torch.relu(y + _shortcut(self, x, mask))


class SEModule(nn.Module):
    """timm's SEModule: global pool (f32, then the compute dtype) -> fc1 1x1
    conv -> relu -> fc2 -> sigmoid gate, the convolutions with biases in the
    compute dtype."""

    def __init__(self, channels: int, rd_channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)

    def _fc(self, s, conv):
        dt = self.dtype
        return F.linear(s, conv.weight.reshape(conv.weight.shape[:2]).to(dt), conv.bias.to(dt))

    def forward(self, x):
        s = x.float().mean((1, 2), keepdim=True).to(self.dtype)
        s = self._fc(torch.relu(self._fc(s, self.fc1)), self.fc2)
        return x * torch.sigmoid(s)


class Bottleneck(nn.Module):
    """timm's Bottleneck: width = floor(planes * base_width/64) * cardinality,
    the 3x3 conv grouped by cardinality, optional SE after bn3 before the
    residual add. With ``fused`` the block runs in training through the fused
    chain where nkbx does (resnet.py:209-223)."""

    expansion = 4

    def __init__(self, features_in: int, features: int, strides: int = 1, cardinality: int = 1,
                 base_width: int = 64, se_ratio: float = 0.0, dtype=torch.float32,
                 ghost_bn: int = 0, fused: bool = False, avg_down: bool = False):
        super().__init__()
        out = features * self.expansion
        width = int(features * (base_width / 64.0)) * cardinality
        self.strides, self.avg_down, self.dtype = strides, avg_down, dtype
        self.cardinality, self.se_ratio, self.ghost_bn, self.fused = (cardinality, se_ratio,
                                                                       ghost_bn, fused)
        self.width, self.out = width, out
        g = ghost_bn
        self.ConvBN_0 = ConvBN(features_in, width, 1, dtype=dtype, ghost_bn=g)
        self.ConvBN_1 = ConvBN(width, width, 3, strides, groups=cardinality, dtype=dtype,
                               ghost_bn=g)
        self.ConvBN_2 = ConvBN(width, out, 1, act=False, dtype=dtype, ghost_bn=g)
        self.se = SEModule(out, int(out * se_ratio), dtype) if se_ratio > 0 else None
        self.downsample = (_downsample(features_in, out, strides, avg_down, dtype, g)
                           if features_in != out or strides != 1 else None)

    def chain_band(self, x):
        """The statistics band ``th`` when this block runs through the fused
        chain for ``x``, else None (nkbx's gate and its ``chain_tile``)."""
        g = self.ghost_bn
        if not (self.fused and self.training and self.strides == 1 and x.shape[-1] == self.out
                and self.cardinality == 1 and self.se_ratio == 0.0 and g
                and x.shape[0] % g == 0):
            return None
        b, h, w, _ = x.shape
        return stat_band(b, h, w, self.out, self.width, g, self.dtype.itemsize)

    def forward(self, x, mask=None):
        th = self.chain_band(x)
        if th is not None:
            if mask is not None:
                raise ValueError("fused bottleneck requires drop_last=True (no mask)")
            return self._chain(x, th)
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x, mask), mask), mask)
        if self.se is not None:
            y = self.se(y)
        return torch.relu(y + _shortcut(self, x, mask))

    def _chain(self, x, th):
        """The block through :func:`fused_chain`, then the running statistics'
        update toward the mean over tiles (nkbx's ``fused_bottleneck_chain``,
        bottleneck.py:537-565: unbiased with n = g·th·W)."""
        dt, g = self.dtype, self.ghost_bn
        c, m = self.out, self.width
        bns = (self.ConvBN_0.BatchNorm_0, self.ConvBN_1.BatchNorm_0, self.ConvBN_2.BatchNorm_0)
        w1 = self.ConvBN_0.Conv_0.weight.to(dt).reshape(m, c).t()
        w2 = self.ConvBN_1.Conv_0.weight.to(dt).permute(2, 3, 1, 0)
        w3 = self.ConvBN_2.Conv_0.weight.to(dt).reshape(c, m).t()
        vecs = [t for bn in bns for t in (bn.weight, bn.bias)]
        out, stats = fused_chain(x.to(dt), w1, w2, w3, *vecs, g=g, th=th, eps=bns[0].eps)
        n = g * th * x.shape[2]
        unb = n / max(n - 1.0, 1.0)
        for bn, mu, var in zip(bns, stats[0::2], stats[1::2]):
            bn.update_running(mu.mean(0), var.mean(0) * unb)
        return out


class ResNet(nn.Module):
    def __init__(self, stage_sizes, block_cls, stem: str = "default", stem_width: int = 64,
                 cardinality: int = 1, base_width: int = 64, se_ratio: float = 0.0,
                 drop_rate: float = 0.0, dtype=torch.float32, s2d_stem: bool = True,
                 input_norm=None, remat_stages=(), ghost_bn: int = 0,
                 fused_bottleneck: bool = False, avg_down: bool = False, img_size=(224, 224)):
        super().__init__()
        if input_norm is not None and (stem != "default" or not s2d_stem):
            raise ValueError("input_norm folding requires the s2d stem")
        if fused_bottleneck and not ghost_bn:
            raise ValueError("fused_bottleneck requires ghost_bn (per-tile BN stats are the "
                             "kernel's tiling contract)")
        if fused_bottleneck and block_cls is not Bottleneck:
            raise ValueError("fused_bottleneck covers Bottleneck blocks only (resnet26/50/101/"
                             "...); BasicBlock ResNets have no fused chain")
        self.dtype, self.stem, self.s2d_stem = dtype, stem, s2d_stem
        self.num_features = 64 * 2 ** (len(stage_sizes) - 1) * block_cls.expansion
        g = ghost_bn
        if stem in ("tiered", "deep"):
            c0 = 3 * stem_width // 4 if stem == "tiered" else stem_width
            self.ConvBN_0 = ConvBN(3, c0, 3, 2, dtype=dtype, ghost_bn=g)
            self.ConvBN_1 = ConvBN(c0, stem_width, 3, 1, dtype=dtype, ghost_bn=g)
            self.ConvBN_2 = ConvBN(stem_width, 2 * stem_width, 3, 1, dtype=dtype, ghost_bn=g)
            self._stem = ["ConvBN_0", "ConvBN_1", "ConvBN_2"]
            ch = 2 * stem_width
        else:
            self.ConvBN_0 = (S2DStemConvBN(12, stem_width, dtype, g, input_norm) if s2d_stem
                             else ConvBN(3, stem_width, 7, 2, dtype=dtype, ghost_bn=g))
            self._stem = ["ConvBN_0"]
            ch = stem_width
        self._blocks, self._remat = [], set()
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                if block_cls is Bottleneck:
                    mod = Bottleneck(ch, features, strides, cardinality, base_width, se_ratio,
                                     dtype, g, fused_bottleneck, avg_down)
                else:
                    mod = BasicBlock(ch, features, strides, dtype, g, avg_down)
                name = f"{block_cls.__name__}_{len(self._blocks)}"
                self.add_module(name, mod)
                self._blocks.append(name)
                if stage in remat_stages:
                    self._remat.add(name)
                ch = features * block_cls.expansion
        # as in nkbx, the embedding dropout exists only with a rate above 0
        self.dropout = nn.Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal
        convolution kernels, zero biases, BatchNorm ones/zeros and running
        statistics 0/1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                init_conv_(mod, generator)
            elif isinstance(mod, _MaskedS2DConv):
                mod.reset_parameters(generator)
            elif isinstance(mod, TorchBatchNorm):
                mod.reset_parameters()

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC -> (B, num_features) float32. ``mask`` (B, 1, 1,
        1) weights padded rows out of every BatchNorm's statistics in
        training."""
        if self.stem == "default" and self.s2d_stem:
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(f"s2d_stem requires even input H/W, got {tuple(x.shape[1:3])}; "
                                 "construct ResNet(s2d_stem=False) for odd sizes")
            x = space_to_depth(x, 2)
        for name in self._stem:
            x = getattr(self, name)(x, mask)
        x = _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
        for name in self._blocks:
            block = getattr(self, name)
            x = remat(block, x, mask) if name in self._remat else block(x, mask)
        x = x.float().mean((1, 2)).to(self.dtype)
        return self.dropout(x).float()


# tiny 2-stage net for tests (not a timm name)
resnet_tiny_test = partial(ResNet, stage_sizes=(1, 1), block_cls=BasicBlock, stem_width=16)

# timm-name-compatible constructors
resnet14t = partial(ResNet, stage_sizes=(1, 1, 1, 1), block_cls=Bottleneck, stem="tiered",
                    stem_width=32)
resnet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
resnet26 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=Bottleneck)
resnet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
resnet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck)
resnet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck)
resnet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3), block_cls=Bottleneck)
resnext50_32x4d = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, cardinality=32,
                          base_width=4)
resnext101_32x8d = partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck,
                           cardinality=32, base_width=8)
wide_resnet50_2 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, base_width=128)
seresnet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, se_ratio=1 / 16)
seresnext50_32x4d = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                            cardinality=32, base_width=4, se_ratio=1 / 16)
# timm 'd' variants: deep (w, w, 2w) 3x3 stem + avg-pool downsample shortcuts
resnet18d = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, stem="deep",
                    stem_width=32, avg_down=True)
resnet34d = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, stem="deep",
                    stem_width=32, avg_down=True)
resnet50d = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, stem="deep",
                    stem_width=32, avg_down=True)

NAMES = ("resnet_tiny_test", "resnet14t", "resnet18", "resnet26", "resnet34", "resnet50",
         "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
         "seresnet50", "seresnext50_32x4d", "resnet18d", "resnet34d", "resnet50d")
