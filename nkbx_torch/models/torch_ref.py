"""Torch-layout templates: ``nn.Module`` replicas whose ``state_dict()`` has
the timm/torchvision/unicom key layout of every registry backbone (the
port's copy of ``nkbx/models/torch_ref.py``).

The keys come out of torch's own naming (``nn.Sequential`` indices, nested
attribute paths, BatchNorm's ``num_batches_tracked``); the channel sizes
come from the port's own models (``make_divisible``, EfficientNet's
rounding and specs, MobileNetV3's specs). The replicas pin keys and shapes
only, for :mod:`nkbx_torch.models.reverse`, which fills a template with
element ids and traces them through the forward converter: they have no
``forward``. ``build_replica(name)`` under ``torch.device("meta")`` costs no
memory.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from nkbx_torch.models.common import make_divisible
from nkbx_torch.models.efficientnet import (_B0_SPEC, V2_L_SPEC, V2_M_SPEC, V2_S_SPEC,
                                            _round_channels, _round_repeats)
from nkbx_torch.models.mobilenetv3 import _LARGE_SPEC, _SMALL_SPEC


def _bn(c):
    return nn.BatchNorm2d(c)


def _conv(i, o, k, s=1, groups=1, bias=False):
    return nn.Conv2d(i, o, k, s, k // 2, groups=groups, bias=bias)


def _linear_pair(dim, hidden):
    """timm's ``mlp`` with ``fc1`` and ``fc2``."""
    mlp = nn.Module()
    mlp.fc1 = nn.Linear(dim, hidden)
    mlp.fc2 = nn.Linear(hidden, dim)
    return mlp


# --- ResNet family (timm resnet.py) ----------------------------------------------


class _TimmSE(nn.Module):
    def __init__(self, ch, rd):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, rd, 1)
        self.fc2 = nn.Conv2d(rd, ch, 1)


def _downsample(inp, out, stride, avg_down):
    """The projection shortcut: a strided 1x1 conv, or ('d' variants) a pool
    and a 1x1 conv at Sequential indices 1 and 2."""
    if not avg_down:
        return nn.Sequential(_conv(inp, out, 1, stride), _bn(out))
    return nn.Sequential(nn.Identity(), _conv(inp, out, 1), _bn(out))


class _TimmBasicBlock(nn.Module):
    def __init__(self, inp, planes, stride, avg_down=False):
        super().__init__()
        self.conv1, self.bn1 = _conv(inp, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        if stride != 1 or inp != planes:
            self.downsample = _downsample(inp, planes, stride, avg_down)


class _TimmBottleneck(nn.Module):
    def __init__(self, inp, planes, stride, cardinality=1, base_width=64, se_ratio=0.0,
                 avg_down=False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * cardinality
        out = planes * 4
        self.conv1, self.bn1 = _conv(inp, width, 1), _bn(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride, groups=cardinality), _bn(width)
        self.conv3, self.bn3 = _conv(width, out, 1), _bn(out)
        if se_ratio > 0:
            self.se = _TimmSE(out, int(out * se_ratio))
        if stride != 1 or inp != out:
            self.downsample = _downsample(inp, out, stride, avg_down)


class TimmResNet(nn.Module):
    def __init__(self, stage_sizes, bottleneck, tiered=False, stem_width=64, cardinality=1,
                 base_width=64, se_ratio=0.0, deep=False, avg_down=False):
        super().__init__()
        if tiered or deep:  # convs at Sequential indices 0, 3, 6
            w = stem_width
            c0 = 3 * w // 4 if tiered else w
            self.conv1 = nn.Sequential(_conv(3, c0, 3, 2), _bn(c0), nn.ReLU(),
                                       _conv(c0, w, 3), _bn(w), nn.ReLU(), _conv(w, 2 * w, 3))
            inp = 2 * w
        else:
            self.conv1 = _conv(3, stem_width, 7, 2)
            inp = stem_width
        self.bn1 = _bn(inp)
        for stage, n in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                if bottleneck:
                    blocks.append(_TimmBottleneck(inp, planes, stride, cardinality, base_width,
                                                  se_ratio, avg_down))
                    inp = planes * 4
                else:
                    blocks.append(_TimmBasicBlock(inp, planes, stride, avg_down))
                    inp = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(inp, 1000)  # the classifier the converter drops


# --- timm's efficientnet-builder blocks (MobileNetV3, EfficientNet B and V2) -------


class _TimmBuilderSE(nn.Module):
    def __init__(self, ch, rd):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, rd, 1)
        self.conv_expand = nn.Conv2d(rd, ch, 1)


class _TimmDepthwiseSeparable(nn.Module):
    """conv_dw/bn1 [+ se] + conv_pw/bn2."""

    def __init__(self, inp, out, k, stride, se_rd=0):
        super().__init__()
        self.conv_dw, self.bn1 = _conv(inp, inp, k, stride, groups=inp), _bn(inp)
        if se_rd:
            self.se = _TimmBuilderSE(inp, se_rd)
        self.conv_pw, self.bn2 = _conv(inp, out, 1), _bn(out)


class _TimmInvertedResidual(nn.Module):
    """conv_pw/bn1 + conv_dw/bn2 [+ se] + conv_pwl/bn3."""

    def __init__(self, inp, mid, out, k, stride, se_rd=0):
        super().__init__()
        self.conv_pw, self.bn1 = _conv(inp, mid, 1), _bn(mid)
        self.conv_dw, self.bn2 = _conv(mid, mid, k, stride, groups=mid), _bn(mid)
        if se_rd:
            self.se = _TimmBuilderSE(mid, se_rd)
        self.conv_pwl, self.bn3 = _conv(mid, out, 1), _bn(out)


class _TimmConvBnAct(nn.Module):
    def __init__(self, inp, out, k, stride=1):
        super().__init__()
        self.conv, self.bn1 = _conv(inp, out, k, stride), _bn(out)


class _TimmEdgeResidual(nn.Module):
    """conv_exp/bn1 + conv_pwl/bn2 (fused MBConv, expand > 1)."""

    def __init__(self, inp, mid, out, k, stride):
        super().__init__()
        self.conv_exp, self.bn1 = _conv(inp, mid, k, stride), _bn(mid)
        self.conv_pwl, self.bn2 = _conv(mid, out, 1), _bn(out)


class TimmMobileNetV3(nn.Module):
    def __init__(self, spec, stage_blocks, last_conv, head_features):
        super().__init__()
        self.conv_stem, self.bn1 = _conv(3, 16, 3, 2), _bn(16)
        flat, inp = [], 16
        for k, e, o, use_se, _act, s in spec:
            e, o = make_divisible(e), make_divisible(o)
            se_rd = make_divisible(e // 4) if use_se else 0
            flat.append(_TimmDepthwiseSeparable(inp, o, k, s, se_rd) if e == inp
                        else _TimmInvertedResidual(inp, e, o, k, s, se_rd))
            inp = o
        stages, i = [], 0
        for n in stage_blocks:
            stages.append(nn.Sequential(*flat[i:i + n]))
            i += n
        if i != len(flat):
            raise ValueError("the stage split must cover every block")
        stages.append(nn.Sequential(_TimmConvBnAct(inp, last_conv, 1)))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(last_conv, head_features, 1)
        self.classifier = nn.Linear(head_features, 1000)


class TimmEfficientNet(nn.Module):
    def __init__(self, width_mult, depth_mult):
        super().__init__()
        stem = _round_channels(32, width_mult)
        self.conv_stem, self.bn1 = _conv(3, stem, 3, 2), _bn(stem)
        stages, inp = [], stem
        for expand, k, stride, repeats, out in _B0_SPEC:
            out_c = _round_channels(out, width_mult)
            blocks = []
            for b in range(_round_repeats(repeats, depth_mult)):
                s, se_rd = (stride if b == 0 else 1), max(1, int(inp * 0.25))
                blocks.append(_TimmDepthwiseSeparable(inp, out_c, k, s, se_rd) if expand == 1
                              else _TimmInvertedResidual(inp, inp * expand, out_c, k, s, se_rd))
                inp = out_c
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        head = _round_channels(1280, width_mult)
        self.conv_head, self.bn2 = _conv(inp, head, 1), _bn(head)
        self.classifier = nn.Linear(head, 1000)


class TimmEfficientNetV2(nn.Module):
    def __init__(self, spec, stem_width=24):
        super().__init__()
        self.conv_stem, self.bn1 = _conv(3, stem_width, 3, 2), _bn(stem_width)
        stages, inp = [], stem_width
        for block, expand, k, stride, repeats, out, se in spec:
            blocks = []
            for b in range(repeats):
                s = stride if b == 0 else 1
                if block == "fused":
                    blocks.append(_TimmConvBnAct(inp, out, k, s) if expand == 1
                                  else _TimmEdgeResidual(inp, inp * expand, out, k, s))
                else:
                    blocks.append(_TimmInvertedResidual(inp, inp * expand, out, k, s,
                                                        max(1, int(inp * se))))
                inp = out
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head, self.bn2 = _conv(inp, 1280, 1), _bn(1280)
        self.classifier = nn.Linear(1280, 1000)


# --- torchvision/timm DenseNet ----------------------------------------------------


class _DenseLayer(nn.Module):
    def __init__(self, inp, growth, bn_size=4):
        super().__init__()
        self.norm1, self.conv1 = _bn(inp), _conv(inp, bn_size * growth, 1)
        self.norm2, self.conv2 = _bn(bn_size * growth), _conv(bn_size * growth, growth, 3)


class TorchDenseNet(nn.Module):
    def __init__(self, block_config, growth=32, init_features=64):
        super().__init__()
        feats = OrderedDict(conv0=_conv(3, init_features, 7, 2), norm0=_bn(init_features))
        c = init_features
        for bi, n_layers in enumerate(block_config, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                block.add_module(f"denselayer{li}", _DenseLayer(c, growth))
                c += growth
            feats[f"denseblock{bi}"] = block
            if bi != len(block_config):
                tr = nn.Module()
                tr.norm, tr.conv = _bn(c), _conv(c, c // 2, 1)
                feats[f"transition{bi}"] = tr
                c //= 2
        feats["norm5"] = _bn(c)
        self.features = nn.Sequential(feats)
        self.classifier = nn.Linear(c, 1000)


# --- timm ConvNeXt ------------------------------------------------------------------


class _ConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _linear_pair(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))


class TimmConvNeXt(nn.Module):
    def __init__(self, depths, dims):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, 4), nn.LayerNorm(dims[0], eps=1e-6))
        stages = []
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            stage = nn.Module()
            if s > 0:
                stage.downsample = nn.Sequential(nn.LayerNorm(dims[s - 1], eps=1e-6),
                                                 nn.Conv2d(dims[s - 1], dim, 2, 2))
            stage.blocks = nn.Sequential(*[_ConvNeXtBlock(dim) for _ in range(depth)])
            stages.append(stage)
        self.stages = nn.Sequential(*stages)
        self.head = nn.Module()
        self.head.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head.fc = nn.Linear(dims[-1], 1000)


# --- timm ViT and deepglint unicom ------------------------------------------------------


class _TorchViTBlock(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = _linear_pair(dim, 4 * dim)


class TimmViT(nn.Module):
    def __init__(self, dim, depth, patch, img=224):
        super().__init__()
        n = (img // patch) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        self.blocks = nn.Sequential(*[_TorchViTBlock(dim) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, 1000)


class UnicomViTReplica(nn.Module):
    """No class token, a bias-free patch conv, and the ``feature`` Sequential
    of Linear (no bias) / BatchNorm1d pairs."""

    def __init__(self, dim, depth, patch, emb, img=224):
        super().__init__()
        n = (img // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, n, dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch, bias=False)
        self.blocks = nn.Sequential(*[_TorchViTBlock(dim, eps=1e-5) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.feature = nn.Sequential(
            nn.Linear(n * dim, dim, bias=False), nn.BatchNorm1d(dim, eps=2e-5),
            nn.Linear(dim, emb, bias=False), nn.BatchNorm1d(emb, eps=2e-5))


# --- timm Swin V1 (>= 0.9: the patch merge at the input of the next stage) -----------


class _SwinBlock(nn.Module):
    def __init__(self, dim, heads, shifted, window, n_windows=64):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = nn.Module()
        self.attn.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.attn.register_buffer("relative_position_index",
                                  torch.zeros(window ** 2, window ** 2, dtype=torch.long))
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _linear_pair(dim, 4 * dim)
        if shifted:  # a buffer nkbx recomputes: the converter skips it
            self.register_buffer("attn_mask", torch.zeros(n_windows, window ** 2, window ** 2))


class TimmSwin(nn.Module):
    def __init__(self, embed_dim, depths, n_heads, window=7):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, 4, 4)
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        layers, dim = [], embed_dim
        for i, (depth, heads) in enumerate(zip(depths, n_heads)):
            stage = nn.Module()
            if i > 0:
                stage.downsample = nn.Module()
                stage.downsample.norm = nn.LayerNorm(4 * dim)
                stage.downsample.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
                dim *= 2
            stage.blocks = nn.Sequential(*[_SwinBlock(dim, heads, bool(j % 2), window)
                                           for j in range(depth)])
            layers.append(stage)
        self.layers = nn.Sequential(*layers)
        self.norm = nn.LayerNorm(dim)
        self.head = nn.Linear(dim, 1000)


# --- registry names ---------------------------------------------------------------------

_RESNETS = {
    "resnet_tiny_test": dict(stage_sizes=(1, 1), bottleneck=False, stem_width=16),
    "resnet14t": dict(stage_sizes=(1, 1, 1, 1), bottleneck=True, tiered=True, stem_width=32),
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False),
    "resnet18d": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False, deep=True, stem_width=32,
                      avg_down=True),
    "resnet26": dict(stage_sizes=(2, 2, 2, 2), bottleneck=True),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), bottleneck=False),
    "resnet34d": dict(stage_sizes=(3, 4, 6, 3), bottleneck=False, deep=True, stem_width=32,
                      avg_down=True),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    "resnet50d": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, deep=True, stem_width=32,
                      avg_down=True),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), bottleneck=True),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), bottleneck=True),
    "resnext50_32x4d": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, cardinality=32,
                            base_width=4),
    "resnext101_32x8d": dict(stage_sizes=(3, 4, 23, 3), bottleneck=True, cardinality=32,
                             base_width=8),
    "wide_resnet50_2": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, base_width=128),
    "seresnet50": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, se_ratio=1 / 16),
    "seresnext50_32x4d": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, cardinality=32,
                              base_width=4, se_ratio=1 / 16),
}
_EFFNETS = {"efficientnet_b0": (1.0, 1.0), "efficientnet_b1": (1.0, 1.1),
            "efficientnet_b2": (1.1, 1.2), "efficientnet_b3": (1.2, 1.4),
            "efficientnet_b4": (1.4, 1.8), "efficientnet_b5": (1.6, 2.2),
            "efficientnet_b6": (1.8, 2.6), "efficientnet_b7": (2.0, 3.1)}
_DENSENETS = {"densenet121": (6, 12, 24, 16), "densenet169": (6, 12, 32, 32),
              "densenet201": (6, 12, 48, 32)}
_CONVNEXTS = {"convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
              "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
              "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
              "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
              "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048))}
_VITS = {"vit_tiny_patch16_224": (192, 12, 16), "vit_small_patch16_224": (384, 12, 16),
         "vit_small_patch32_224": (384, 12, 32), "vit_base_patch16_224": (768, 12, 16),
         "vit_base_patch32_224": (768, 12, 32), "vit_large_patch16_224": (1024, 24, 16),
         "deit_tiny_patch16_224": (192, 12, 16), "deit_small_patch16_224": (384, 12, 16),
         "deit_base_patch16_224": (768, 12, 16), "vit_tiny_patch16_384": (192, 12, 16, 384),
         "vit_small_patch16_384": (384, 12, 16, 384),
         "vit_small_patch32_384": (384, 12, 32, 384),
         "vit_base_patch16_384": (768, 12, 16, 384), "vit_base_patch32_384": (768, 12, 32, 384),
         "vit_large_patch16_384": (1024, 24, 16, 384),
         "vit_large_patch32_384": (1024, 24, 32, 384)}
_UNICOMS = {"unicom ViT-B/32": (768, 12, 32, 512), "unicom ViT-B/16": (768, 12, 16, 768),
            "unicom ViT-L/14": (1024, 24, 14, 768)}
_SWINS = {"swin_tiny_patch4_window7_224": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
          "swin_small_patch4_window7_224": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
          "swin_base_patch4_window7_224": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
          "swin_large_patch4_window7_224": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
          "swin_base_patch4_window12_384": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12),
          "swin_large_patch4_window12_384": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)}


def build_replica(name: str) -> nn.Module:
    """The timm/torchvision/unicom-layout template of registry backbone ``name``."""
    if name in _RESNETS:
        return TimmResNet(**_RESNETS[name])
    if name == "mobilenetv3_large_100":
        return TimmMobileNetV3(_LARGE_SPEC, [1, 2, 3, 4, 2, 3], 960, 1280)
    if name == "mobilenetv3_small_100":
        return TimmMobileNetV3(_SMALL_SPEC, [1, 2, 3, 2, 3], 576, 1024)
    if name in _EFFNETS:
        return TimmEfficientNet(*_EFFNETS[name])
    if name in ("efficientnetv2_s", "efficientnetv2_m"):
        return TimmEfficientNetV2(V2_S_SPEC if name.endswith("_s") else V2_M_SPEC)
    if name == "efficientnetv2_l":
        return TimmEfficientNetV2(V2_L_SPEC, stem_width=32)
    if name in _DENSENETS:
        return TorchDenseNet(_DENSENETS[name])
    if name in _CONVNEXTS:
        return TimmConvNeXt(*_CONVNEXTS[name])
    if name in _VITS:
        return TimmViT(*_VITS[name])
    if name in _UNICOMS:
        return UnicomViTReplica(*_UNICOMS[name])
    if name in _SWINS:
        return TimmSwin(*_SWINS[name])
    raise NotImplementedError(name)
