"""Backbone registry of the port (counterpart of ``nkbx/models/registry.py``).

The port holds the Swin, ViT/DeiT, ConvNeXt, ResNet, MobileNetV3 and
EfficientNet (B0-B7, V2 S/M/L) families so far; every other nkbx name raises,
and ROADMAP.md says when it comes. ``pretrained=True`` is nkbx's rule
(:mod:`nkbx_torch.models.pretrained`).
"""

from __future__ import annotations

import torch

from nkbx_torch.models import convnext, efficientnet, mobilenetv3, resnet, swin, vit
from nkbx_torch.models.pretrained import (load_pretrained_into, pretrained_params_path,
                                          warn_no_pretrained)

_REGISTRY = {
    "swin_tiny_patch4_window7_224": swin.swin_tiny_patch4_window7_224,
    "swin_small_patch4_window7_224": swin.swin_small_patch4_window7_224,
    "swin_base_patch4_window7_224": swin.swin_base_patch4_window7_224,
    "swin_large_patch4_window7_224": swin.swin_large_patch4_window7_224,
    "swin_base_patch4_window12_384": swin.swin_base_patch4_window12_384,
    "swin_large_patch4_window12_384": swin.swin_large_patch4_window12_384,
    **{name: getattr(vit, name) for name in (
        "vit_tiny_patch16_224", "vit_small_patch16_224", "vit_small_patch32_224",
        "vit_base_patch16_224", "vit_base_patch32_224", "vit_large_patch16_224",
        "deit_tiny_patch16_224", "deit_small_patch16_224", "deit_base_patch16_224",
        "vit_tiny_patch16_384", "vit_small_patch16_384", "vit_small_patch32_384",
        "vit_base_patch16_384", "vit_base_patch32_384", "vit_large_patch16_384",
        "vit_large_patch32_384")},
    **{name: getattr(convnext, name) for name in (
        "convnext_tiny", "convnext_small", "convnext_base", "convnext_large", "convnext_xlarge")},
    **{name: getattr(resnet, name) for name in resnet.NAMES},
    **{name: getattr(mobilenetv3, name) for name in mobilenetv3.NAMES},
    **{name: getattr(efficientnet, name) for name in efficientnet.NAMES},
}


def list_backbones():
    return sorted(_REGISTRY)


def create_backbone(name: str, pretrained: bool = False, drop_rate: float = 0.0,
                    dtype=torch.bfloat16, img_size=(224, 224), generator=None, **opts):
    """Build a backbone module by its nkbx name; ``module.num_features`` is
    the embedding size. ``**opts`` are the family's fields (Swin and ViT:
    ``fused_attention``, ``fused_mlp``; ConvNeXt: ``fused_mlp``; ResNet:
    ``ghost_bn``, ``fused_bottleneck``, ``s2d_stem``; MobileNetV3 and
    EfficientNet: ``ghost_bn``). With a ``generator`` the weights are drawn
    from it by flax's initialisers. With ``pretrained``, nkbx's rule: the
    converted file under ``$NKBX_PRETRAINED_DIR`` fills the backbone, or,
    without one, a warning with nkbx's message and the weights stay random;
    nothing is downloaded."""
    if name.lower().startswith("unicom"):
        raise NotImplementedError(
            f"backbone {name!r}: the unicom ViTs (UnicomViT: no class token, the flattened-token "
            "feature head with its BatchNorm1d pair) are not ported to nkbx_torch yet "
            "(ROADMAP.md A7)")
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to nkbx_torch yet (ported: the Swin, ViT/DeiT, "
            f"ConvNeXt, ResNet, MobileNetV3 and EfficientNet families, {list_backbones()}); "
            "ROADMAP.md lists the order of the port")
    module = _REGISTRY[name](drop_rate=drop_rate, dtype=dtype, img_size=tuple(img_size), **opts)
    if generator is not None:
        module.reset_parameters(generator)
    if pretrained:
        path = pretrained_params_path(name)
        if path is None:
            warn_no_pretrained(name)
        else:
            load_pretrained_into(module, path)
    return module
