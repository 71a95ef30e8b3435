"""Backbone registry of the port (counterpart of ``nkbx/models/registry.py``).

The port holds the Swin, ViT/DeiT, ConvNeXt and ResNet families so far; every
other nkbx name raises, and ROADMAP.md says when it comes.
"""

from __future__ import annotations

import torch

from nkbx_torch.models import convnext, resnet, swin, vit

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
}


def list_backbones():
    return sorted(_REGISTRY)


def create_backbone(name: str, pretrained: bool = False, drop_rate: float = 0.0,
                    dtype=torch.bfloat16, img_size=(224, 224), **opts):
    """Build a backbone module by its nkbx name; ``module.num_features`` is
    the embedding size. ``**opts`` are the family's fields (Swin and ViT:
    ``fused_attention``, ``fused_mlp``; ConvNeXt: ``fused_mlp``; ResNet:
    ``ghost_bn``, ``fused_bottleneck``, ``s2d_stem``)."""
    if name.lower().startswith("unicom"):
        raise NotImplementedError(
            f"backbone {name!r}: the unicom ViTs (UnicomViT: no class token, the flattened-token "
            "feature head with its BatchNorm1d pair) are not ported to nkbx_torch yet "
            "(ROADMAP.md A7)")
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to nkbx_torch yet (ported: the Swin, ViT/DeiT, "
            f"ConvNeXt and ResNet families, {list_backbones()}); ROADMAP.md lists the order of the "
            "port")
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not ported to nkbx_torch yet; carry nkbx weights "
            "across with nkbx_torch.models.convert.from_jax_variables (ROADMAP.md)")
    return _REGISTRY[name](drop_rate=drop_rate, dtype=dtype, img_size=tuple(img_size), **opts)
