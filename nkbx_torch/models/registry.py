"""Backbone registry of the port (counterpart of ``nkbx/models/registry.py``):
every name of nkbx's, the unicom ViTs by their ``unicom.load`` names
("unicom ViT-B/32"). ``pretrained=True`` is nkbx's rule
(:mod:`nkbx_torch.models.pretrained`).
"""

from __future__ import annotations

import difflib

import torch

from nkbx_torch.models import convnext, densenet, efficientnet, mobilenetv3, resnet, swin, vit
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
    **{name: getattr(densenet, name) for name in densenet.NAMES},
}

_UNICOM = {
    "ViT-B/32": vit.unicom_vit_b32,
    "ViT-B/16": vit.unicom_vit_b16,
    "ViT-L/14": vit.unicom_vit_l14,
}


def list_backbones():
    return sorted(_REGISTRY) + [f"unicom {k}" for k in sorted(_UNICOM)]


def create_backbone(name: str, pretrained: bool = False, drop_rate: float = 0.0,
                    dtype=torch.bfloat16, img_size=(224, 224), generator=None, **opts):
    """Build a backbone module by its nkbx name; ``module.num_features`` is
    the embedding size. ``**opts`` are the family's fields (Swin and ViT:
    ``fused_attention``, ``fused_mlp``; ConvNeXt: ``fused_mlp``; ResNet:
    ``ghost_bn``, ``fused_bottleneck``, ``s2d_stem``; MobileNetV3 and
    EfficientNet: ``ghost_bn``; ViT: ``pool``, ``projection_dim``; DenseNet:
    ``buffer_concat``). With a ``generator`` the weights are drawn
    from it by flax's initialisers. With ``pretrained``, nkbx's rule: the
    converted file under ``$NKBX_PRETRAINED_DIR`` fills the backbone, or,
    without one, a warning with nkbx's message and the weights stay random;
    nothing is downloaded."""
    if name.lower().startswith("unicom"):
        parts = name.split(maxsplit=1)
        variant = parts[1] if len(parts) > 1 else ""
        if variant not in _UNICOM:
            raise NotImplementedError(f"Unknown unicom variant {variant!r}; have {sorted(_UNICOM)}")
        ctor = _UNICOM[variant]
    elif name in _REGISTRY:
        ctor = _REGISTRY[name]
    else:
        names = list_backbones()
        close = difflib.get_close_matches(name, names, n=3, cutoff=0.4)
        hint = f" Did you mean {' / '.join(repr(c) for c in close)}?" if close else ""
        raise NotImplementedError(
            f"Unknown backbone {name!r}.{hint} nkbx_torch supports nkbx's explicit "
            f"{len(names)}-name set (the reference accepts any timm name); see MIGRATING.md "
            f"'Supported backbones' or nkbx_torch.models.list_backbones(). Full list: {names}")
    module = ctor(drop_rate=drop_rate, dtype=dtype, img_size=tuple(img_size), **opts)
    if generator is not None:
        module.reset_parameters(generator)
    if pretrained:
        path = pretrained_params_path(name)
        if path is None:
            warn_no_pretrained(name)
        else:
            load_pretrained_into(module, path)
    return module
