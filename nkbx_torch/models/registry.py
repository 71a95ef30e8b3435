"""Backbone registry of the port (counterpart of ``nkbx/models/registry.py``).

The port holds the Swin family so far; every other nkbx name raises, and
ROADMAP.md says when it comes.
"""

from __future__ import annotations

import torch

from nkbx_torch.models import swin

_REGISTRY = {
    "swin_tiny_patch4_window7_224": swin.swin_tiny_patch4_window7_224,
    "swin_small_patch4_window7_224": swin.swin_small_patch4_window7_224,
    "swin_base_patch4_window7_224": swin.swin_base_patch4_window7_224,
    "swin_large_patch4_window7_224": swin.swin_large_patch4_window7_224,
    "swin_base_patch4_window12_384": swin.swin_base_patch4_window12_384,
    "swin_large_patch4_window12_384": swin.swin_large_patch4_window12_384,
}


def list_backbones():
    return sorted(_REGISTRY)


def create_backbone(name: str, pretrained: bool = False, drop_rate: float = 0.0,
                    dtype=torch.bfloat16, img_size=(224, 224), **opts):
    """Build a backbone module by its nkbx name; ``module.num_features`` is
    the embedding size. ``**opts`` are the family's fields (Swin:
    ``fused_attention``, ``fused_mlp``)."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to nkbx_torch yet (ported: "
            f"{list_backbones()}); ROADMAP.md lists the order of the port")
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not ported to nkbx_torch yet; carry nkbx weights "
            "across with nkbx_torch.models.convert.from_jax_variables (ROADMAP.md)")
    return _REGISTRY[name](drop_rate=drop_rate, dtype=dtype, img_size=tuple(img_size), **opts)
