"""ConvNeXt (tiny/small/base/large/xlarge), NHWC, layer-scale, exact GELU.
Counterpart of ``nkbx/models/convnext.py``, with the submodule names of its
flax tree (the stem's ``Conv_0`` and ``LayerNorm_0``; ``LayerNorm_s`` and
``Conv_s`` before stage s > 0; ``ConvNeXtBlock_i.{Conv_0, LayerNorm_0,
Dense_0, Dense_1, layer_scale}``; ``head_norm``), so that weights carry across
by a tree walk (:mod:`nkbx_torch.models.convert`).

A block is a depthwise 7x7 "SAME" convolution, then the MLP half through
:func:`nkbx_torch.models.common.mlp_tail` with the layer-scale: on the card
the LN-fused kernels (K5/K6), or under ``NKBX_FUSED_LN_MLP=0`` the MLP-only
kernels (K7/K8) after the plain LayerNorm; the family's ``auto`` is True, as
nkbx's is on its accelerator. Every LayerNorm has flax's ε = 1e-6. Tensors
stay NHWC; a convolution sees ``x.permute(0, 3, 1, 2)``, a channels-last
NCHW view. The backbone ends with the spatial mean (reduced in f32, as
``jnp.mean`` does for bf16), ``head_norm`` and an f32 embedding.

``remat_stages`` runs the blocks of those stages under
:func:`~nkbx_torch.models.common.remat`: their activations are recomputed
in the backward (K5 runs again there); the names and the numbers stay those
of the run without it.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import (Dense, Dropout, LayerNorm, init_dense_, lecun_normal_,
                                      mlp_tail, remat)

_EPS = 1e-6  # flax nn.LayerNorm's default, nkbx's everywhere in ConvNeXt


def _conv_same(x, conv: nn.Conv2d, dt):
    """flax ``nn.Conv(padding="SAME")`` on NHWC x: for each spatial dim,
    total = max((ceil(n / s) - 1) * s + k - n, 0), low total // 2 and high
    the rest."""
    pads = []
    for n, k, s in zip(reversed(x.shape[1:3]), reversed(conv.kernel_size),
                       reversed(conv.stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    y = x.to(dt).permute(0, 3, 1, 2)
    if any(pads):
        y = F.pad(y, pads)
    y = F.conv2d(y, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                 groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6, dtype=torch.float32,
                 fused_mlp=None):
        super().__init__()
        self.dtype = dtype
        self.fused_mlp = fused_mlp  # None = auto (the kernels on CUDA) | True | False
        self.Conv_0 = nn.Conv2d(dim, dim, 7, groups=dim)
        self.layer_scale = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.LayerNorm_0 = LayerNorm(dim, _EPS, dtype)
        self.Dense_0 = Dense(dim, 4 * dim, dtype=dtype)
        self.Dense_1 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        y = _conv_same(x, self.Conv_0, self.dtype)
        return mlp_tail(y, x, self.LayerNorm_0, self.Dense_0, self.Dense_1, flag=self.fused_mlp,
                        gamma=self.layer_scale)


class ConvNeXt(nn.Module):
    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), drop_rate: float = 0.0,
                 dtype=torch.float32, remat_stages=(), fused_mlp=None, img_size=(224, 224)):
        super().__init__()
        self.dtype = dtype
        self.num_features = dims[-1]  # no parameter depends on img_size, the registry's argument
        self.Conv_0 = nn.Conv2d(3, dims[0], 4, stride=4)
        self.LayerNorm_0 = LayerNorm(dims[0], _EPS, dtype)
        self._order = []  # the modules after the stem, in the order they run
        self._remat = set()  # the blocks of remat_stages
        block = 0
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                self.add_module(f"LayerNorm_{stage}", LayerNorm(dims[stage - 1], _EPS, dtype))
                self.add_module(f"Conv_{stage}", nn.Conv2d(dims[stage - 1], dim, 2, stride=2))
                self._order += [f"LayerNorm_{stage}", f"Conv_{stage}"]
            for _ in range(depth):
                self.add_module(f"ConvNeXtBlock_{block}",
                                ConvNeXtBlock(dim, dtype=dtype, fused_mlp=fused_mlp))
                self._order.append(f"ConvNeXtBlock_{block}")
                if stage in remat_stages:
                    self._remat.add(f"ConvNeXtBlock_{block}")
                block += 1
        self.head_norm = LayerNorm(dims[-1], _EPS, dtype)
        # as in nkbx, the embedding dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal Dense
        and Conv kernels (a convolution's fan-in is kh·kw·in/groups: 49 for
        the depthwise 7x7), zero biases, LayerNorm ones/zeros, and every
        ``layer_scale`` 1e-6."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                init_dense_(mod, generator)
            elif isinstance(mod, nn.Conv2d):
                w = mod.weight
                lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
                mod.bias.data.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.data.fill_(1.0)
                mod.bias.data.zero_()
            elif isinstance(mod, ConvNeXtBlock):
                mod.layer_scale.data.fill_(1e-6)

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC, any dtype -> (B, num_features) float32.
        ``mask`` is accepted and ignored: the family has no batch statistics."""
        dt = self.dtype
        x = self.LayerNorm_0(_conv_same(x, self.Conv_0, dt))
        for name in self._order:
            mod = getattr(self, name)
            if isinstance(mod, nn.Conv2d):
                x = _conv_same(x, mod, dt)
            else:
                x = remat(mod, x) if name in self._remat else mod(x)
        x = x.float().mean(dim=(1, 2)).to(dt)
        return self.dropout(self.head_norm(x)).float()


convnext_tiny = partial(ConvNeXt, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
convnext_small = partial(ConvNeXt, depths=(3, 3, 27, 3), dims=(96, 192, 384, 768))
convnext_base = partial(ConvNeXt, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024))
convnext_large = partial(ConvNeXt, depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536))
convnext_xlarge = partial(ConvNeXt, depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048))
