"""Vision Transformer (ViT and DeiT; patch 16 and 32; 224 and 384 px).
Counterpart of ``nkbx/models/vit.py``, with the submodule names of its flax
tree (``TransformerBlock_3.MultiHeadDotProductAttention_0.query``,
``LayerNorm_1``, ``Dense_0``, ``patch_embed``, ``cls_token``, ``pos_embed``,
the final ``LayerNorm_0``), so that weights carry across by a tree walk
(:mod:`nkbx_torch.models.convert`).

Attention has nkbx's two lowerings:

- the fused one (``fused_attention=True`` or ``NKBX_FUSED_ATTENTION=1``):
  nkbx's ``_fused_attention_fn`` hook, the separate-q/k/v kernel with a zero
  (1, N, N) bias and mask and ``scale = D**-0.5`` on the unscaled query;
- the plain one (the default, as in nkbx): flax 0.12's
  ``dot_product_attention`` in the compute dtype, the query divided by
  sqrt(D) first, then the score product, the softmax and the value product,
  each in the compute dtype.

The MLP half goes through :func:`nkbx_torch.models.common.mlp_tail` with
nkbx's ViT default: the plain version unless ``fused_mlp=True``. With a
dropout rate above 0 in training both fused paths are off, as in nkbx
(vit.py:64, common.py:277). ``pos_embed`` is sized from the token grid at
the input size the model is built for (``img_size``), as flax sizes it at
init; a forward at another size raises.

The unicom ViTs wait for the ``UnicomViT`` module (ROADMAP.md A7): their names raise.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import Dense, LayerNorm, init_dense_, lecun_normal_, mlp_tail
from nkbx_torch.ops.attention import fused_attention, resolve_fused


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as nkbx's ViT uses it
    (self-attention, biases, head width D = dim / heads): the ``query``,
    ``key`` and ``value`` Denses (dim -> H*D), attention, and ``out`` (H*D
    -> dim), all in the compute dtype."""

    def __init__(self, dim: int, n_heads: int, drop_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.drop_rate = drop_rate
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(dim, dim, dtype=dtype)
        self.value = Dense(dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, x, fused: bool):
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, N, H*D)
        d = q.shape[-1] // self.n_heads
        if fused:
            # nkbx's hook adds a constant zero (1, N, N) bias and mask; None adds
            # the same nothing, and the kernel skips reading them
            y = fused_attention(q, k, v, None, None, d ** -0.5, self.n_heads)
        else:
            y = self._plain(q, k, v, d)
        return self.out(y)

    def _plain(self, q, k, v, d: int):
        """flax ``dot_product_attention`` in the compute dtype, with its
        attention dropout (one keep mask broadcast across batch and heads)
        in training."""
        b, n, hd = q.shape
        dt = q.dtype
        qh, kh, vh = (t.reshape(b, n, self.n_heads, d).transpose(1, 2) for t in (q, k, v))
        qh = qh / torch.tensor(math.sqrt(d), dtype=torch.float32).to(dt)
        w = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
        if self.training and self.drop_rate > 0:
            keep_prob = 1.0 - self.drop_rate
            keep = torch.rand((1, 1, n, n), device=q.device) < keep_prob
            w = w * (keep.to(dt) / torch.tensor(keep_prob, dtype=dt))
        return (w @ vh).transpose(1, 2).reshape(b, n, hd)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 dtype=torch.float32, ln_eps: float = 1e-6, fused=None, fused_mlp=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.fused, self.fused_mlp = fused, fused_mlp  # None = nkbx's ViT default: plain
        hidden = int(dim * mlp_ratio)
        self.LayerNorm_0 = LayerNorm(dim, ln_eps, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, n_heads,
                                                                           drop_rate, dtype)
        self.LayerNorm_1 = LayerNorm(dim, ln_eps, dtype)
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        drop = self.drop_rate > 0 and self.training
        fused = resolve_fused(self.fused, x, auto=False) and not drop
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), fused)
        return mlp_tail(x, x, self.LayerNorm_1, self.Dense_0, self.Dense_1, flag=self.fused_mlp,
                        auto=False, drop_rate=self.drop_rate, train=self.training)


class ViT(nn.Module):
    """nkbx's ViT with its class-token pooling (nkbx's ``pool="mean"`` and
    ``projection_dim`` are set by no registry name or config and are not
    ported)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12, n_heads: int = 12,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, dtype=torch.float32,
                 fused_attention=None, fused_mlp=None, img_size=(224, 224)):
        super().__init__()
        self.dtype = dtype
        self.num_features = dim
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        tokens = (img_size[0] // patch_size) * (img_size[1] // patch_size) + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        # as in nkbx, the embedding dropout exists only with a rate above 0
        self.dropout = nn.Dropout(drop_rate) if drop_rate > 0 else nn.Identity()
        for i in range(depth):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                dim, n_heads, mlp_ratio, drop_rate, dtype, fused=fused_attention,
                fused_mlp=fused_mlp))
        self.LayerNorm_0 = LayerNorm(dim, 1e-6, dtype)

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal Dense
        and Conv kernels, zero biases and class token, LayerNorm ones/zeros,
        ``pos_embed`` normal(0.02)."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                init_dense_(mod, generator)
            elif isinstance(mod, LayerNorm):
                mod.weight.data.fill_(1.0)
                mod.bias.data.zero_()
        w = self.patch_embed.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
        self.patch_embed.bias.data.zero_()
        self.cls_token.data.zero_()
        self.pos_embed.data.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC, any dtype -> (B, num_features) float32.
        ``mask`` is accepted and ignored: the family has no batch statistics."""
        dt = self.dtype
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_embed.stride)
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C), row-major over the grid
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, c), x], dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens; this model was built for "
                             f"{self.pos_embed.shape[1]} (img_size)")
        x = self.dropout(x + self.pos_embed.to(dt))
        for name, mod in self.named_children():
            if name.startswith("TransformerBlock_"):
                x = mod(x)
        return self.LayerNorm_0(x)[:, 0].float()


vit_tiny_patch16_224 = partial(ViT, patch_size=16, dim=192, depth=12, n_heads=3)
vit_small_patch16_224 = partial(ViT, patch_size=16, dim=384, depth=12, n_heads=6)
vit_small_patch32_224 = partial(ViT, patch_size=32, dim=384, depth=12, n_heads=6)
vit_base_patch16_224 = partial(ViT, patch_size=16, dim=768, depth=12, n_heads=12)
vit_base_patch32_224 = partial(ViT, patch_size=32, dim=768, depth=12, n_heads=12)
vit_large_patch16_224 = partial(ViT, patch_size=16, dim=1024, depth=24, n_heads=16)

# timm's deit_*_patch16_224 (non-distilled) share the vit_* architecture
deit_tiny_patch16_224 = vit_tiny_patch16_224
deit_small_patch16_224 = vit_small_patch16_224
deit_base_patch16_224 = vit_base_patch16_224

# the fixed-384 fine-tune names alias the same geometries; pos_embed follows
# the token grid at the input size the model is built for
vit_tiny_patch16_384 = vit_tiny_patch16_224
vit_small_patch16_384 = vit_small_patch16_224
vit_small_patch32_384 = vit_small_patch32_224
vit_base_patch16_384 = vit_base_patch16_224
vit_base_patch32_384 = vit_base_patch32_224
vit_large_patch16_384 = vit_large_patch16_224
vit_large_patch32_384 = partial(ViT, patch_size=32, dim=1024, depth=24, n_heads=16)
