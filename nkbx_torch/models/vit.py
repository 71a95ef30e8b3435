"""Vision Transformer (ViT and DeiT; patch 16 and 32; 224 and 384 px) and
the unicom metric-learning ViTs (B/32, B/16, L/14). Counterpart of
``nkbx/models/vit.py``, with the submodule names of its flax tree
(``TransformerBlock_3.MultiHeadDotProductAttention_0.query``,
``LayerNorm_1``, ``Dense_0``, ``patch_embed``, ``cls_token``, ``pos_embed``,
the final ``LayerNorm_0``; unicom's ``norm``, ``feature_fc1``,
``feature_bn1``, ``feature_fc2``, ``feature_bn2``), so that weights carry
across by a tree walk (:mod:`nkbx_torch.models.convert`).

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
init; a forward at another size raises. A checkpoint saved at another grid
has its ``pos_embed`` resampled on load
(:func:`nkbx_torch.models.convert.resample_pos_embed`).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import (Dense, Dropout, LayerNorm, TorchBatchNorm, init_dense_,
                                      keep_mask, lecun_normal_, mlp_tail)
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
            keep = keep_mask((1, 1, n, n), keep_prob, q.device, batched=False)
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


def _reset_transformer(module: nn.Module, patch_embed: nn.Conv2d, generator: torch.Generator):
    """flax's initialisers, drawn from ``generator``: lecun-normal Dense and
    Conv kernels, zero biases, LayerNorm ones/zeros, ``pos_embed``
    normal(0.02), BatchNorm ones/zeros and running statistics 0/1."""
    for mod in module.modules():
        if isinstance(mod, Dense):
            init_dense_(mod, generator)
        elif isinstance(mod, LayerNorm):
            mod.weight.data.fill_(1.0)
            mod.bias.data.zero_()
        elif isinstance(mod, TorchBatchNorm):
            mod.reset_parameters()
    w = patch_embed.weight
    lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
    patch_embed.bias.data.zero_()
    module.pos_embed.data.normal_(0.0, 0.02, generator=generator)


def _embed_patches(x, conv: nn.Conv2d, dt):
    """NHWC images -> (B, gh*gw, C) patch tokens, row-major over the grid."""
    x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                 stride=conv.stride)
    return x.flatten(2).transpose(1, 2)


def _check_tokens(n: int, pos_embed):
    if n != pos_embed.shape[1]:
        raise ValueError(f"{n} tokens; this model was built for {pos_embed.shape[1]} (img_size)")


class ViT(nn.Module):
    """nkbx's ViT: ``pool="cls"`` (a class token, its output the embedding)
    or ``"mean"`` (no class token, the mean of the final tokens), and with
    ``projection_dim`` a ``feature_proj`` Dense to that width after the
    pooling (nkbx vit.py:100-141)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12, n_heads: int = 12,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, pool: str = "cls",
                 projection_dim=None, dtype=torch.float32, fused_attention=None, fused_mlp=None,
                 img_size=(224, 224)):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.dtype, self.pool = dtype, pool
        self.num_features = projection_dim or dim
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        tokens = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
            tokens += 1
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        # as in nkbx, the embedding dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()
        for i in range(depth):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                dim, n_heads, mlp_ratio, drop_rate, dtype, fused=fused_attention,
                fused_mlp=fused_mlp))
        self.LayerNorm_0 = LayerNorm(dim, 1e-6, dtype)
        if projection_dim:
            self.feature_proj = Dense(dim, projection_dim, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers (a zero class token)."""
        _reset_transformer(self, self.patch_embed, generator)
        if self.pool == "cls":
            self.cls_token.data.zero_()

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC, any dtype -> (B, num_features) float32.
        ``mask`` is accepted and ignored: the family has no batch statistics."""
        dt = self.dtype
        x = _embed_patches(x, self.patch_embed, dt)
        b, _, c = x.shape
        if self.pool == "cls":
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, c), x], dim=1)
        _check_tokens(x.shape[1], self.pos_embed)
        x = self.dropout(x + self.pos_embed.to(dt))
        for name, mod in self.named_children():
            if name.startswith("TransformerBlock_"):
                x = mod(x)
        x = self.LayerNorm_0(x)
        x = x[:, 0] if self.pool == "cls" else x.float().mean(1).to(x.dtype)
        if hasattr(self, "feature_proj"):
            x = self.feature_proj(x)
        return x.float()


class UnicomViT(nn.Module):
    """nkbx's ``UnicomViT`` (vit.py:144-243), deepglint/unicom's
    VisionTransformer: the patch conv, ``pos_embed`` with no class token,
    blocks and a final ``norm`` with LayerNorm eps 1e-5, every token's
    output flattened token-major to (B, N·dim), then the feature head
    ``feature_fc1`` (no bias) -> ``feature_bn1`` -> ``feature_fc2`` (no
    bias) -> ``feature_bn2``, both BatchNorms
    :class:`~nkbx_torch.models.common.TorchBatchNorm` with eps 2e-5 and
    momentum 0.9, in f32, taking the row mask (B, 1) in training.
    ``feature_fc1``'s width follows the token grid at ``img_size``."""

    def __init__(self, patch_size: int = 32, dim: int = 768, depth: int = 12, n_heads: int = 12,
                 embedding_size: int = 512, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 dtype=torch.float32, fused_attention=None, fused_mlp=None, img_size=(224, 224)):
        super().__init__()
        self.dtype = dtype
        self.num_features = embedding_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        tokens = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()
        for i in range(depth):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                dim, n_heads, mlp_ratio, drop_rate, dtype, ln_eps=1e-5, fused=fused_attention,
                fused_mlp=fused_mlp))
        self.norm = LayerNorm(dim, 1e-5, dtype)
        self.feature_fc1 = Dense(tokens * dim, dim, bias=False, dtype=dtype)
        self.feature_bn1 = TorchBatchNorm(dim, eps=2e-5, dtype=torch.float32)
        self.feature_fc2 = Dense(dim, embedding_size, bias=False, dtype=dtype)
        self.feature_bn2 = TorchBatchNorm(embedding_size, eps=2e-5, dtype=torch.float32)

    def reset_parameters(self, generator: torch.Generator):
        _reset_transformer(self, self.patch_embed, generator)

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC -> (B, embedding_size) float32. ``mask``
        (B, 1, 1, 1) weights padded rows out of the head's BatchNorm
        statistics in training."""
        x = _embed_patches(x, self.patch_embed, self.dtype)
        b, n, _ = x.shape
        _check_tokens(n, self.pos_embed)
        x = self.dropout(x + self.pos_embed.to(x.dtype))
        for name, mod in self.named_children():
            if name.startswith("TransformerBlock_"):
                x = mod(x)
        x = self.norm(x).reshape(b, -1)
        bn_mask = mask.reshape(b, 1) if (mask is not None and self.training) else None
        x = self.feature_bn1(self.feature_fc1(x), mask=bn_mask)
        return self.feature_bn2(self.feature_fc2(x), mask=bn_mask)


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

# unicom.load names: "unicom ViT-B/32" etc.
unicom_vit_b32 = partial(UnicomViT, patch_size=32, dim=768, depth=12, n_heads=12,
                         embedding_size=512)
unicom_vit_b16 = partial(UnicomViT, patch_size=16, dim=768, depth=12, n_heads=12,
                         embedding_size=768)
unicom_vit_l14 = partial(UnicomViT, patch_size=14, dim=1024, depth=24, n_heads=16,
                         embedding_size=768)
