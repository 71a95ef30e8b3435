"""Swin Transformer V1 (tiny/small/base/large): shifted-window attention,
NHWC. Counterpart of ``nkbx/models/swin.py``, with the same submodule names
as its flax tree (``stage0_block1.attn.qkv``, ``norm2``, ``fc1``,
``downsample0.reduction``, ...), so that weights carry across by a tree walk
(:mod:`nkbx_torch.models.convert`).

Semantics kept from nkbx (microsoft Swin): a window that does not fit the
token grid collapses to the grid, and then the block does not shift; the
block rolls by −shift, partitions, attends, reverses and rolls back;
PatchMerging concatenates (even/even, odd/even, even/odd, odd/odd); the
backbone ends with LayerNorm, the token mean, and an f32 embedding.

The relative-position-bias table is sized by the window each block uses at
the input size the model is built for (``img_size``), as flax sizes it at
init; a forward at another size whose window differs raises.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.models.common import (Dense, Dropout, LayerNorm, init_dense_, lecun_normal_,
                                      mlp_tail)
from nkbx_torch.ops.attention import (fused_attention_qkv, reference_attention,
                                      resolve_fused)


def _relative_position_index(w: int) -> np.ndarray:
    """(N, N) lookup into the (2w-1)^2 relative-position-bias table
    (microsoft Swin WindowAttention.__init__ math)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (-100 across region boundaries) for shifted
    windows (microsoft Swin SwinTransformerBlock.__init__ img_mask math)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // window, window, w // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] != wins[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _window_partition(x, window: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(windows, window: int, b: int, h: int, w: int):
    c = windows.shape[-1]
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _block_geometry(window: int, shift: int, h: int, w: int):
    """The window and shift a block uses on an h×w grid (swin.py:147-148)."""
    win = min(window, h, w)
    return win, (shift if win < min(h, w) else 0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, window: int, dtype=torch.float32,
                 fused=None):
        super().__init__()
        self.n_heads = n_heads
        self.window = window
        self.fused = fused  # None = auto (the kernel on CUDA) | True | False
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, n_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_relative_position_index(window).reshape(-1)), persistent=False)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, attn_mask):
        # x: (B*nW, N, C); attn_mask: (M, N, N) f32 on x's device
        bn, n, c = x.shape
        qkv = self.qkv(x)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, self.n_heads).permute(2, 0, 1).float().contiguous()
        scale = (c // self.n_heads) ** -0.5
        if resolve_fused(self.fused, qkv, groups=bn):  # nkbx's per-call-site gate
            y = fused_attention_qkv(qkv, bias, attn_mask, scale, self.n_heads)
        else:
            y = reference_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                    bias, attn_mask, scale, self.n_heads)
        return self.proj(y)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, window: int, shift: int, grid,
                 mlp_ratio: int = 4, dtype=torch.float32, fused=None, fused_mlp=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.fused_mlp = fused_mlp
        win, _ = _block_geometry(window, shift, *grid)
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn = WindowAttention(dim, n_heads, win, dtype, fused)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.fc1 = Dense(dim, dim * mlp_ratio, dtype=dtype)
        self.fc2 = Dense(dim * mlp_ratio, dim, dtype=dtype)
        self._masks = {}

    def _mask(self, h, w, window, shift, device):
        key = (h, w, window, shift, device)
        if key not in self._masks:
            n = window * window
            m = (_shift_attn_mask(h, w, window, shift) if shift
                 else np.zeros((1, n, n), np.float32))
            if torch.compiler.is_exporting():  # a constant of the program, not cached
                return torch.as_tensor(m, device=device)
            self._masks[key] = torch.as_tensor(m, device=device)
        return self._masks[key]

    def forward(self, x):
        b, h, w, c = x.shape
        window, shift = _block_geometry(self.window, self.shift, h, w)
        if window != self.attn.window:
            raise ValueError(f"token grid {h}x{w} needs window {window}; this block was "
                             f"built for window {self.attn.window}")
        if h % window or w % window:
            raise ValueError(f"token grid {h}x{w} not divisible by window {window}")
        shortcut = x
        x = self.norm1(x)
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        wins = self.attn(_window_partition(x, window),
                         self._mask(h, w, window, shift, x.device))
        x = _window_reverse(wins, window, b, h, w)
        if shift:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = shortcut + x
        return mlp_tail(x, x, self.norm2, self.fc1, self.fc2, flag=self.fused_mlp)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, 1e-5, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x):
        # concat order matches microsoft Swin PatchMerging.forward
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths=(2, 2, 6, 2), n_heads=(3, 6, 12, 24),
                 patch_size: int = 4, window: int = 7, mlp_ratio: int = 4,
                 drop_rate: float = 0.0, dtype=torch.float32, fused_attention=None,
                 fused_mlp=None, img_size=(224, 224)):
        super().__init__()
        self.dtype = dtype
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(embed_dim, 1e-5, dtype)
        grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, n_heads)):
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, heads, window, (window // 2) if j % 2 else 0, grid,
                    mlp_ratio, dtype, fused_attention, fused_mlp))
            if i != len(depths) - 1:
                self.add_module(f"downsample{i}", PatchMerging(dim, dtype))
                dim *= 2
                grid = (grid[0] // 2, grid[1] // 2)
        self.norm = LayerNorm(dim, 1e-5, dtype)
        # as in nkbx, the embedding dropout exists only with a rate above 0
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def reset_parameters(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal Dense
        and Conv kernels, zero biases, LayerNorm ones/zeros, and the bias
        table truncated-normal(0.02)."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                init_dense_(mod, generator)
            elif isinstance(mod, WindowAttention):
                std = 0.02 / 0.87962566103423978
                nn.init.trunc_normal_(mod.relative_position_bias_table.data, 0.0, std,
                                      -2 * std, 2 * std, generator=generator)
            elif isinstance(mod, LayerNorm):
                mod.weight.data.fill_(1.0)
                mod.bias.data.zero_()
        w = self.patch_embed.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
        self.patch_embed.bias.data.zero_()

    def forward(self, x, mask=None):
        """x: (B, H, W, 3) NHWC, any dtype -> (B, num_features) float32.
        ``mask`` is accepted and ignored: the family has no batch statistics."""
        dt = self.dtype
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_embed.stride)
        x = self.patch_norm(x.permute(0, 2, 3, 1))
        for name, mod in self.named_children():
            if name.startswith(("stage", "downsample")):
                x = mod(x)
        x = self.norm(x)
        x = x.float().mean(dim=(1, 2)).to(dt)
        return self.dropout(x).float()


swin_tiny_patch4_window7_224 = partial(
    SwinTransformer, embed_dim=96, depths=(2, 2, 6, 2), n_heads=(3, 6, 12, 24))
swin_small_patch4_window7_224 = partial(
    SwinTransformer, embed_dim=96, depths=(2, 2, 18, 2), n_heads=(3, 6, 12, 24))
swin_base_patch4_window7_224 = partial(
    SwinTransformer, embed_dim=128, depths=(2, 2, 18, 2), n_heads=(4, 8, 16, 32))
swin_large_patch4_window7_224 = partial(
    SwinTransformer, embed_dim=192, depths=(2, 2, 18, 2), n_heads=(6, 12, 24, 48))
# the 384 fine-tune variants: window 12, so the token grid must divide by 12
swin_base_patch4_window12_384 = partial(
    SwinTransformer, embed_dim=128, depths=(2, 2, 18, 2), n_heads=(4, 8, 16, 32),
    window=12, img_size=(384, 384))
swin_large_patch4_window12_384 = partial(
    SwinTransformer, embed_dim=192, depths=(2, 2, 18, 2), n_heads=(6, 12, 24, 48),
    window=12, img_size=(384, 384))
