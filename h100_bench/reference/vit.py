"""Plain float32 ViT classifier (Dosovitskiy et al., "An Image is Worth
16x16 Words", ICLR 2021): patch embedding, a class token, learned position
embeddings, pre-norm blocks of multi-head self-attention and a GELU MLP, a
final LayerNorm, the class token's output into a linear head.

Parameter names follow the program's module tree (``backbone.
TransformerBlock_3.MultiHeadDotProductAttention_0.query.weight``), so
that the benchmark can hand both sides the same seeded tensors by name.
Departure from timm's ``vit_base_patch16_224``: separate query, key and
value projections (timm fuses them in one ``qkv``), the same arithmetic.

Also the family's work counts: multiply-adds an image, and the shapes of
the LN->MLP and attention calls that the roofline metrics count.
"""

from __future__ import annotations

import torch
from torch import nn

from h100_bench.reference.common import QUANTISERS, conv2d, gelu, layer_norm, linear


def _linear(n_in, n_out):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(n_out, n_in))
    m.bias = nn.Parameter(torch.empty(n_out))
    return m


def _norm(n):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(n))
    m.bias = nn.Parameter(torch.empty(n))
    return m


class _Block(nn.Module):
    def __init__(self, dim, heads, hidden):
        super().__init__()
        self.heads = heads
        self.LayerNorm_0 = _norm(dim)
        attn = nn.Module()
        for k in ("query", "key", "value", "out"):
            setattr(attn, k, _linear(dim, dim))
        self.MultiHeadDotProductAttention_0 = attn
        self.LayerNorm_1 = _norm(dim)
        self.Dense_0 = _linear(dim, hidden)
        self.Dense_1 = _linear(hidden, dim)

    def forward(self, x, q, eps):
        a = self.MultiHeadDotProductAttention_0
        h = layer_norm(x, self.LayerNorm_0.weight, self.LayerNorm_0.bias, eps)
        b, n, c = h.shape
        d = c // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, d).transpose(1, 2)

        qh, kh, vh = (split(linear(h, m.weight, m.bias, q)) for m in (a.query, a.key, a.value))
        s = torch.matmul(q(qh), q(kh).transpose(-1, -2)) * d ** -0.5
        o = torch.matmul(q(torch.softmax(s, dim=-1)), q(vh))
        x = x + linear(o.transpose(1, 2).reshape(b, n, c), a.out.weight, a.out.bias, q)
        h = layer_norm(x, self.LayerNorm_1.weight, self.LayerNorm_1.bias, eps)
        return x + linear(gelu(linear(h, self.Dense_0.weight, self.Dense_0.bias, q)),
                          self.Dense_1.weight, self.Dense_1.bias, q)


class _Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim, p = cfg["hidden_size"], cfg["patch_size"]
        tokens = (cfg["image_size"] // p) ** 2 + 1
        self.patch = p
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(torch.empty(dim, 3, p, p))
        self.patch_embed.bias = nn.Parameter(torch.empty(dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, dim))
        for i in range(cfg["num_layers"]):
            self.add_module(f"TransformerBlock_{i}",
                            _Block(dim, cfg["num_heads"], cfg["mlp_dim"]))
        self.LayerNorm_0 = _norm(dim)
        self.depth = cfg["num_layers"]


class ViTClassifier(nn.Module):
    """x: (B, H, W, 3) normalised float32 NHWC -> (B, classes) logits."""

    def __init__(self, cfg, precision: str = "f32"):
        super().__init__()
        self.eps = cfg["layer_norm_eps"]
        self.q = QUANTISERS[precision]
        self.backbone = _Backbone(cfg)
        self.head = _linear(cfg["hidden_size"], cfg["num_classes"])

    def forward(self, x):
        bb, q = self.backbone, self.q
        x = conv2d(x.permute(0, 3, 1, 2), bb.patch_embed.weight, bb.patch_embed.bias, q,
                   stride=bb.patch)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([bb.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + bb.pos_embed
        for i in range(bb.depth):
            x = getattr(bb, f"TransformerBlock_{i}")(x, q, self.eps)
        x = layer_norm(x, bb.LayerNorm_0.weight, bb.LayerNorm_0.bias, self.eps)[:, 0]
        return linear(x, self.head.weight, self.head.bias, q)


def build(cfg, precision: str = "f32") -> nn.Module:
    return ViTClassifier(cfg, precision)


def tokens(cfg) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def macs_per_image(cfg) -> int:
    """Multiply-adds of one image's forward, from the published
    architecture: per block N x (4 C^2 + 2 C F) for the projections and the
    MLP and 2 N^2 C for QK^T and PV; the patch embedding; the head."""
    c, f, n = cfg["hidden_size"], cfg["mlp_dim"], tokens(cfg)
    p = cfg["patch_size"]
    block = n * (4 * c * c + 2 * c * f) + 2 * n * n * c
    embed = (n - 1) * 3 * p * p * c
    return cfg["num_layers"] * block + embed + c * cfg["num_classes"]


def ln_mlp_calls(cfg, images: int) -> list:
    """One LN->MLP call a block over every token of ``images`` images; the
    shortcut is the call's own input."""
    rows = images * tokens(cfg)
    return [dict(rows=rows, c=cfg["hidden_size"], f=cfg["mlp_dim"], shortcut=False,
                 gamma=False)] * cfg["num_layers"]


def attention_calls(cfg, images: int) -> list:
    """One attention call a block: ``images`` sequences of N tokens."""
    heads = cfg["num_heads"]
    return [dict(b=images, h=heads, n=tokens(cfg), d=cfg["hidden_size"] // heads)] \
        * cfg["num_layers"]
