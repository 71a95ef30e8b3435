"""Shared building blocks of the port's backbones (counterpart of
``nkbx/models/common.py``).

Parameters are float32; each module computes in its ``dtype`` (bf16 on the
card), casting weights at use, as flax's ``param_dtype=float32,
dtype=bfloat16`` does. Initialisers take an explicit ``torch.Generator`` and
follow flax's defaults (lecun-normal Dense/Conv kernels, zero biases).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.ops.mlp import fused_ln_mlp, fused_mlp, fused_mlp_mode, reference_ln_mlp


class LayerNorm(nn.Module):
    """LayerNorm with flax semantics (flax 0.12 ``use_fast_variance=True``):
    f32 statistics, variance E[x²]−μ² clamped at 0, ``(x−μ)·(rsqrt(var+ε)·
    scale) + bias`` in f32, cast to ``dtype``. ``torch.nn.LayerNorm`` uses the
    two-pass variance and is not this."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax ``lecun_normal``: a normal truncated at ±2σ, scaled so that the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``nn.Dense`` with f32
    params): weight (out, in), the transpose of flax's kernel (in, out)."""

    def __init__(self, features_in: int, features_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(features_in, features_out, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def mlp_tail(x, shortcut, norm: LayerNorm, fc1: Dense, fc2: Dense, *, flag, auto: bool = True,
             gamma=None, drop_rate: float = 0.0, train: bool = False):
    """Transformer-block MLP half, ``shortcut + [gamma *] MLP(norm(x))``,
    with one dispatch point (:func:`nkbx_torch.ops.mlp.fused_mlp_mode`), as
    nkbx's ``mlp_tail`` (common.py:249-298): the fused LN-MLP kernels
    (``"ln"``), the MLP-only kernels after the plain LayerNorm (``"mlp"``),
    or the plain version (None). ``auto`` is the family's default for
    ``flag=None``. With ``drop_rate`` above 0 in training, the torch-parity
    Dropout between the two Denses is active and the plain version runs
    (the kernels draw no random numbers), as in nkbx."""
    dt = fc1.dtype
    if drop_rate > 0 and train:
        y = fc2(F.dropout(F.gelu(fc1(norm(x))), drop_rate, training=True))
        return shortcut + (y if gamma is None else y * gamma.to(y.dtype))
    w0 = fc1.weight.t().to(dt).contiguous()
    w1 = fc2.weight.t().to(dt).contiguous()
    mode = fused_mlp_mode(flag, x, w0.shape[1], auto)
    if mode == "mlp":
        y = fused_mlp(norm(x), w0, fc1.bias, w1, fc2.bias)
        return shortcut + (y if gamma is None else y * gamma.to(y.dtype))
    args = (x, norm.weight, norm.bias, w0, fc1.bias, w1, fc2.bias, shortcut)
    if mode == "ln":
        return fused_ln_mlp(*args, gamma=gamma, eps=norm.eps)
    return reference_ln_mlp(*args, gamma=gamma, eps=norm.eps)


def init_dense_(module: nn.Linear, generator: torch.Generator):
    lecun_normal_(module.weight.data, module.weight.shape[1], generator)
    if module.bias is not None:
        module.bias.data.zero_()
