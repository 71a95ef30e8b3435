"""Plain float32 building blocks of the reference models.

Every matrix product and convolution goes through :func:`linear` or
:func:`conv2d` with a quantiser ``q`` applied to both operands:
:func:`exact` (the reference) or :func:`fp8` (the control: operands rounded
to float8 e4m3 with a per-tensor scale, products accumulated in float32).
The backward of :func:`fp8` passes the gradient straight through, so that
the control's gradients are those of its rounded operands.

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to 448), in float32; the gradient passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (r - x).detach()


QUANTISERS = {"f32": exact, "fp8": fp8}


def linear(x, w, b, q):
    """``x @ w.T + b`` (``w`` as ``nn.Linear`` holds it, (out, in))."""
    return F.linear(q(x), q(w), b)


def conv2d(x, w, b, q, stride=1, padding=0, groups=1):
    """NCHW convolution."""
    return F.conv2d(q(x), q(w), b, stride=stride, padding=padding, groups=groups)


def layer_norm(x, weight, bias, eps):
    return F.layer_norm(x, x.shape[-1:], weight, bias, eps)


def gelu(x):
    """The exact (erf) GELU of both papers' reference code."""
    return F.gelu(x)


def no_tf32():
    """Float32 products in float32, not TF32 (the card's default for cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
