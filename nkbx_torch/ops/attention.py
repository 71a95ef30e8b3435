"""Packed-qkv window attention: the CUDA kernels and their plain PyTorch
versions, forward and backward.

Counterpart of ``nkbx/ops/attention.py`` for Swin: the forward kernel
``csrc/window_attention.cu`` replaces the Pallas ``_fwd_kernel_packed`` and
the backward kernel ``csrc/window_attention_bwd.cu`` replaces
``_bwd_kernel_packed``. :func:`fused_attention_qkv` is differentiable through
one ``torch.autograd.Function``: on CUDA tensors both halves are the kernels,
on CPU tensors both are the plain versions.

Layout contract, the same as nkbx's:
  qkv  : (G, N, 3*H*D)  the qkv Dense output, minor dim factored (3, H, D)
  bias : (H, N, N) f32  learned relative-position bias, or (1, N, N) broadcast
  mask : (M, N, N) f32  additive shift mask, G % M == 0; window g takes
                        mask[g % M]; zeros (1, N, N) when unused
  out  : (G, N, H*D)    heads packed head-major in the minor dim

Numerics: scores and softmax in f32, probabilities rounded to the compute
dtype before P*V, P*V accumulated in f32 (as the Pallas kernel does). The
backward recomputes P in f32 (nothing but qkv, bias and mask is saved) and
rounds at the points of nkbx's ``_core_bwd`` (see
:func:`reference_attention_bwd`).
"""

from __future__ import annotations

import ctypes
import os

import torch

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_window_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         ctypes.c_float, _I, _P]}
_BWD_SIGNATURES = {"nkbx_window_attention_bwd": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I,
                                                                        _I, _P]}
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may have
_BWD_BLOCKS = 1024  # the backward groups windows per block down to about this many blocks


def resolve_fused(flag, x: torch.Tensor) -> bool:
    """Resolve a model's fused-attention flag, with nkbx's precedence: the
    ``NKBX_FUSED_ATTENTION=0|1`` env override, then the flag (True/False),
    then auto (None), which means the kernel wherever the tensor is on a
    CUDA device."""
    env = os.environ.get("NKBX_FUSED_ATTENTION", "")
    if env:
        return env not in ("0", "false", "False")
    if flag is not None:
        return bool(flag)
    return x.is_cuda


def smem_bytes(n: int, d: int) -> int:
    """Shared memory of one block of the forward kernel (window_attention.cu)."""
    return (3 * n * (d + 1) + n * n) * 4


def bwd_smem_bytes(n: int, d: int) -> int:
    """Shared memory of one block of the backward kernel
    (window_attention_bwd.cu): q, k, v and g rows padded to D+1, and one
    (N, N) buffer that holds P, then the scaled dS."""
    return (4 * n * (d + 1) + n * n) * 4


def _check(qkv, bias, mask, heads: int, smem) -> tuple:
    """Validate the kernels' inputs; returns (G, N, D, M)."""
    g, n, hd3 = qkv.shape
    hd = hd3 // 3
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if hd3 % 3 or hd % heads:
        raise ValueError(f"qkv minor dim {hd3} does not factor as (3, {heads}, D)")
    d, m = hd // heads, mask.shape[0]
    if bias.shape[1:] != (n, n) or bias.shape[0] not in (1, heads):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({heads}|1, {n}, {n})")
    if mask.shape[1:] != (n, n) or g % m:
        raise ValueError(f"mask {tuple(mask.shape)} does not tile G={g} windows of N={n}")
    if smem(n, d) > _MAX_SMEM:
        raise ValueError(f"window of N={n}, D={d} needs {smem(n, d)} B of shared memory")
    for name, t in (("bias", bias), ("mask", mask)):
        if t.device != qkv.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {qkv.device}, got {t.dtype} on {t.device}")
    return g, n, d, m


def _forward(qkv, bias, mask, scale: float, heads: int):
    """The forward half: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not qkv.is_cuda:
        hd = qkv.shape[-1] // 3
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        return reference_attention(q, k, v, bias, mask, scale, heads)
    g, n, d, m = _check(qkv, bias, mask, heads, smem_bytes)
    dev = qkv.device
    qkv, bias, mask = qkv.contiguous(), bias.contiguous(), mask.contiguous()
    out = torch.empty((g, n, heads * d), dtype=qkv.dtype, device=dev)
    if g == 0:
        return out
    lib = _build.load("window_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_window_attention(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), g, n, heads,
            d, bias.shape[0], m, float(scale), int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention launch")
    fused_attention_qkv.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """K1 forward, K2 backward. Saves qkv, bias and mask only, as nkbx's
    VJP does (attention.py:430-458): P is recomputed."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.scale, ctx.heads = scale, heads
        return _forward(qkv, bias, mask, scale, heads)

    @staticmethod
    def backward(ctx, go):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = fused_attention_qkv_bwd(qkv, bias, mask, go, ctx.scale, ctx.heads)
        return dqkv.to(qkv.dtype), dbias.to(bias.dtype), None, None, None


def fused_attention_qkv(qkv, bias, mask, scale: float, heads: int):
    """softmax(q kᵀ·scale + bias + mask) v from packed qkv; see the module
    docstring for the layout. Differentiable in qkv and bias. On CUDA
    tensors the forward and the backward launch the kernels; on CPU tensors
    they compute the plain versions."""
    return _WindowAttention.apply(qkv, bias, mask, scale, heads)


fused_attention_qkv.launches = 0  # forward kernel launches, counted by _forward


def fused_attention_qkv_bwd(qkv, bias, mask, go, scale: float, heads: int):
    """Backward of :func:`fused_attention_qkv`: ``(dqkv, dbias)``, dqkv
    (G, N, 3·H·D) in qkv's dtype and dbias (bias heads, N, N) in f32. On a
    CUDA tensor this launches the kernel (and its fixed-order dbias
    reduction); on a CPU tensor it computes :func:`reference_attention_bwd`."""
    if not qkv.is_cuda:
        return reference_attention_bwd(qkv, bias, mask, go, scale, heads)
    g, n, d, m = _check(qkv, bias, mask, heads, bwd_smem_bytes)
    dev, dt = qkv.device, qkv.dtype
    if tuple(go.shape) != (g, n, heads * d) or go.dtype != dt or go.device != dev:
        raise ValueError(f"cotangent {tuple(go.shape)} {go.dtype} is not ({g}, {n}, "
                         f"{heads * d}) {dt} on {dev}")
    qkv, bias, mask, go = qkv.contiguous(), bias.contiguous(), mask.contiguous(), go.contiguous()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((bias.shape[0], n, n), dtype=torch.float32, device=dev)
    if g == 0:
        return dqkv, dbias.zero_()
    wpb = max(1, g * heads // _BWD_BLOCKS)
    chunks = -(-g // wpb)
    partial = torch.empty((heads, chunks, n, n), dtype=torch.float32, device=dev)
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_window_attention_bwd(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), go.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), partial.data_ptr(), g, n, heads, d, bias.shape[0], m,
            float(scale), wpb, int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention_bwd launch")
    fused_attention_qkv_bwd.launches += 1
    return dqkv, dbias


fused_attention_qkv_bwd.launches = 0  # kernel launches, counted by the wrapper


def _heads(t, heads: int):
    """(G, N, H*D) -> (G, H, N, D) in f32."""
    g, n, hd = t.shape
    return t.reshape(g, n, heads, hd // heads).transpose(1, 2).float()


def _merge(t):
    """(G, H, N, D) -> (G, N, H*D)."""
    g, h, n, d = t.shape
    return t.transpose(1, 2).reshape(g, n, h * d)


def _probabilities(q, k, bias, mask, scale: float):
    """f32 softmax(q kᵀ·scale + bias + mask) of (G, H, N, D) f32 q and k."""
    g, heads, n, _ = q.shape
    m = mask.shape[0]
    s = q @ k.transpose(-1, -2) * scale
    s = s + bias.expand(heads, n, n)[None].float()
    s = (s.reshape(g // m, m, heads, n, n) + mask[None, :, None].float()).reshape(g, heads, n, n)
    return torch.softmax(s, dim=-1)


def reference_attention(q, k, v, bias, mask, scale: float, heads: int):
    """Plain PyTorch version (separate q/k/v of shape (G, N, H*D)), the twin
    of nkbx's ``reference_attention``."""
    p = _probabilities(_heads(q, heads), _heads(k, heads), bias, mask, scale).to(q.dtype)
    o = p.float() @ _heads(v, heads)
    return _merge(o.to(q.dtype))


def reference_attention_bwd(qkv, bias, mask, go, scale: float, heads: int):
    """Plain backward of the packed attention: ``(dqkv, dbias_f32)``, the
    twin of nkbx's ``_core_bwd`` (attention.py:239-269) rounding point by
    rounding point. P is recomputed in f32; dV = (P in the compute dtype)ᵀ·g;
    dP = g·Vᵀ; dS = P∘(dP − rowsum(dP∘P)), whose sum over windows is dbias
    (f32; also over heads when the bias is (1, N, N)); dQ and dK are products
    with (dS·scale) rounded to the compute dtype; every product accumulates
    in f32, and dqkv is rounded once, to the compute dtype."""
    dt = qkv.dtype
    hd = qkv.shape[-1] // 3
    q, k, v = (_heads(qkv[..., i * hd:(i + 1) * hd], heads) for i in range(3))
    g = _heads(go, heads)
    p = _probabilities(q, k, bias, mask, scale)
    dv = p.to(dt).float().transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0) if bias.shape[0] != 1 else ds.sum((0, 1))[None]
    dsc = (ds * scale).to(dt).float()
    dq = dsc @ k
    dk = dsc.transpose(-1, -2) @ q
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(dt)
    return dqkv, dbias
