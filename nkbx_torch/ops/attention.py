"""Packed-qkv window attention: the CUDA kernel and its plain PyTorch version.

Counterpart of ``nkbx/ops/attention.py`` for the Swin forward (the Pallas
kernel ``_fwd_kernel_packed``); the kernel is ``csrc/window_attention.cu``.

Layout contract, the same as nkbx's:
  qkv  : (G, N, 3*H*D)  the qkv Dense output, minor dim factored (3, H, D)
  bias : (H, N, N) f32  learned relative-position bias, or (1, N, N) broadcast
  mask : (M, N, N) f32  additive shift mask, G % M == 0; window g takes
                        mask[g % M]; zeros (1, N, N) when unused
  out  : (G, N, H*D)    heads packed head-major in the minor dim

Numerics: scores and softmax in f32, probabilities rounded to the compute
dtype before P*V, P*V accumulated in f32 (as the Pallas kernel does).
"""

from __future__ import annotations

import ctypes
import os

import torch

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_window_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         ctypes.c_float, _I, _P]}
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may have


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
    """Shared memory of one block of the kernel (window_attention.cu)."""
    return (3 * n * (d + 1) + n * n) * 4


def fused_attention_qkv(qkv, bias, mask, scale: float, heads: int):
    """softmax(q kᵀ·scale + bias + mask) v from packed qkv; see the module
    docstring for the layout. On a CUDA tensor this launches the kernel; on a
    CPU tensor it computes the plain version."""
    g, n, hd3 = qkv.shape
    hd = hd3 // 3
    if not qkv.is_cuda:
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        return reference_attention(q, k, v, bias, mask, scale, heads)
    d = hd // heads
    m = mask.shape[0]
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if hd3 % 3 or hd % heads:
        raise ValueError(f"qkv minor dim {hd3} does not factor as (3, {heads}, D)")
    if bias.shape[1:] != (n, n) or bias.shape[0] not in (1, heads):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({heads}|1, {n}, {n})")
    if mask.shape[1:] != (n, n) or g % m:
        raise ValueError(f"mask {tuple(mask.shape)} does not tile G={g} windows of N={n}")
    if smem_bytes(n, d) > _MAX_SMEM:
        raise ValueError(f"window of N={n}, D={d} needs {smem_bytes(n, d)} B of shared memory")
    dev = qkv.device
    for name, t in (("bias", bias), ("mask", mask)):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {dev}, got {t.dtype} on {t.device}")
    qkv, bias, mask = qkv.contiguous(), bias.contiguous(), mask.contiguous()
    out = torch.empty((g, n, hd), dtype=qkv.dtype, device=dev)
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


fused_attention_qkv.launches = 0  # kernel launches, counted by the wrapper


def reference_attention(q, k, v, bias, mask, scale: float, heads: int):
    """Plain PyTorch version (separate q/k/v of shape (G, N, H*D)), the twin
    of nkbx's ``reference_attention``."""
    g, n, hd = q.shape
    m = mask.shape[0]
    d = hd // heads

    def split(t):
        return t.reshape(g, n, heads, d).transpose(1, 2).float()

    s = split(q) @ split(k).transpose(-1, -2) * scale
    s = s + bias.expand(heads, n, n)[None].float()
    s = (s.reshape(g // m, m, heads, n, n) + mask[None, :, None].float()).reshape(g, heads, n, n)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = p.float() @ split(v)
    return o.to(q.dtype).transpose(1, 2).reshape(g, n, hd)
