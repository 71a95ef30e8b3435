"""Fused LayerNorm -> MLP -> layer-scale -> residual: the CUDA kernel and its
plain PyTorch version.

Counterpart of the LN-fused half of ``nkbx/ops/mlp.py`` (the Pallas kernel
``_lnmlp_fwd_kernel``); the kernel is ``csrc/ln_mlp.cu``, forward only.
``shortcut + gamma * (gelu(LN(x) @ w0 + b0) @ w1 + b1)`` with flax LayerNorm
semantics (f32 statistics, fast variance), f32 accumulation, the exact GELU
in f32, and the compute-dtype rounding points of nkbx's kernel.

nkbx's MLP-only kernel (``fused_mlp``, taken there under
``NKBX_FUSED_LN_MLP=0``) is not ported yet: here that setting selects the
plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_ln_mlp": [_P] * 10 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P]}
_CHUNK = 64  # kChunk of ln_mlp.cu
_TILE_ROWS = (64, 32, 16)  # row tiles the kernels are instantiated for
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may have
_TWO_BLOCKS_SMEM = 113_000  # at most this per block keeps two blocks on an SM


def tensor_cores(dtype, c: int, f: int) -> bool:
    """Whether the bf16 tensor-core kernel takes this geometry (C a multiple
    of 32, F of 64: every Swin width); else the float-FMA kernel runs."""
    return dtype == torch.bfloat16 and c % 32 == 0 and f % _CHUNK == 0


def smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one block (mirrors ``tc_smem_bytes`` and
    ``fma_smem_bytes`` in ln_mlp.cu). Tensor cores: bf16 LN output (C+8),
    f32 accumulators (C+4), one f32 and one bf16 chunk (68, 72) per row,
    and two staged (32, 136) bf16 weight slabs. FMA: f32 LN output and
    accumulators (C+1 each) and one f32 chunk (65) per row."""
    if tc:
        return (tile_rows * (2 * (c + 8) + 4 * (c + 4) + 4 * (_CHUNK + 4) + 2 * (_CHUNK + 8))
                + 2 * 32 * 136 * 2)
    return tile_rows * (2 * (c + 1) + _CHUNK + 1) * 4


def pick_tile_rows(c: int, tc: bool):
    """The largest row tile that keeps two blocks on an SM, else the largest
    that fits one block; None when even 16 rows do not fit. The hidden width
    F does not enter: the kernels walk it in chunks."""
    for budget in (_TWO_BLOCKS_SMEM, _MAX_SMEM):
        for tr in _TILE_ROWS:
            if smem_bytes(tr, c, tc) <= budget:
                return tr
    return None


def fused_mlp_mode(flag, x: torch.Tensor, f: int):
    """Resolve a block's MLP lowering for x (..., C) and hidden width F:
    ``"ln"`` (the fused kernel) or None (the plain version). Precedence as in
    nkbx: the ``NKBX_FUSED_MLP=0|1`` env override, then the flag, then auto
    (the tensor is on a CUDA device); ``NKBX_FUSED_LN_MLP=0`` and a width
    whose tile does not fit shared memory select the plain version."""
    env = os.environ.get("NKBX_FUSED_MLP", "")
    if env:
        on = env not in ("0", "false", "False")
    else:
        on = x.is_cuda if flag is None else bool(flag)
    if not on or os.environ.get("NKBX_FUSED_LN_MLP", "") in ("0", "false", "False"):
        return None
    c = x.shape[-1]
    return "ln" if pick_tile_rows(c, tensor_cores(x.dtype, c, f)) is not None else None


def fused_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma=None,
                 eps: float = 1e-6):
    """``shortcut + gamma * MLP(LayerNorm(x))``; x, shortcut (..., C); w0
    (C, F) and w1 (F, C) in the compute dtype; ln_scale, ln_bias, b0, b1 and
    gamma f32 (gamma None means ones). On a CUDA tensor this launches the
    kernel; on a CPU tensor it computes the plain version."""
    if not x.is_cuda:
        return reference_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps)
    c = x.shape[-1]
    f = w0.shape[1]
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"LN-MLP kernel takes float32 or bfloat16, got {dt}")
    if tuple(w0.shape) != (c, f) or tuple(w1.shape) != (f, c):
        raise ValueError(f"w0 {tuple(w0.shape)} / w1 {tuple(w1.shape)} are not (C, F) / (F, C)")
    if shortcut.shape != x.shape:
        raise ValueError(f"shortcut {tuple(shortcut.shape)} is not x's {tuple(x.shape)}")
    for name, t in (("w0", w0), ("w1", w1), ("shortcut", shortcut)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}, got {t.dtype} on {t.device}")
    tc = tensor_cores(dt, c, f)
    tr = pick_tile_rows(c, tc)
    if tr is None:
        raise ValueError(f"LN-MLP kernel: no row tile fits shared memory at C={c}")
    if gamma is None:
        gamma = torch.ones(c, dtype=torch.float32, device=dev)

    def vec(t, size, name):
        if t.device != dev or t.numel() != size:
            raise ValueError(f"{name} must hold {size} values on {dev}")
        return t.to(torch.float32).contiguous()

    vecs = [vec(ln_scale, c, "ln_scale"), vec(ln_bias, c, "ln_bias"), vec(b0, f, "b0"),
            vec(b1, c, "b1"), vec(gamma, c, "gamma")]
    x2 = x.reshape(-1, c).contiguous()
    sc2 = shortcut.reshape(-1, c).contiguous()
    w0, w1 = w0.contiguous(), w1.contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    lib = _build.load("ln_mlp", _SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), sc2.data_ptr(), out.data_ptr(),
            rows, c, f, tr, float(eps), int(dt == torch.bfloat16), int(tc),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp launch")
    fused_ln_mlp.launches += 1
    return out.reshape(x.shape)


fused_ln_mlp.launches = 0  # kernel launches, counted by the wrapper


def reference_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma=None,
                     eps: float = 1e-6):
    """Plain PyTorch version with flax LayerNorm/Dense dtype staging, the
    twin of nkbx's ``reference_ln_mlp``: LN in f32, then the Denses, GELU and
    layer-scale in the compute dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
    h = (xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    u = h.to(dt) @ w0 + b0.to(dt)
    y = F.gelu(u) @ w1 + b1.to(dt)
    if gamma is not None:
        y = y * gamma.to(dt)
    return shortcut + y
