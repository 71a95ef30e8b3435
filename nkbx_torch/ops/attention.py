"""Attention: the CUDA kernels and their plain PyTorch versions, forward and
backward, for both of nkbx's entries (``nkbx/ops/attention.py``).

- :func:`fused_attention_qkv`, Swin's window attention on the packed qkv
  Dense output: ``csrc/window_attention.cu`` replaces the Pallas
  ``_fwd_kernel_packed`` and ``csrc/window_attention_bwd.cu``
  ``_bwd_kernel_packed`` (each: bf16 with heads of width 32 and N up to 144
  on its tensor-core design, anything else on its first design).
- :func:`fused_attention`, the ViT family's full-sequence attention on
  separate q, k, v: ``csrc/attention.cu`` replaces ``_fwd_kernel_sep`` and
  ``csrc/attention_bwd.cu`` ``_bwd_kernel_sep``.

Each entry is differentiable through one ``torch.autograd.Function``: on
CUDA tensors both halves are the kernels, on CPU tensors both are the plain
versions.

Layout contract, the same as nkbx's:
  qkv     : (G, N, 3*H*D) the qkv Dense output, minor dim factored (3, H, D)
  q, k, v : (G, N, H*D)   heads packed head-major in the minor dim
  bias    : (H, N, N) f32 learned additive bias, or (1, N, N) broadcast;
                          for the separate-q/k/v entry also None, meaning zeros
  mask    : (M, N, N) f32 additive constant mask, G % M == 0; group g takes
                          mask[g % M]; zeros (1, N, N) when unused, or (separate
                          q/k/v) None
  out     : (G, N, H*D)

While a model is traced for export, the public entries call the forward as
the registered op ``nkbx_torch::window_attention`` or
``nkbx_torch::attention`` (see :func:`window_attention_op`), which a
``torch.export`` program keeps as a node of its own; :func:`disable_fused`
sends every gate to the plain versions instead.

Numerics: scores and softmax in f32, probabilities rounded to the compute
dtype before P*V, P*V accumulated in f32 (as the Pallas kernels do). The
backward recomputes P in f32 (nothing but the inputs, bias and mask is
saved) and rounds at the points of nkbx's ``_core_bwd`` (see
:func:`_reference_bwd`).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Optional

import torch

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_window_attention": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _P],
               "nkbx_window_attention_tc": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _P]}
_BWD_SIGNATURES = {"nkbx_window_attention_bwd": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I,
                                                                        _I, _P],
                   "nkbx_window_attention_bwd_tc": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I,
                                                                           _P]}
_SEP_SIGNATURES = {"nkbx_attention": [_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _P]}
_SEP_BWD_SIGNATURES = {"nkbx_attention_bwd": [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _I,
                                                                      _P]}
_MAX_SMEM = _build.MAX_SMEM
_BWD_BLOCKS = 1024  # the first backward groups windows per block down to about this many blocks
TC_HEAD_DIM, TC_MAX_N = 32, 144  # the bf16 tensor-core designs of K1 and K2 take these
HEAD_DIM = 64  # the only head width attention.cu and attention_bwd.cu take (every ViT's)


_AUTO_MIN_GROUPS = 1  # nkbx's default NKBX_FUSED_MIN_G: the gate stays open at every G
_FORCE_DISABLED = False


@contextlib.contextmanager
def disable_fused():
    """While active, every fused-kernel gate (:func:`resolve_fused` and
    ``nkbx_torch.ops.mlp.fused_mlp_mode``) chooses the plain version, even
    against a module flag of True or an ``NKBX_FUSED_*`` override (nkbx's
    ``disable_fused``). The export paths trace under it: a kernel is a ctypes
    call on a tensor's address, which neither ``torch.export`` nor
    ``torch.jit.trace`` can see."""
    global _FORCE_DISABLED
    prev = _FORCE_DISABLED
    _FORCE_DISABLED = True
    try:
        yield
    finally:
        _FORCE_DISABLED = prev


def fused_force_disabled() -> bool:
    """Whether :func:`disable_fused` is active."""
    return _FORCE_DISABLED


def resolve_fused(flag, x: torch.Tensor, auto: bool = True, groups=None) -> bool:
    """Resolve a model's fused-attention flag, with nkbx's precedence
    (``nkbx/ops/attention.py`` ``resolve_fused``): :func:`disable_fused`, then
    the ``NKBX_FUSED_ATTENTION=0|1`` env override, then the flag (True/False),
    then auto (None): the family's default, ``auto`` (Swin: True, ViT:
    False), where True means the kernel wherever the tensor is on a CUDA
    device. In auto mode ``groups`` (the call site's G = batch·windows)
    gates the kernel per call site: G below ``NKBX_FUSED_MIN_G`` (default
    1) takes the plain version."""
    if _FORCE_DISABLED:
        return False
    env = os.environ.get("NKBX_FUSED_ATTENTION", "")
    if env:
        return env not in ("0", "false", "False")
    if flag is not None:
        return bool(flag)
    if not (auto and x.is_cuda):
        return False
    min_g = int(os.environ.get("NKBX_FUSED_MIN_G", _AUTO_MIN_GROUPS))
    return groups is None or groups >= min_g


def smem_bytes(n: int, d: int) -> int:
    """Shared memory of one block of the forward's first design
    (window_attention.cu): q, k, v rows padded to D+1 and the (N, N) float
    scores."""
    return (3 * n * (d + 1) + n * n) * 4


def bwd_smem_bytes(n: int, d: int) -> int:
    """Shared memory of one block of the backward's first design
    (window_attention_bwd.cu): q, k, v and g rows padded to D+1, and one
    (N, N) buffer that holds P, then the scaled dS."""
    return (4 * n * (d + 1) + n * n) * 4


def _padded16(n: int) -> int:
    return -(-n // 16) * 16


def takes_tc(n: int, d: int, dtype) -> bool:
    """Whether the forward and the backward run their tensor-core designs
    (bf16, D = 32, N up to 144: every Swin window) rather than their first
    designs."""
    return dtype == torch.bfloat16 and d == TC_HEAD_DIM and 1 <= n <= TC_MAX_N


def _runs_of_windows(g: int, heads: int, blocks_per_sm: int, sms: int) -> int:
    """Windows per block of a tensor-core design: the (head, run of windows)
    blocks fill the card's resident slots about once."""
    per_head = max(1, sms * blocks_per_sm // heads)
    return max(1, -(-g // per_head))


def fwd_tc_smem_bytes(n: int, d: int = TC_HEAD_DIM) -> int:
    """Shared memory of one block of the forward's tensor-core design, the
    window padded to KP = N rounded up to 16: a 2-slot ring of the q, k and v
    tiles (KP, D+8) bf16, and nothing of size (N, N)."""
    return 2 * 3 * _padded16(n) * (d + 8) * 2


def fwd_tc_blocks_per_sm(n: int) -> int:
    """Blocks of the forward's tensor-core design one SM holds, as its launch
    bounds promise: four of up to 4 warps (N <= 64), else one (its scores
    and bias + mask in registers need the register file)."""
    return 4 if _padded16(n) <= 64 else 1


def fwd_tc_windows_per_block(g: int, heads: int, n: int, sms: int) -> int:
    """Windows per block of the forward's tensor-core design, whose blocks
    take their runs in the order of the windows' mask index (Swin-T stage 0
    on 132 SMs: 24 windows, 513 blocks)."""
    return _runs_of_windows(g, heads, fwd_tc_blocks_per_sm(n), sms)


def bwd_tc_smem_bytes(n: int, d: int = TC_HEAD_DIM) -> int:
    """Shared memory of one block of the backward's tensor-core design, the
    window padded to KP = N rounded up to 16: a 2-slot ring of the q, k, v
    and go tiles (KP, D+8) bf16, one (KP, KP+8) bf16 tile for P and then
    dS·scale, and the f32 dbias partial (KP, KP)."""
    kp = _padded16(n)
    return 2 * 4 * kp * (d + 8) * 2 + kp * (kp + 8) * 2 + 4 * kp * kp


def bwd_tc_blocks_per_sm(n: int) -> int:
    """Blocks of the tensor-core design one SM holds: three up to N = 64
    (its launch bounds), else as many as its shared memory allows (228 KB an
    SM, 1 KB reserved a block)."""
    if _padded16(n) <= 64:
        return 3
    return max(1, min(3, 233_472 // (bwd_tc_smem_bytes(n) + 1024)))


def bwd_tc_windows_per_block(g: int, heads: int, n: int, sms: int) -> int:
    """Windows per block of the tensor-core design: the (head, run of
    windows) blocks fill the card's resident slots once, so that each block
    writes its dbias partial once (Swin-T stage 0 on 132 SMs: 32 windows,
    384 blocks)."""
    return _runs_of_windows(g, heads, bwd_tc_blocks_per_sm(n), sms)


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
    """The forward half: on a CUDA tensor the kernel, its tensor-core design
    where :func:`takes_tc`, else its first design; on a CPU tensor the plain
    version."""
    if not qkv.is_cuda:
        hd = qkv.shape[-1] // 3
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        return reference_attention(q, k, v, bias, mask, scale, heads)
    dev, dt = qkv.device, qkv.dtype
    g, n, d, m = _check(qkv, bias, mask, heads, lambda n_, d_: (
        fwd_tc_smem_bytes(n_, d_) if takes_tc(n_, d_, dt) else smem_bytes(n_, d_)))
    tc = takes_tc(n, d, dt)
    qkv = _build.aligned(qkv)  # the tensor-core design copies 16 B
    bias, mask = bias.contiguous(), mask.contiguous()
    out = torch.empty((g, n, heads * d), dtype=dt, device=dev)
    if g == 0:
        return out
    lib = _build.load("window_attention", _SIGNATURES)
    args = (qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), g, n, heads, d,
            bias.shape[0], m, float(scale))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tc:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            err = lib.nkbx_window_attention_tc(*args, fwd_tc_windows_per_block(g, heads, n, sms),
                                               stream)
        else:
            err = lib.nkbx_window_attention(*args, int(dt == torch.bfloat16), stream)
    _build.check(err, "window_attention launch")
    fused_attention_qkv.launches += 1
    fused_attention_qkv.tc_launches += tc
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
    they compute the plain versions. Under ``torch.export`` the forward is
    the op ``nkbx_torch::window_attention``."""
    if torch.compiler.is_exporting():
        return window_attention_op(qkv, bias, mask, float(scale), int(heads))
    return _WindowAttention.apply(qkv, bias, mask, scale, heads)


@torch.library.custom_op("nkbx_torch::window_attention", mutates_args=())
def window_attention_op(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor, scale: float,
                        heads: int) -> torch.Tensor:
    """K1's forward as a registered op (forward only), the node an exported
    program keeps: on a CUDA tensor the kernel, counted as every launch is,
    on a CPU tensor the plain version."""
    return _forward(qkv, bias, mask, scale, heads)


@window_attention_op.register_fake
def _(qkv, bias, mask, scale, heads):
    g, n, hd3 = qkv.shape
    return qkv.new_empty((g, n, hd3 // 3))


fused_attention_qkv.launches = 0  # forward kernel launches (either design), counted by _forward
fused_attention_qkv.tc_launches = 0  # those of the tensor-core design


def fused_attention_qkv_bwd(qkv, bias, mask, go, scale: float, heads: int):
    """Backward of :func:`fused_attention_qkv`: ``(dqkv, dbias)``, dqkv
    (G, N, 3·H·D) in qkv's dtype and dbias (bias heads, N, N) in f32. On a
    CUDA tensor this launches the kernel (and its fixed-order dbias
    reduction): the tensor-core design where :func:`takes_tc`, else the
    first design; on a CPU tensor it computes :func:`reference_attention_bwd`."""
    if not qkv.is_cuda:
        return reference_attention_bwd(qkv, bias, mask, go, scale, heads)
    dev, dt = qkv.device, qkv.dtype
    g, n, d, m = _check(qkv, bias, mask, heads, lambda n_, d_: (
        bwd_tc_smem_bytes(n_, d_) if takes_tc(n_, d_, dt) else bwd_smem_bytes(n_, d_)))
    tc = takes_tc(n, d, dt)
    if tuple(go.shape) != (g, n, heads * d) or go.dtype != dt or go.device != dev:
        raise ValueError(f"cotangent {tuple(go.shape)} {go.dtype} is not ({g}, {n}, "
                         f"{heads * d}) {dt} on {dev}")
    qkv, go = _build.aligned(qkv), _build.aligned(go)  # the tensor-core design copies 16 B
    bias, mask = bias.contiguous(), mask.contiguous()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((bias.shape[0], n, n), dtype=torch.float32, device=dev)
    if g == 0:
        return dqkv, dbias.zero_()
    if tc:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        wpb = bwd_tc_windows_per_block(g, heads, n, sms)
    else:
        wpb = max(1, g * heads // _BWD_BLOCKS)
    chunks = -(-g // wpb)
    partial = torch.empty((heads, chunks, n, n), dtype=torch.float32, device=dev)
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    args = (qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), go.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), partial.data_ptr(), g, n, heads, d, bias.shape[0], m,
            float(scale), wpb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tc:
            err = lib.nkbx_window_attention_bwd_tc(*args, stream)
        else:
            err = lib.nkbx_window_attention_bwd(*args, int(dt == torch.bfloat16), stream)
    _build.check(err, "window_attention_bwd launch")
    fused_attention_qkv_bwd.launches += 1
    fused_attention_qkv_bwd.tc_launches += tc
    return dqkv, dbias


fused_attention_qkv_bwd.launches = 0  # kernel launches (either design), counted by the wrapper
fused_attention_qkv_bwd.tc_launches = 0  # those of the tensor-core design


# --- separate q/k/v (ViT) -----------------------------------------------------------


def _align128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _padded_keys(n: int) -> int:
    return -(-n // 64) * 64


def sep_smem_bytes(n: int, itemsize: int) -> int:
    """Shared memory of one block of the forward kernel (attention.cu). bf16
    (the streaming kernel), whatever N is: a ring of 4 key/value tiles (64,
    72) and the q tile (128, 72), or where a bias or mask is given the 8
    warps' f32 staging rows (16, 68) of both planes, which cover the q tile.
    float (the first design): the q tile (32, 72), one key or value tile (64,
    72), the f32 score rows (32, Np+4) and the P rows (32, Np+8), Np = N
    rounded up to 64."""
    ld = HEAD_DIM + 8
    if itemsize == 2:
        return 4 * 64 * ld * 2 + max(128 * ld * 2, 8 * 2 * 16 * 68 * 4)
    np_ = _padded_keys(n)
    return (_align128(32 * ld * itemsize) + _align128(64 * ld * itemsize)
            + _align128(32 * (np_ + 4) * 4) + _align128(32 * (np_ + 8) * itemsize))


def sep_bwd_smem_bytes(n: int, itemsize: int, streaming: bool = False) -> int:
    """Shared memory of a block of the larger of the backward's two kernels
    (attention_bwd.cu). ``streaming`` (bf16 with no bias and no mask, the
    tensor-core pair), whatever N is: the cols kernel's k and v tiles (64,
    72) and 3 ring slots of q and go tiles with 64 rows of three f32
    statistics, above the rows kernel's 8 tiles. Otherwise (the first
    design) the rows kernel holds 16 rows of f32 P and dP (Np+4) and of
    rounded dS·scale (Np+8) beside q, go (16, 72) and k, v (64, 72) tiles;
    the cols kernel holds fixed (64, 72) and (32, 72) tiles."""
    np_, ld = _padded_keys(n), HEAD_DIM + 8
    if streaming:
        tile = 64 * ld * 2
        return max(8 * tile, 2 * tile + 3 * (2 * tile + 3 * 64 * 4))
    rows = (2 * _align128(16 * ld * itemsize) + 2 * _align128(64 * ld * itemsize)
            + 2 * _align128(16 * (np_ + 4) * 4) + _align128(16 * (np_ + 8) * itemsize))
    cols = (2 * _align128(64 * ld * itemsize) + 4 * _align128(32 * ld * itemsize)
            + _align128(2 * 32 * 68 * 4) + _align128(3 * 32 * 4))
    return max(rows, cols)


def _check_sep(q, k, v, bias, mask, heads: int, smem) -> tuple:
    """Validate the separate-q/k/v kernels' inputs; returns (G, N, M)."""
    g, n, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} is not q's {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if hd != heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes heads of width {HEAD_DIM}; q's minor dim "
                         f"{hd} is not {heads} of them")
    m = 1 if mask is None else mask.shape[0]
    if bias is not None and (bias.shape[1:] != (n, n) or bias.shape[0] not in (1, heads)):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({heads}|1, {n}, {n})")
    if mask is not None and (mask.shape[1:] != (n, n) or g % m):
        raise ValueError(f"mask {tuple(mask.shape)} does not tile G={g} groups of N={n}")
    if smem(n, q.element_size()) > _MAX_SMEM:
        raise ValueError(f"sequence of N={n} needs {smem(n, q.element_size())} B of shared "
                         "memory")
    for name, t in (("bias", bias), ("mask", mask)):
        if t is not None and (t.device != q.device or t.dtype != torch.float32):
            raise TypeError(f"{name} must be float32 on {q.device}, got {t.dtype} on {t.device}")
    return g, n, m


def _ptr(t):
    """A tensor's address, or None (a null pointer) for an absent one."""
    return None if t is None else t.data_ptr()


def _sep_forward(q, k, v, bias, mask, scale: float, heads: int):
    """The forward half: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not q.is_cuda:
        return reference_attention(q, k, v, bias, mask, scale, heads)
    g, n, m = _check_sep(q, k, v, bias, mask, heads, sep_smem_bytes)
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    bias, mask = (None if t is None else _build.aligned(t) for t in (bias, mask))
    out = torch.empty_like(q)
    if g == 0 or n == 0:
        return out
    lib = _build.load("attention", _SEP_SIGNATURES)
    dev = q.device
    with torch.cuda.device(dev):
        err = lib.nkbx_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(mask), out.data_ptr(), g,
            n, heads, 1 if bias is None else bias.shape[0], m, float(scale),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "attention launch")
    fused_attention.launches += 1
    return out


class _Attention(torch.autograd.Function):
    """K3 forward, K4 backward. Saves q, k, v, bias and mask only, as nkbx's
    VJP does (attention.py:372-373): P is recomputed. The backward's two
    kernels pass three f32 statistics per (group, head, row) between them in
    scratch that lives for the backward alone; an absent bias or mask
    reaches them as None, which neither kernel reads."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, heads):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale, ctx.heads = scale, heads
        return _sep_forward(q, k, v, bias, mask, scale, heads)

    @staticmethod
    def backward(ctx, go):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_bwd(q, k, v, bias, mask, go, ctx.scale, ctx.heads,
                                                need_dbias=ctx.needs_input_grad[3])
        dbias = None if dbias is None else dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None


def fused_attention(q, k, v, bias, mask, scale: float, heads: int):
    """softmax(q kᵀ·scale + bias + mask) v on separate q, k, v; see the module
    docstring for the layout. ``bias`` or ``mask`` None means zeros, which
    neither kernel then reads. Differentiable in q, k, v and bias;
    the mask gets no gradient. On CUDA tensors the forward and the backward
    launch the kernels (heads of width 64 only; anything else raises); on CPU
    tensors they compute the plain versions. Under ``torch.export`` the
    forward is the op ``nkbx_torch::attention``."""
    if torch.compiler.is_exporting():
        return attention_op(q, k, v, bias, mask, float(scale), int(heads))
    return _Attention.apply(q, k, v, bias, mask, scale, heads)


@torch.library.custom_op("nkbx_torch::attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                 mask: Optional[torch.Tensor], scale: float, heads: int) -> torch.Tensor:
    """K3's forward as a registered op (forward only): on a CUDA tensor the
    kernel, counted, on a CPU tensor the plain version."""
    return _sep_forward(q, k, v, bias, mask, scale, heads)


@attention_op.register_fake
def _(q, k, v, bias, mask, scale, heads):
    return q.new_empty(q.shape)


fused_attention.launches = 0  # forward kernel launches, counted by _sep_forward


def fused_attention_bwd(q, k, v, bias, mask, go, scale: float, heads: int,
                        need_dbias: bool = True):
    """Backward of :func:`fused_attention`: ``(dq, dk, dv, dbias)``, dq, dk,
    dv in q's dtype and dbias (bias heads, N, N) in f32, or None when
    ``need_dbias`` is False (a constant bias: the kernel then skips the sum)
    or the bias is None. ``bias`` or ``mask`` None means zeros, which no
    kernel reads (the ViT's path). On a CUDA tensor this launches the
    kernels (and the fixed-order dbias reduction); on a CPU tensor it
    computes :func:`reference_attention_sep_bwd`."""
    need_dbias = need_dbias and bias is not None
    if not q.is_cuda:
        dq, dk, dv, dbias = reference_attention_sep_bwd(q, k, v, bias, mask, go, scale, heads)
        return dq, dk, dv, dbias if need_dbias else None
    streaming = q.dtype == torch.bfloat16 and bias is None and mask is None
    g, n, m = _check_sep(q, k, v, bias, mask, heads,
                         lambda n_, size: sep_bwd_smem_bytes(n_, size, streaming))
    dev, dt = q.device, q.dtype
    if go.shape != q.shape or go.dtype != dt or go.device != dev:
        raise ValueError(f"cotangent {tuple(go.shape)} {go.dtype} is not q's "
                         f"{tuple(q.shape)} {dt} on {dev}")
    q, k, v, go = (_build.aligned(t) for t in (q, k, v, go))
    bias, mask = (None if t is None else _build.aligned(t) for t in (bias, mask))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=dev)
    dbias = torch.zeros((bias.shape[0], n, n), **f32) if need_dbias else None
    if g == 0 or n == 0:
        return dq, dk, dv, dbias
    stats = torch.empty(3 * g * heads * _padded_keys(n), **f32)
    wpb, partial = 1, None
    if need_dbias:
        wpb = max(1, g * heads * -(-n // 16) // _BWD_BLOCKS)
        partial = torch.empty((heads, -(-g // wpb), n, n), **f32)
    lib = _build.load("attention_bwd", _SEP_BWD_SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(mask), go.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), _ptr(dbias),
            _ptr(partial), g, n, heads, 1 if bias is None else bias.shape[0], m, float(scale),
            wpb, int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "attention_bwd launch")
    fused_attention_bwd.launches += 1
    return dq, dk, dv, dbias


fused_attention_bwd.launches = 0  # kernel launches, counted by the wrapper


# --- plain versions -----------------------------------------------------------------


def _heads(t, heads: int):
    """(G, N, H*D) -> (G, H, N, D) in f32."""
    g, n, hd = t.shape
    return t.reshape(g, n, heads, hd // heads).transpose(1, 2).float()


def _merge(t):
    """(G, H, N, D) -> (G, N, H*D)."""
    g, h, n, d = t.shape
    return t.transpose(1, 2).reshape(g, n, h * d)


def _probabilities(q, k, bias, mask, scale: float):
    """f32 softmax(q kᵀ·scale + bias + mask) of (G, H, N, D) f32 q and k; a
    None bias or mask adds nothing."""
    g, heads, n, _ = q.shape
    s = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.expand(heads, n, n)[None].float()
    if mask is not None:
        m = mask.shape[0]
        s = (s.reshape(g // m, m, heads, n, n)
             + mask[None, :, None].float()).reshape(g, heads, n, n)
    return torch.softmax(s, dim=-1)


def reference_attention(q, k, v, bias, mask, scale: float, heads: int):
    """Plain PyTorch version (separate q/k/v of shape (G, N, H*D)), the twin
    of nkbx's ``reference_attention``; ``bias`` or ``mask`` None means
    zeros."""
    p = _probabilities(_heads(q, heads), _heads(k, heads), bias, mask, scale).to(q.dtype)
    o = p.float() @ _heads(v, heads)
    return _merge(o.to(q.dtype))


def _reference_bwd(q, k, v, bias, mask, go, scale: float, heads: int):
    """The plain backward of both entries, the twin of nkbx's ``_core_bwd``
    (attention.py:239-269) rounding point by rounding point: ``(dq, dk, dv,
    dbias)``, each (G, N, H*D) in f32 before the one rounding to the compute
    dtype, and dbias in f32. P is recomputed in f32; dV = (P in the compute
    dtype)ᵀ·g; dP = g·Vᵀ; dS = P∘(dP − rowsum(dP∘P)), whose sum over groups is
    dbias (also over heads when the bias is (1, N, N); None for a None bias);
    dQ and dK are products with (dS·scale) rounded to the compute dtype;
    every product accumulates in f32."""
    dt = q.dtype
    qh, kh, vh, g = (_heads(t, heads) for t in (q, k, v, go))
    p = _probabilities(qh, kh, bias, mask, scale)
    dv = p.to(dt).float().transpose(-1, -2) @ g
    dp = g @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if bias is None:
        dbias = None
    else:
        dbias = ds.sum(0) if bias.shape[0] != 1 else ds.sum((0, 1))[None]
    dsc = (ds * scale).to(dt).float()
    return _merge(dsc @ kh), _merge(dsc.transpose(-1, -2) @ qh), _merge(dv), dbias


def reference_attention_bwd(qkv, bias, mask, go, scale: float, heads: int):
    """Plain backward of the packed attention: ``(dqkv, dbias_f32)``, dqkv
    rounded once to the compute dtype (see :func:`_reference_bwd`)."""
    hd = qkv.shape[-1] // 3
    dq, dk, dv, dbias = _reference_bwd(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                                       bias, mask, go, scale, heads)
    return torch.cat([dq, dk, dv], dim=-1).to(qkv.dtype), dbias


def reference_attention_sep_bwd(q, k, v, bias, mask, go, scale: float, heads: int):
    """Plain backward of the separate-q/k/v attention: ``(dq, dk, dv,
    dbias_f32)``, dq/dk/dv rounded once to the compute dtype, dbias None for
    a None bias (see :func:`_reference_bwd`)."""
    dq, dk, dv, dbias = _reference_bwd(q, k, v, bias, mask, go, scale, heads)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias
