"""Fused LayerNorm -> MLP -> layer-scale -> residual: the CUDA kernels and
their plain PyTorch versions, forward and backward.

Counterpart of the LN-fused half of ``nkbx/ops/mlp.py``: the forward kernel
``csrc/ln_mlp.cu`` replaces the Pallas ``_lnmlp_fwd_kernel`` and the
backward kernels ``csrc/ln_mlp_bwd.cu`` replace ``_lnmlp_bwd_kernel``.
``shortcut + gamma * (gelu(LN(x) @ w0 + b0) @ w1 + b1)`` with flax LayerNorm
semantics (f32 statistics, fast variance), f32 accumulation, the exact GELU
in f32, and the compute-dtype rounding points of nkbx's kernels.
:func:`fused_ln_mlp` is differentiable through one ``torch.autograd.Function``:
on CUDA tensors both halves are the kernels, on CPU tensors both are the
plain versions.

nkbx's MLP-only kernel (``fused_mlp``, taken there under
``NKBX_FUSED_LN_MLP=0``) is not ported yet: here that setting selects the
plain version.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_ln_mlp": [_P] * 10 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P]}
_BWD_SIGNATURES = {"nkbx_ln_mlp_bwd": [_P] * 21 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P]}
_CHUNK = 64  # kChunk of ln_mlp.cu and ln_mlp_bwd.cu
_TILE_ROWS = (64, 32, 16)  # row tiles the kernels are instantiated for
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may have
_TWO_BLOCKS_SMEM = 113_000  # at most this per block keeps two blocks on an SM
_WGRAD_TILE = 64  # output tile of the weight-gradient kernel (ln_mlp_bwd.cu)
_WGRAD_BLOCKS = 528  # the weight-gradient kernel splits rows until about this many blocks


def tensor_cores(dtype, c: int, f: int) -> bool:
    """Whether the bf16 tensor-core kernels take this geometry (C a multiple
    of 32, F of 64: every Swin width); else the float-FMA kernels run."""
    return dtype == torch.bfloat16 and c % 32 == 0 and f % _CHUNK == 0


def smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one forward block (mirrors ``tc_smem_bytes`` and
    ``fma_smem_bytes`` in ln_mlp.cu). Tensor cores: bf16 LN output (C+8),
    f32 accumulators (C+4), one f32 and one bf16 chunk (68, 72) per row,
    and two staged (32, 136) bf16 weight slabs. FMA: f32 LN output and
    accumulators (C+1 each) and one f32 chunk (65) per row."""
    if tc:
        return (tile_rows * (2 * (c + 8) + 4 * (c + 4) + 4 * (_CHUNK + 4) + 2 * (_CHUNK + 8))
                + 2 * 32 * 136 * 2)
    return tile_rows * (2 * (c + 1) + _CHUNK + 1) * 4


def _align(n: int) -> int:
    return -(-n // 256) * 256


def bwd_smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one block of the backward row-tile kernel (mirrors
    ``RowLayout`` in ln_mlp_bwd.cu). Tensor cores: bf16 h and dy2 rows
    (C+8 each), f32 y-then-dh accumulators (C+4), two f32 chunk pairs (68)
    for the split-k partial sums of u and dgl, one bf16 chunk (72), two
    staged weight slabs of 128x40 bf16; FMA: f32 h, dy2 and accumulators
    (C+1 each), three f32 chunks (65); then the per-row statistics and a
    256-float scratch. Each part starts 256-byte aligned."""
    tr = tile_rows
    if tc:
        parts = [tr * (c + 8) * 2, tr * (c + 8) * 2, tr * (c + 4) * 4,
                 4 * tr * (_CHUNK + 4) * 4, tr * (_CHUNK + 8) * 2, 2 * 128 * 40 * 2]
    else:
        parts = [tr * (c + 1) * 4] * 3 + [2 * tr * (_CHUNK + 1) * 4, tr * (_CHUNK + 1) * 4]
    return sum(_align(p) for p in parts) + _align(2 * tr * 4) + _align(256 * 4)


def pick_tile_rows(c: int, tc: bool, smem=smem_bytes):
    """The largest row tile that keeps two blocks on an SM, else the largest
    that fits one block; None when even 16 rows do not fit. The hidden width
    F does not enter: the kernels walk it in chunks. ``smem`` is the
    kernel's shared-memory rule (the forward's by default)."""
    for budget in (_TWO_BLOCKS_SMEM, _MAX_SMEM):
        for tr in _TILE_ROWS:
            if smem(tr, c, tc) <= budget:
                return tr
    return None


def fused_mlp_mode(flag, x: torch.Tensor, f: int, auto: bool = True):
    """Resolve a block's MLP lowering for x (..., C) and hidden width F:
    ``"ln"`` (the fused kernels) or None (the plain version). Precedence as
    in nkbx: the ``NKBX_FUSED_MLP=0|1`` env override, then the flag, then
    auto (None): the family's default, ``auto`` (Swin: True, ViT: False),
    where True means the kernels wherever the tensor is on a CUDA device;
    ``NKBX_FUSED_LN_MLP=0`` and a width whose forward or backward tile does
    not fit shared memory select the plain version (nkbx's
    ``fused_mlp_viable`` also sizes both)."""
    env = os.environ.get("NKBX_FUSED_MLP", "")
    if env:
        on = env not in ("0", "false", "False")
    else:
        on = (auto and x.is_cuda) if flag is None else bool(flag)
    if not on or os.environ.get("NKBX_FUSED_LN_MLP", "") in ("0", "false", "False"):
        return None
    c = x.shape[-1]
    tc = tensor_cores(x.dtype, c, f)
    fits = (pick_tile_rows(c, tc) is not None
            and pick_tile_rows(c, tc, bwd_smem_bytes) is not None)
    return "ln" if fits else None


def _check(x, w0, w1, dev_tensors, vecs):
    """Validate the kernels' inputs; returns (C, F, tensor cores, f32
    contiguous vectors)."""
    c, f = x.shape[-1], w0.shape[1]
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"LN-MLP kernel takes float32 or bfloat16, got {dt}")
    if tuple(w0.shape) != (c, f) or tuple(w1.shape) != (f, c):
        raise ValueError(f"w0 {tuple(w0.shape)} / w1 {tuple(w1.shape)} are not (C, F) / (F, C)")
    for name, t in dev_tensors:
        if t.shape[-1] != c or t.numel() != x.numel():
            raise ValueError(f"{name} {tuple(t.shape)} is not x's {tuple(x.shape)}")
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}, got {t.dtype} on {t.device}")
    for name, t in (("w0", w0), ("w1", w1)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}, got {t.dtype} on {t.device}")
    out = []
    for name, t, size in vecs:
        if t.device != dev or t.numel() != size:
            raise ValueError(f"{name} must hold {size} values on {dev}")
        out.append(t.to(torch.float32).contiguous())
    return c, f, tensor_cores(dt, c, f), out


def _forward(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps: float):
    """The forward half on (R, C) rows: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not x.is_cuda:
        return reference_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps)
    dev = x.device
    c, f = x.shape[-1], w0.shape[1]
    g = torch.ones(c, dtype=torch.float32, device=dev) if gamma is None else gamma
    c, f, tc, vecs = _check(x, w0, w1, [("shortcut", shortcut)],
                            [("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c), ("b0", b0, f),
                             ("b1", b1, c), ("gamma", g, c)])
    tr = pick_tile_rows(c, tc)
    if tr is None:
        raise ValueError(f"LN-MLP kernel: no row tile fits shared memory at C={c}")
    x2, sc2 = x.contiguous(), shortcut.contiguous()
    w0, w1 = w0.contiguous(), w1.contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out
    lib = _build.load("ln_mlp", _SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), sc2.data_ptr(), out.data_ptr(),
            rows, c, f, tr, float(eps), int(x.dtype == torch.bfloat16), int(tc),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp launch")
    fused_ln_mlp.launches += 1
    return out


class _LnMlp(torch.autograd.Function):
    """K5 forward, K6 backward, on (R, C) rows. Saves the inputs and
    recomputes the rest; ``d(shortcut)`` is the cotangent itself."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w0, b0, w1, b1, gamma)
        ctx.eps = eps
        return _forward(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, s, b, w0, b0, w1, b1, gamma = ctx.saved_tensors
        dx, ds, db, dw0, db0, dw1, db1, dgamma = fused_ln_mlp_bwd(
            x, s, b, w0, b0, w1, b1, gamma, dy, ctx.eps)
        dgamma = None if gamma is None else dgamma.to(gamma.dtype)
        return (dx, ds.to(s.dtype), db.to(b.dtype), dw0, db0.to(b0.dtype), dw1,
                db1.to(b1.dtype), dy, dgamma, None)


def fused_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma=None,
                 eps: float = 1e-6):
    """``shortcut + gamma * MLP(LayerNorm(x))``; x, shortcut (..., C); w0
    (C, F) and w1 (F, C) in the compute dtype; ln_scale, ln_bias, b0, b1 and
    gamma f32 (gamma None means ones). Differentiable in every tensor
    argument. On CUDA tensors the forward and the backward launch the
    kernels; on CPU tensors they compute the plain versions. For a
    self-residual block pass the same tensor as x and shortcut: autograd
    sums the two cotangents, as JAX does."""
    c = x.shape[-1]
    y = _LnMlp.apply(x.reshape(-1, c), ln_scale, ln_bias, w0, b0, w1, b1,
                     shortcut.reshape(-1, c), gamma, eps)
    return y.reshape(x.shape)


fused_ln_mlp.launches = 0  # forward kernel launches, counted by _forward


def _wgrad_split(rows: int, m: int, n: int) -> int:
    """Rows of each slab of the weight-gradient kernel (a multiple of 32):
    enough slabs to give about ``_WGRAD_BLOCKS`` blocks."""
    tiles = -(-m // _WGRAD_TILE) * -(-n // _WGRAD_TILE)
    slabs = max(1, min(-(-_WGRAD_BLOCKS // tiles), -(-rows // 256)))
    return -(-(-(-rows // slabs)) // 32) * 32


def fused_ln_mlp_bwd(x, ln_scale, ln_bias, w0, b0, w1, b1, gamma, dy, eps: float = 1e-6):
    """Backward of :func:`fused_ln_mlp` on (R, C) rows: ``(dx, ds, db, dw0,
    db0, dw1, db1, dgamma)``, dx in x's dtype, dw0/dw1 in the weights' dtype,
    the vectors in f32 (nkbx casts them so, mlp.py:642-647). On a CUDA tensor
    this launches the kernels (a row-tile kernel, then fixed-order
    reductions of the weight and vector gradients); on a CPU tensor it
    computes :func:`reference_ln_mlp_bwd`."""
    if not x.is_cuda:
        return reference_ln_mlp_bwd(x, ln_scale, ln_bias, w0, b0, w1, b1, gamma, dy, eps)
    dev = x.device
    c, f = x.shape[-1], w0.shape[1]
    has_gamma = gamma is not None
    g = torch.ones(c, dtype=torch.float32, device=dev) if gamma is None else gamma
    c, f, tc, vecs = _check(x, w0, w1, [("dy", dy)],
                            [("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c), ("b0", b0, f),
                             ("b1", b1, c), ("gamma", g, c)])
    if pick_tile_rows(c, tc, bwd_smem_bytes) is None:
        raise ValueError(f"LN-MLP backward kernel: no row tile fits shared memory at C={c}")
    x2, dy2 = x.reshape(-1, c).contiguous(), dy.reshape(-1, c).contiguous()
    w0, w1 = w0.contiguous(), w1.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2)
    dw0, dw1 = torch.empty_like(w0), torch.empty_like(w1)
    dvec_c = torch.empty((4, c), **f32)  # ds, db, db1, dgamma
    db0 = torch.empty(f, **f32)
    if x2.shape[0] == 0:
        for t in (dw0, dw1, dvec_c, db0):
            t.zero_()
    else:
        _launch_bwd(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, c, f, tc, has_gamma, eps)
    dgamma = dvec_c[3] if has_gamma else None
    return dx, dvec_c[0], dvec_c[1], dw0, db0, dw1, dvec_c[2], dgamma


def _launch_bwd(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, c, f, tc, has_gamma, eps):
    """Allocate the backward's scratch and launch ln_mlp_bwd.cu's kernels."""
    dev, dt = x2.device, x2.dtype
    rows = x2.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    tr = pick_tile_rows(c, tc, bwd_smem_bytes)
    tiles = -(-rows // tr)
    # the row kernel's outputs for the weight gradients, in the compute dtype:
    # h = LN(x), dy2 = dy * gamma, g = gelu(u), du (rows, F)
    h, dy2s = torch.empty_like(x2), torch.empty_like(x2)
    gact, du = torch.empty((rows, f), dtype=dt, device=dev), torch.empty((rows, f), dtype=dt,
                                                                         device=dev)
    part_c, part_f = torch.empty((4, tiles, c), **f32), torch.empty((tiles, f), **f32)
    slab = _wgrad_split(rows, c, f)
    part_w = torch.empty((-(-rows // slab), c * f), **f32)
    lib = _build.load("ln_mlp_bwd", _BWD_SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp_bwd(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            dw0.data_ptr(), dw1.data_ptr(), dvec_c.data_ptr(), db0.data_ptr(),
            h.data_ptr(), dy2s.data_ptr(), gact.data_ptr(), du.data_ptr(),
            part_c.data_ptr(), part_f.data_ptr(), part_w.data_ptr(),
            rows, c, f, tr, slab, float(eps), int(dt == torch.bfloat16), int(tc),
            int(has_gamma), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp_bwd launch")
    fused_ln_mlp_bwd.launches += 1


fused_ln_mlp_bwd.launches = 0  # kernel launches, counted by the wrapper


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


def reference_ln_mlp_bwd(x, ln_scale, ln_bias, w0, b0, w1, b1, gamma, dy, eps: float = 1e-6):
    """Plain backward on (R, C) rows: ``(dx, ds, db, dw0, db0, dw1, db1,
    dgamma)``, the twin of nkbx's ``_lnmlp_bwd_kernel`` (mlp.py:520-570)
    rounding point by rounding point. The forward is recomputed per row
    with one erf shared by GELU and GELU'; y is rounded to the compute dtype
    before ``dgamma += Σ dout·y`` (a product in the compute dtype);
    ``dy2 = dout·gamma`` is in the compute dtype; du is rounded to the
    compute dtype for the dw0 and dh products while db0 sums the f32 du; the
    LN backward is f32 with the fast-variance xhat and rstd. Products
    accumulate in f32; dw0/dw1 are returned in the weights' dtype and the
    vectors in f32. Without a layer-scale (gamma None) dgamma is None."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    scale = ln_scale.float()
    h = (xhat * scale + ln_bias.float()).to(dt).float()
    u = h @ w0.float() + b0.float()
    cdf = 0.5 * (1.0 + torch.erf(u * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    g = (u * cdf).to(dt).float()
    gm = torch.ones_like(scale) if gamma is None else gamma.float()
    dgamma = None
    if gamma is not None:
        y = (g @ w1.float() + b1.float()).to(dt)
        dgamma = (dy * y).float().sum(0)
    dy2 = (dy * gm.to(dt)).float()
    dw1 = g.t() @ dy2
    db1 = dy2.sum(0)
    du = (dy2 @ w1.float().t()) * (cdf + u * pdf)
    dub = du.to(dt).float()
    dw0 = h.t() @ dub
    db0 = du.sum(0)
    dh = dub @ w0.float().t()
    ds = (dh * xhat).sum(0)
    db = dh.sum(0)
    dxhat = dh * scale
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(dt)
    return dx, ds, db, dw0.to(w0.dtype), db0, dw1.to(w1.dtype), db1, dgamma
