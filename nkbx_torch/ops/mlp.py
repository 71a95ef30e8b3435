"""Fused MLPs: the CUDA kernels and their plain PyTorch versions, forward
and backward. Counterpart of ``nkbx/ops/mlp.py``, both of its members:

- LN-fused, ``shortcut + gamma * (gelu(LN(x) @ w0 + b0) @ w1 + b1)`` with
  flax LayerNorm semantics (f32 statistics, fast variance):
  :func:`fused_ln_mlp`, the kernels K5 (``csrc/ln_mlp.cu``, replacing the
  Pallas ``_lnmlp_fwd_kernel``) and K6 (``csrc/ln_mlp_bwd.cu``, replacing
  ``_lnmlp_bwd_kernel``). In bf16 at the tensor-core widths
  (:func:`tensor_cores`) both run as a few GEMMs on one hand-written
  tensor-core mainloop (``csrc/gemm_tc.cuh``) with their own epilogues
  (C entries ``nkbx_ln_mlp_gemm``, ``nkbx_ln_mlp_bwd_gemm``); f32 and other
  widths run the first design, a row-tile kernel (``nkbx_ln_mlp``,
  ``nkbx_ln_mlp_bwd``);
- MLP-only, ``gelu(x @ w0 + b0) @ w1 + b1``: :func:`fused_mlp`, the kernels
  K7 and K8, the same sources' LN-free members (replacing the Pallas
  ``_fwd_kernel`` and ``_bwd_kernel``): in bf16 at the tensor-core widths
  the same GEMMs without the LayerNorm, layer-scale and residual (C entries
  ``nkbx_mlp_gemm``, ``nkbx_mlp_bwd_gemm``), else the first design
  (``nkbx_mlp``, ``nkbx_mlp_bwd``).

All of them accumulate in f32, evaluate the exact GELU in f32, and round to
the compute dtype at the points of nkbx's kernels. Each entry is
differentiable through one ``torch.autograd.Function``: on CUDA tensors both
halves are the kernels, on CPU tensors both are the plain versions.
:func:`fused_mlp_mode` picks between them as nkbx does: the LN-fused kernels
unless ``NKBX_FUSED_LN_MLP=0`` or their tiles do not fit, then the MLP-only
ones, then the plain version; under :func:`~nkbx_torch.ops.attention.disable_fused`
the plain version always. While a model is traced for export, the forwards
are the registered ops ``nkbx_torch::ln_mlp`` and ``nkbx_torch::mlp``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import types

from typing import Optional

import torch
import torch.nn.functional as F

from nkbx_torch.ops import _build
from nkbx_torch.ops.attention import fused_force_disabled

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_ln_mlp": [_P] * 10 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
               "nkbx_ln_mlp_gemm": [_P] * 13 + [_I] * 4 + [ctypes.c_float, _P],
               "nkbx_mlp": [_P] * 6 + [_I] * 6 + [_P],
               "nkbx_mlp_gemm": [_P] * 8 + [_I] * 4 + [_P]}
_BWD_SIGNATURES = {"nkbx_ln_mlp_bwd": [_P] * 21 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
                   "nkbx_ln_mlp_bwd_gemm": [_P] * 25 + [_I] * 5 + [ctypes.c_float, _I, _P],
                   "nkbx_mlp_bwd": [_P] * 16 + [_I] * 7 + [_P],
                   "nkbx_mlp_bwd_gemm": [_P] * 16 + [_I] * 5 + [_P]}
_CHUNK = 64  # kChunk of ln_mlp.cu and ln_mlp_bwd.cu
_TILE_ROWS = (64, 32, 16)  # row tiles the kernels are instantiated for
_MAX_SMEM = _build.MAX_SMEM
_TWO_BLOCKS_SMEM = 113_000  # at most this per block keeps two blocks on an SM
_WGRAD_TILE = 64  # output tile of the weight-gradient kernel (ln_mlp_bwd.cu)
_WGRAD_BLOCKS = 528  # the weight-gradient kernel splits rows until about this many blocks
# the GEMM route (csrc/gemm_tc.cuh, and the row kernels of ln_mlp.cu and ln_mlp_bwd.cu)
GEMM_TILE_M = 128  # rows of a block tile (kBM)
GEMM_SLAB_K = 32  # depth of a ring slab (kBK); a split of K is cut at its multiples
GEMM_ROW_TILE = 64  # rows a block of the backward's row kernels (kRowTile)
# block tile columns of each GEMM (Fc1, Fc2, DualCfg, Wide in the sources)
_GEMM_N = {"h·w0": 128, "g·w1": 128, "dual": 64, "du·w0ᵀ": 128, "wgrad": 128}
_LN_ROWS = 8  # rows a block of the forward's LayerNorm kernel (kLnRows)
_BLOCKS_PER_SM = 2  # blocks of a GEMM resident on an SM at once
_WAVE_SHARE = 0.75  # a split of K stops once its waves of blocks are this full
_MIN_SLAB = {"g·w1": 512, "du·w0ᵀ": 512, "wgrad": 1024}  # least depth of a slab of K


def tensor_cores(dtype, c: int, f: int) -> bool:
    """Whether the bf16 tensor-core kernels take this geometry (C a multiple
    of 32, F of 64: every Swin, ConvNeXt and ViT width): K5-K8 then run as
    GEMMs (``nkbx_ln_mlp_gemm``, ``nkbx_ln_mlp_bwd_gemm``, ``nkbx_mlp_gemm``,
    ``nkbx_mlp_bwd_gemm``); else the first design's float-FMA kernels run."""
    return dtype == torch.bfloat16 and c % 32 == 0 and f % _CHUNK == 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_blocks(m: int, n: int, bn: int, slabs: int = 1) -> int:
    """Blocks of one GEMM launch: 128 x ``bn`` tiles of the (m, n) output,
    times the slabs of a split over K."""
    return _cdiv(m, GEMM_TILE_M) * _cdiv(n, bn) * slabs


def split_depth(tiles: int, depth: int, min_depth: int, sms: int = 132) -> int:
    """The depth of each slab (a multiple of GEMM_SLAB_K) when a GEMM of
    ``tiles`` output tiles splits its K = ``depth`` into slabs, each a
    block's: the fewest slabs whose blocks fill their waves (``sms`` times
    ``_BLOCKS_PER_SM`` resident blocks) to ``_WAVE_SHARE``, else the
    fullest, none shallower than ``min_depth``. A GEMM with few tiles and a
    long K (g·w1 at Swin-T stage 3 or ViT-B bucket 8, the weight gradients)
    would otherwise leave SMs idle."""
    slots = sms * _BLOCKS_PER_SM
    best, best_share = 1, 0.0
    for n in range(1, max(1, depth // min_depth) + 1):
        blocks = tiles * n
        share = blocks / (_cdiv(blocks, slots) * slots)
        if share > best_share:
            best, best_share = n, share
        if share >= _WAVE_SHARE:
            break
    return _cdiv(_cdiv(depth, best), GEMM_SLAB_K) * GEMM_SLAB_K


@functools.lru_cache(maxsize=256)
def gemm_slabs(rows: int, c: int, f: int, sms: int = 132) -> types.MappingProxyType:
    """The depth of a slab of K of each split GEMM: g·w1 and du·w0ᵀ (K = F,
    over the (R, C) output) and the weight gradients (K = R, over (C, F)).
    Cached, read-only."""
    def slab(what, m, n, depth):
        return split_depth(gemm_blocks(m, n, _GEMM_N[what]), depth, _MIN_SLAB[what], sms)

    return types.MappingProxyType({"g·w1": slab("g·w1", rows, c, f),
                                   "du·w0ᵀ": slab("du·w0ᵀ", rows, c, f),
                                   "wgrad": slab("wgrad", c, f, rows)})


def slab_ranges(depth: int, slab: int) -> list:
    """[start, end) of each slab of a split K, in the order their partials
    are added (block y of the launch takes slab y)."""
    return [(k0, min(depth, k0 + slab)) for k0 in range(0, depth, slab)]


def gemm_plan(rows: int, c: int, f: int, backward: bool = False, has_gamma: bool = False,
              ln: bool = True, sms: int = 132):
    """The route's launches in order, ``(kernel, what, blocks)``, as
    ``nkbx_ln_mlp_gemm`` / ``nkbx_ln_mlp_bwd_gemm`` make them, or with ``ln``
    False as ``nkbx_mlp_gemm`` / ``nkbx_mlp_bwd_gemm`` (K7/K8: no LayerNorm
    kernels, x and dy in the places of h and dy2, dx from du·w0ᵀ's epilogue;
    ``has_gamma`` is not read). A sum of partials: ``colsum`` 32 columns a
    block, ``slab_sum`` 1024 values, ``fc2_finish`` 512."""
    n, sl = _GEMM_N, gemm_slabs(rows, c, f, sms)
    fc2 = len(slab_ranges(f, sl["g·w1"]))
    if not backward:
        plan = [("ln_mlp_layernorm_kernel", "h", _cdiv(rows, _LN_ROWS))] if ln else []
        plan += [("ln_mlp_gemm_kernel", "h·w0" if ln else "x·w0", gemm_blocks(rows, f, n["h·w0"])),
                 ("ln_mlp_gemm_kernel", "g·w1", gemm_blocks(rows, c, n["g·w1"], fc2))]
        if fc2 > 1:
            plan.append(("ln_mlp_fc2_finish_kernel", "out", _cdiv(rows * c // 2, 256)))
        return plan
    tiles = _cdiv(rows, GEMM_ROW_TILE)
    dh = len(slab_ranges(f, sl["du·w0ᵀ"]))
    wg = len(slab_ranges(rows, sl["wgrad"]))
    if not ln:
        plan = [("ln_mlp_bwd_db1_kernel", "db1", tiles * _cdiv(c, 64)),
                ("ln_mlp_bwd_dual_kernel", "x·w0, dy·w1ᵀ", gemm_blocks(rows, f, n["dual"])),
                ("ln_mlp_bwd_gemm_kernel", "du·w0ᵀ (dx)", gemm_blocks(rows, c, n["du·w0ᵀ"], dh))]
        if dh > 1:
            plan.append(("ln_mlp_bwd_slab_sum_kernel", "dx", _cdiv(rows * c // 4, 256)))
        plan += [("ln_mlp_bwd_colsum_kernel", "db1", _cdiv(c, 32)),
                 ("ln_mlp_bwd_colsum_kernel", "db0", _cdiv(f, 32))]
        wgrads = (("gᵀ·dy", "dw1", f, c), ("xᵀ·du", "dw0", c, f))
    else:
        plan = [("ln_mlp_bwd_rows_kernel", "h, dy2", _cdiv(rows, _LN_ROWS)),
                ("ln_mlp_bwd_db1_kernel", "db1", tiles * _cdiv(c, 64)),
                ("ln_mlp_bwd_dual_kernel", "h·w0, dy2·w1ᵀ", gemm_blocks(rows, f, n["dual"]))]
        if has_gamma:
            plan.append(("ln_mlp_bwd_gemm_kernel", "g·w1 (dgamma)",
                         gemm_blocks(rows, c, n["du·w0ᵀ"])))
        plan += [("ln_mlp_bwd_gemm_kernel", "du·w0ᵀ (ds, db)",
                  gemm_blocks(rows, c, n["du·w0ᵀ"], dh)),
                 ("ln_mlp_bwd_lnb_kernel", "dx", _cdiv(rows, _LN_ROWS)),
                 ("ln_mlp_bwd_colsum_kernel", "ds, db", 2 * _cdiv(c, 32)),
                 ("ln_mlp_bwd_colsum_kernel", "db1", _cdiv(c, 32))]
        if has_gamma:
            plan.append(("ln_mlp_bwd_colsum_kernel", "dgamma", _cdiv(c, 32)))
        plan.append(("ln_mlp_bwd_colsum_kernel", "db0", _cdiv(f, 32)))
        wgrads = (("gᵀ·dy2", "dw1", f, c), ("hᵀ·du", "dw0", c, f))
    for what, grad, m, nn in wgrads:
        plan.append(("ln_mlp_bwd_gemm_kernel", what, gemm_blocks(m, nn, n["wgrad"], wg)))
        if wg > 1:
            plan.append(("ln_mlp_bwd_slab_sum_kernel", grad, _cdiv(c * f // 4, 256)))
    return plan


@functools.lru_cache(maxsize=256)
def gemm_scratch(rows: int, c: int, f: int, backward: bool = False, has_gamma: bool = False,
                 ln: bool = True, sms: int = 132) -> types.MappingProxyType:
    """``{name: (shape, dtype)}`` of the route's scratch, in the C entry's
    order. Forward: h (not with ``ln`` False: K7 reads x), the hidden g, and
    g·w1's slab partials when K is split. Backward: h, dy2, g, round(du) in
    bf16; du·w0ᵀ's slab partials (dh) and the row statistics in f32; the
    partials of the vector gradients (ds and db per slab of dh and 128-row
    tile, db1 per 64-row tile, dgamma and db0 per 128-row tile) and of the
    weight gradients (per slab of rows, when there are several). With ``ln``
    False (K8): g, round(du), dh only when K is split, and the partials of
    db1, db0 and the weight gradients. Cached, read-only."""
    bf, f32 = torch.bfloat16, torch.float32
    sl = gemm_slabs(rows, c, f, sms)
    fc2 = len(slab_ranges(f, sl["g·w1"]))
    if not backward:
        h = {"h": ((rows, c), bf)} if ln else {}
        return types.MappingProxyType({**h, "g": ((rows, f), bf),
                                       "part": ((fc2 if fc2 > 1 else 0, rows, c), f32)})
    tiles, tiles_m = _cdiv(rows, GEMM_ROW_TILE), _cdiv(rows, GEMM_TILE_M)
    dh = len(slab_ranges(f, sl["du·w0ᵀ"]))
    wg = len(slab_ranges(rows, sl["wgrad"]))
    part_w = ((wg if wg > 1 else 0, c * f), f32)
    if not ln:
        return types.MappingProxyType({
            "gact": ((rows, f), bf), "du": ((rows, f), bf),
            "dh": ((dh if dh > 1 else 0, rows, c), f32), "part_b1": ((tiles, c), f32),
            "part_f": ((tiles_m, f), f32), "part_w": part_w})
    return types.MappingProxyType({
        "h": ((rows, c), bf), "dy2": ((rows, c), bf), "gact": ((rows, f), bf),
        "du": ((rows, f), bf), "dh": ((dh, rows, c), f32), "stats": ((2, rows), f32),
        "part_c": ((2, dh * tiles_m, c), f32), "part_b1": ((tiles, c), f32),
        "part_g": ((tiles_m if has_gamma else 0, c), f32), "part_f": ((tiles_m, f), f32),
        "part_w": part_w})


def check_gemm_operands(x, w0, w1):
    """Refuse what the GEMM route does not take: TypeError unless x, w0 and
    w1 are bf16, ValueError unless C % 32 == 0 and F % 64 == 0 with w0 (C,
    F) and w1 (F, C)."""
    c, f = x.shape[-1], w0.shape[-1]
    for name, t in (("x", x), ("w0", w0), ("w1", w1)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the MLP GEMM route takes bfloat16, got {name} {t.dtype}")
    if tuple(w0.shape) != (c, f) or tuple(w1.shape) != (f, c):
        raise ValueError(f"w0 {tuple(w0.shape)} / w1 {tuple(w1.shape)} are not (C, F) / (F, C)")
    if not tensor_cores(x.dtype, c, f):
        raise ValueError(f"the MLP GEMM route takes C % 32 == 0 and F % 64 == 0, got C={c}, "
                         f"F={f}")


def _scratch(plan: dict, dev) -> dict:
    return {k: torch.empty(shape, dtype=dt, device=dev) for k, (shape, dt) in plan.items()}


@functools.lru_cache(maxsize=None)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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


def mlp_smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one K7 block: the layout of K5 (``smem_bytes``), with
    the rows of x where K5 keeps the LayerNorm output."""
    return smem_bytes(tile_rows, c, tc)


def _align(n: int) -> int:
    return -(-n // 256) * 256


def _row_layout_bytes(tile_rows: int, c: int, tc: bool, ln: bool) -> int:
    tr = tile_rows
    if tc:
        parts = [tr * (c + 8) * 2, tr * (c + 8) * 2, tr * (c + 4) * 4,
                 4 * tr * (_CHUNK + 4) * 4, tr * (_CHUNK + 8) * 2, 2 * 128 * 40 * 2]
    else:
        parts = [tr * (c + 1) * 4] * 3 + [2 * tr * (_CHUNK + 1) * 4, tr * (_CHUNK + 1) * 4]
    stats = _align(2 * tr * 4) if ln else 0
    return sum(_align(p) for p in parts) + stats + _align(256 * 4)


def bwd_smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one block of K6's row-tile kernel (mirrors
    ``row_layout`` in ln_mlp_bwd.cu). Tensor cores: bf16 h and dy2 rows
    (C+8 each), f32 y-then-dh accumulators (C+4), two f32 chunk pairs (68)
    for the split-k partial sums of u and dgl, one bf16 chunk (72), two
    staged weight slabs of 128x40 bf16; FMA: f32 h, dy2 and accumulators
    (C+1 each), three f32 chunks (65); then the per-row statistics and a
    256-float scratch. Each part starts 256-byte aligned."""
    return _row_layout_bytes(tile_rows, c, tc, ln=True)


def mlp_bwd_smem_bytes(tile_rows: int, c: int, tc: bool) -> int:
    """Shared memory of one block of K8's row-tile kernel: K6's layout with x
    and dy in place of h and dy2, and no per-row statistics."""
    return _row_layout_bytes(tile_rows, c, tc, ln=False)


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
    ``"ln"`` (K5/K6, :func:`fused_ln_mlp`), ``"mlp"`` (K7/K8 after a plain
    LayerNorm, :func:`fused_mlp`) or None (the plain version). Precedence as
    in nkbx (mlp.py:167-171, 216-234): ``disable_fused()``, then the
    ``NKBX_FUSED_MLP=0|1`` env override, then the flag, then auto (None): the family's default, ``auto`` (Swin and
    ConvNeXt: True, ViT: False), where True means the kernels wherever the
    tensor is on a CUDA device. Then ``"ln"`` where K5's and K6's tiles both
    fit shared memory and ``NKBX_FUSED_LN_MLP`` is not 0, else ``"mlp"``
    where K7's and K8's tiles both fit theirs, else None (nkbx's
    ``fused_mlp_viable`` also sizes forward and backward)."""
    if fused_force_disabled():
        return None
    env = os.environ.get("NKBX_FUSED_MLP", "")
    if env:
        on = env not in ("0", "false", "False")
    else:
        on = (auto and x.is_cuda) if flag is None else bool(flag)
    if not on:
        return None
    c = x.shape[-1]
    tc = tensor_cores(x.dtype, c, f)

    def fits(fwd, bwd):
        return pick_tile_rows(c, tc, fwd) is not None and pick_tile_rows(c, tc, bwd) is not None

    ln_off = os.environ.get("NKBX_FUSED_LN_MLP", "") in ("0", "false", "False")
    if not ln_off and fits(smem_bytes, bwd_smem_bytes):
        return "ln"
    return "mlp" if fits(mlp_smem_bytes, mlp_bwd_smem_bytes) else None


def _check(x, w0, w1, dev_tensors, vecs):
    """Validate the kernels' inputs; returns (C, F, tensor cores, f32
    contiguous vectors)."""
    c, f = x.shape[-1], w0.shape[1]
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"MLP kernels take float32 or bfloat16, got {dt}")
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
    """The forward half on (R, C) rows: the kernels on a CUDA tensor (the
    GEMM route where :func:`tensor_cores` holds, else the first design), the
    plain version on a CPU tensor."""
    if not x.is_cuda:
        return reference_ln_mlp(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps)
    dev = x.device
    c, f = x.shape[-1], w0.shape[1]
    g = torch.ones(c, dtype=torch.float32, device=dev) if gamma is None else gamma
    c, f, tc, vecs = _check(x, w0, w1, [("shortcut", shortcut)],
                            [("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c), ("b0", b0, f),
                             ("b1", b1, c), ("gamma", g, c)])
    gemm = tensor_cores(x.dtype, c, f)
    if not gemm and pick_tile_rows(c, tc) is None:
        raise ValueError(f"LN-MLP kernel: no row tile fits shared memory at C={c}")
    x2, sc2 = _build.aligned(x), _build.aligned(shortcut)
    w0, w1 = _build.aligned(w0), _build.aligned(w1)
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out
    if gemm:
        _launch_fwd_gemm(x2, vecs, w0, w1, sc2, out, eps)
        fused_ln_mlp.gemm_launches += 1
    else:
        _launch_fwd_rows(x2, vecs, w0, w1, sc2, out, tc, eps)
    fused_ln_mlp.launches += 1
    return out


def _launch_fwd_gemm(x2, vecs, w0, w1, sc2, out, eps):
    """K5 on the GEMM route (``nkbx_ln_mlp_gemm``): the LayerNorm rows, then
    h·w0 and g·w1 with their epilogues."""
    check_gemm_operands(x2, w0, w1)
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    sms = _sms(dev)
    t = _scratch(gemm_scratch(rows, c, f, sms=sms), dev)
    lib = _build.load("ln_mlp", _SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp_gemm(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), sc2.data_ptr(), out.data_ptr(),
            *(v.data_ptr() for v in t.values()), rows, c, f,
            gemm_slabs(rows, c, f, sms)["g·w1"], float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp gemm launch")


def _launch_fwd_rows(x2, vecs, w0, w1, sc2, out, tc, eps):
    """K5's first design (``nkbx_ln_mlp``): one row-tile kernel; ``tc``
    takes its bf16 tensor-core member."""
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    tr = pick_tile_rows(c, tc)
    lib = _build.load("ln_mlp", _SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), sc2.data_ptr(), out.data_ptr(),
            rows, c, f, tr, float(eps), int(x2.dtype == torch.bfloat16), int(tc),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp launch")


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
    sums the two cotangents, as JAX does. Under ``torch.export`` the forward
    is the op ``nkbx_torch::ln_mlp``."""
    c = x.shape[-1]
    if torch.compiler.is_exporting():
        y = ln_mlp_op(x.reshape(-1, c), ln_scale, ln_bias, w0, b0, w1, b1,
                      shortcut.reshape(-1, c), gamma, float(eps))
    else:
        y = _LnMlp.apply(x.reshape(-1, c), ln_scale, ln_bias, w0, b0, w1, b1,
                         shortcut.reshape(-1, c), gamma, eps)
    return y.reshape(x.shape)


@torch.library.custom_op("nkbx_torch::ln_mlp", mutates_args=())
def ln_mlp_op(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, w0: torch.Tensor,
              b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, shortcut: torch.Tensor,
              gamma: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """K5's forward on (R, C) rows as a registered op (forward only), the
    node an exported program keeps: on a CUDA tensor the kernel, counted, on
    a CPU tensor the plain version."""
    return _forward(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps)


@ln_mlp_op.register_fake
def _(x, ln_scale, ln_bias, w0, b0, w1, b1, shortcut, gamma, eps):
    return x.new_empty(x.shape)


fused_ln_mlp.launches = 0  # forward kernel launches, counted by _forward
fused_ln_mlp.gemm_launches = 0  # those on the GEMM route


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
    this launches the kernels (the GEMM route where :func:`tensor_cores`
    holds, else the first design: a row-tile kernel, then fixed-order
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
    gemm = tensor_cores(x.dtype, c, f)
    if not gemm and pick_tile_rows(c, tc, bwd_smem_bytes) is None:
        raise ValueError(f"LN-MLP backward kernel: no row tile fits shared memory at C={c}")
    x2, dy2 = _build.aligned(x.reshape(-1, c)), _build.aligned(dy.reshape(-1, c))
    w0, w1 = _build.aligned(w0), _build.aligned(w1)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2)
    dw0, dw1 = torch.empty_like(w0), torch.empty_like(w1)
    dvec_c = torch.empty((4, c), **f32)  # ds, db, db1, dgamma
    db0 = torch.empty(f, **f32)
    if x2.shape[0] == 0:
        for t in (dw0, dw1, dvec_c, db0):
            t.zero_()
    elif gemm:
        _launch_bwd_gemm(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, has_gamma, eps)
        fused_ln_mlp_bwd.gemm_launches += 1
        fused_ln_mlp_bwd.launches += 1
    else:
        _launch_bwd(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, c, f, tc, has_gamma, eps)
        fused_ln_mlp_bwd.launches += 1
    dgamma = dvec_c[3] if has_gamma else None
    return dx, dvec_c[0], dvec_c[1], dw0, db0, dw1, dvec_c[2], dgamma


def _launch_bwd_gemm(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, has_gamma, eps):
    """K6 on the GEMM route (``nkbx_ln_mlp_bwd_gemm``): allocate the scratch
    of :func:`gemm_scratch` and launch the plan of :func:`gemm_plan`."""
    check_gemm_operands(x2, w0, w1)
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    sms = _sms(dev)
    t = _scratch(gemm_scratch(rows, c, f, backward=True, has_gamma=has_gamma, sms=sms), dev)
    slabs = gemm_slabs(rows, c, f, sms)
    lib = _build.load("ln_mlp_bwd", _BWD_SIGNATURES)
    s, b, b0c, b1c, gc = vecs
    with torch.cuda.device(dev):
        err = lib.nkbx_ln_mlp_bwd_gemm(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w0.data_ptr(), b0c.data_ptr(),
            w1.data_ptr(), b1c.data_ptr(), gc.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            dw0.data_ptr(), dw1.data_ptr(), dvec_c.data_ptr(), db0.data_ptr(),
            *(v.data_ptr() for v in t.values()), rows, c, f, slabs["du·w0ᵀ"], slabs["wgrad"],
            float(eps), int(has_gamma), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_mlp_bwd gemm launch")


def _launch_bwd(x2, vecs, w0, w1, dy2, dx, dw0, dw1, dvec_c, db0, c, f, tc, has_gamma, eps):
    """K6's first design (``nkbx_ln_mlp_bwd``): allocate its scratch and
    launch ln_mlp_bwd.cu's row-tile kernel and reductions; ``tc`` takes the
    bf16 tensor-core members."""
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


fused_ln_mlp_bwd.launches = 0  # kernel launches, counted by the wrapper
fused_ln_mlp_bwd.gemm_launches = 0  # those on the GEMM route


# --- MLP-only: gelu(x @ w0 + b0) @ w1 + b1 (K7, K8) ---------------------------------


def _mlp_forward(x, w0, b0, w1, b1):
    """K7 on (R, C) rows of a CUDA tensor (the GEMM route where
    :func:`tensor_cores` holds, else the first design); the plain version on
    a CPU tensor."""
    if not x.is_cuda:
        return reference_mlp(x, w0, b0, w1, b1)
    c, f = x.shape[-1], w0.shape[1]
    c, f, tc, (b0c, b1c) = _check(x, w0, w1, [], [("b0", b0, f), ("b1", b1, c)])
    if not tc and pick_tile_rows(c, tc, mlp_smem_bytes) is None:
        raise ValueError(f"MLP kernel: no row tile fits shared memory at C={c}")
    x2, w0, w1 = _build.aligned(x), _build.aligned(w0), _build.aligned(w1)
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out
    if tc:
        _launch_mlp_gemm(x2, w0, b0c, w1, b1c, out)
        fused_mlp.gemm_launches += 1
    else:
        _launch_mlp_rows(x2, w0, b0c, w1, b1c, out, tc)
    fused_mlp.launches += 1
    return out


def _launch_mlp_gemm(x2, w0, b0c, w1, b1c, out):
    """K7 on the GEMM route (``nkbx_mlp_gemm``): x·w0 and g·w1 with their
    epilogues, the scratch of :func:`gemm_scratch` with ``ln=False``."""
    check_gemm_operands(x2, w0, w1)
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    sms = _sms(dev)
    t = _scratch(gemm_scratch(rows, c, f, ln=False, sms=sms), dev)
    lib = _build.load("ln_mlp", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_mlp_gemm(
            x2.data_ptr(), w0.data_ptr(), b0c.data_ptr(), w1.data_ptr(), b1c.data_ptr(),
            out.data_ptr(), *(v.data_ptr() for v in t.values()), rows, c, f,
            gemm_slabs(rows, c, f, sms)["g·w1"], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlp gemm launch")


def _launch_mlp_rows(x2, w0, b0c, w1, b1c, out, tc):
    """K7's first design (``nkbx_mlp``): one row-tile kernel; ``tc`` takes
    its bf16 tensor-core member."""
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    lib = _build.load("ln_mlp", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_mlp(
            x2.data_ptr(), w0.data_ptr(), b0c.data_ptr(), w1.data_ptr(), b1c.data_ptr(),
            out.data_ptr(), rows, c, f, pick_tile_rows(c, tc, mlp_smem_bytes),
            int(x2.dtype == torch.bfloat16), int(tc), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlp launch")


class _Mlp(torch.autograd.Function):
    """K7 forward, K8 backward, on (R, C) rows. Saves the inputs and
    recomputes the rest."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        return _mlp_forward(x, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, dy):
        return fused_mlp_bwd(*ctx.saved_tensors, dy)


def fused_mlp(x, w0, b0, w1, b1):
    """``gelu(x @ w0 + b0) @ w1 + b1`` with the exact GELU; x (..., C), w0
    (C, F) and w1 (F, C) in the compute dtype, b0 and b1 f32; leading dims
    are flattened to rows. Differentiable in every argument. On CUDA tensors
    the forward and the backward launch K7 and K8; on CPU tensors they
    compute the plain versions. Under ``torch.export`` the forward is the
    op ``nkbx_torch::mlp``."""
    c = x.shape[-1]
    if torch.compiler.is_exporting():
        return mlp_op(x.reshape(-1, c), w0, b0, w1, b1).reshape(x.shape)
    return _Mlp.apply(x.reshape(-1, c), w0, b0, w1, b1).reshape(x.shape)


@torch.library.custom_op("nkbx_torch::mlp", mutates_args=())
def mlp_op(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
           b1: torch.Tensor) -> torch.Tensor:
    """K7's forward on (R, C) rows as a registered op (forward only): on a
    CUDA tensor the kernel, counted, on a CPU tensor the plain version."""
    return _mlp_forward(x, w0, b0, w1, b1)


@mlp_op.register_fake
def _(x, w0, b0, w1, b1):
    return x.new_empty(x.shape)


fused_mlp.launches = 0  # K7 launches, counted by _mlp_forward
fused_mlp.gemm_launches = 0  # those on the GEMM route


def fused_mlp_bwd(x, w0, b0, w1, b1, dy):
    """Backward of :func:`fused_mlp` on (R, C) rows: ``(dx, dw0, db0, dw1,
    db1)``, dx in x's dtype, dw0/dw1 in the weights' dtype and db0/db1 in
    the biases' dtype (nkbx casts them so, mlp.py:383-384). On a CUDA tensor
    this launches K8 (the GEMM route where :func:`tensor_cores` holds, else
    the first design: a row-tile kernel, then fixed-order reductions of the
    weight and bias gradients); on a CPU tensor it computes
    :func:`reference_mlp_bwd`."""
    if not x.is_cuda:
        return reference_mlp_bwd(x, w0, b0, w1, b1, dy)
    dev = x.device
    c, f = x.shape[-1], w0.shape[1]
    c, f, tc, (b0c, b1c) = _check(x, w0, w1, [("dy", dy)], [("b0", b0, f), ("b1", b1, c)])
    if not tc and pick_tile_rows(c, tc, mlp_bwd_smem_bytes) is None:
        raise ValueError(f"MLP backward kernel: no row tile fits shared memory at C={c}")
    x2, dy2 = _build.aligned(x.reshape(-1, c)), _build.aligned(dy.reshape(-1, c))
    w0, w1 = _build.aligned(w0), _build.aligned(w1)
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dw0, dw1 = torch.empty_like(x2), torch.empty_like(w0), torch.empty_like(w1)
    db1, db0 = torch.empty(c, **f32), torch.empty(f, **f32)
    if x2.shape[0] == 0:
        for t in (dw0, dw1, db1, db0):
            t.zero_()
    elif tc:
        _launch_mlp_bwd_gemm(x2, w0, b0c, w1, dy2, dx, dw0, dw1, db1, db0)
        fused_mlp_bwd.gemm_launches += 1
        fused_mlp_bwd.launches += 1
    else:
        _launch_mlp_bwd(x2, w0, b0c, w1, b1c, dy2, dx, dw0, dw1, db1, db0, tc)
        fused_mlp_bwd.launches += 1
    return dx, dw0, db0.to(b0.dtype), dw1, db1.to(b1.dtype)


def _launch_mlp_bwd_gemm(x2, w0, b0c, w1, dy2, dx, dw0, dw1, db1, db0):
    """K8 on the GEMM route (``nkbx_mlp_bwd_gemm``): allocate the scratch of
    :func:`gemm_scratch` and launch the plan of :func:`gemm_plan`, both with
    ``ln=False``."""
    check_gemm_operands(x2, w0, w1)
    dev, (rows, c), f = x2.device, x2.shape, w0.shape[1]
    sms = _sms(dev)
    t = _scratch(gemm_scratch(rows, c, f, backward=True, ln=False, sms=sms), dev)
    slabs = gemm_slabs(rows, c, f, sms)
    lib = _build.load("ln_mlp_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_mlp_bwd_gemm(
            x2.data_ptr(), w0.data_ptr(), b0c.data_ptr(), w1.data_ptr(), dy2.data_ptr(),
            dx.data_ptr(), dw0.data_ptr(), dw1.data_ptr(), db1.data_ptr(), db0.data_ptr(),
            *(v.data_ptr() for v in t.values()), rows, c, f, slabs["du·w0ᵀ"], slabs["wgrad"],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlp_bwd gemm launch")


def _launch_mlp_bwd(x2, w0, b0c, w1, b1c, dy2, dx, dw0, dw1, db1, db0, tc):
    """K8's first design (``nkbx_mlp_bwd``): allocate its scratch and launch
    ln_mlp_bwd.cu's row-tile kernel and reductions; ``tc`` takes the bf16
    tensor-core members."""
    dev, dt = x2.device, x2.dtype
    (rows, c), f = x2.shape, w0.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    tr = pick_tile_rows(c, tc, mlp_bwd_smem_bytes)
    tiles = -(-rows // tr)
    # g = gelu(u) and round(du) (rows, F) in the compute dtype, for dw1 and dw0
    gact, du = (torch.empty((rows, f), dtype=dt, device=dev) for _ in range(2))
    part_c, part_f = torch.empty((tiles, c), **f32), torch.empty((tiles, f), **f32)
    slab = _wgrad_split(rows, c, f)
    part_w = torch.empty((-(-rows // slab), c * f), **f32)
    lib = _build.load("ln_mlp_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.nkbx_mlp_bwd(
            x2.data_ptr(), w0.data_ptr(), b0c.data_ptr(), w1.data_ptr(), b1c.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), dw0.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            db0.data_ptr(), gact.data_ptr(), du.data_ptr(), part_c.data_ptr(),
            part_f.data_ptr(), part_w.data_ptr(), rows, c, f, tr, slab,
            int(dt == torch.bfloat16), int(tc), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlp_bwd launch")


fused_mlp_bwd.launches = 0  # K8 launches, counted by the wrapper
fused_mlp_bwd.gemm_launches = 0  # those on the GEMM route


def reference_mlp(x, w0, b0, w1, b1):
    """Plain PyTorch version with flax Dense semantics, the twin of nkbx's
    ``reference_mlp`` (mlp.py:469-475): the biases added in the compute
    dtype, the exact GELU."""
    dt = x.dtype
    u = x @ w0 + b0.to(dt)
    return F.gelu(u) @ w1 + b1.to(dt)


def reference_mlp_bwd(x, w0, b0, w1, b1, dy):
    """Plain backward on (R, C) rows: ``(dx, dw0, db0, dw1, db1)``, the twin
    of nkbx's ``_bwd_kernel`` (mlp.py:265-305) rounding point by rounding
    point: u = x·w0 + b0 in f32; one erf shared by GELU and GELU'; g rounded
    to the compute dtype before dw1 = gᵀ·dy; db1 = Σ dy in f32; du =
    (dy·w1ᵀ)∘GELU'(u) in f32, rounded to the compute dtype for dw0 = xᵀ·du
    and dx = du·w0ᵀ, while db0 sums the f32 du. Products accumulate in f32;
    dx is in x's dtype, the weights' and biases' gradients in theirs."""
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    u = xf @ w0.float() + b0.float()
    cdf = 0.5 * (1.0 + torch.erf(u * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    g = (u * cdf).to(dt).float()
    dw1 = g.t() @ dyf
    db1 = dyf.sum(0)
    du = (dyf @ w1.float().t()) * (cdf + u * pdf)
    dub = du.to(dt).float()
    dw0 = xf.t() @ dub
    db0 = du.sum(0)
    dx = (dub @ w0.float().t()).to(dt)
    return dx, dw0.to(w0.dtype), db0.to(b0.dtype), dw1.to(w1.dtype), db1.to(b1.dtype)


# --- plain versions of the LN-fused kernels ------------------------------------------


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
