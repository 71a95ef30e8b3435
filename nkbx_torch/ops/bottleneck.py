"""The fused ResNet bottleneck chain: the CUDA kernels K9 (forward) and K10
(backward) and their plain PyTorch versions. Counterpart of
``nkbx/ops/bottleneck.py``.

One stride-1 identity bottleneck block, conv1x1 + BN + relu -> conv3x3 + BN +
relu -> conv1x1 + BN -> + x -> relu, with **tile-local** BatchNorm
statistics: each statistics group is one tile of ``g`` samples of a ghost
batch x ``th`` image rows x the full width (nkbx's labelled opt-in,
``ResNet(ghost_bn=g, fused_bottleneck=True)``). ``th`` comes from
:func:`stat_band`, nkbx's rule; a different ``th`` gives different numbers.

The numbers follow nkbx's Pallas kernels (``_recompute``, ``_fwd_kernel``,
``_bn_bwd_partial``, ``_bwd_kernel``):

- every product accumulates in f32; u1, u2 and u3 stay f32; a1, a2, y3 and
  du1/du2/du3 round to the compute dtype;
- variance is E[u²]−μ² clamped at 0, the inverse ``rsqrt(var + eps)``;
- BN1's statistics come from a tile's core rows; its two halo rows per
  sample (the 3x3 conv's neighbours in the bands above and below) are
  normalised with this tile's statistics, so one image row has a different
  a1 in each tile that reads it; halo rows at the image edge are zero in
  the activation domain;
- the residual adds in the compute dtype, ``relu(round(y3) + x)``, and the
  backward recomputes the relu mask from that rounded sum;
- BN1's backward correction applies to core rows only while its sums run
  over every ext row; the halo rows' du1 fold into dx of the neighbouring
  bands after the kernel (a product and an indexed add, as nkbx does it
  outside its kernel);
- dw1, dw2, dw3 and the BN vectors' gradients are f32 sums over tiles in a
  fixed order.

:func:`fused_chain` is one ``torch.autograd.Function``: on CUDA tensors K9
forward and K10 backward, on CPU tensors the plain versions; the per-tile
statistics carry no gradient. ``NKBX_FUSED_CHAIN=0`` asks for the plain
versions on the card too, with the same tiles (nkbx's ``interpret=``
counterpart, for comparisons). A CUDA tensor whose shape the kernels do not
take raises.

Two designs of each kernel. In bf16 with C and M multiples of 32
(:func:`takes_tc`: every chain block of the ResNets) K9 and K10 run as GEMMs
on the tensor-core engine of ``csrc/gemm_tc.cuh`` (``csrc/bottleneck_tc.cuh``:
the 3x3 convolution and its input gradient one GEMM each through a row map,
the statistics and BN-backward sums from the GEMM epilogues, u3 recomputed
rather than stored); ``fused_chain.tc_launches`` and
``fused_chain_bwd.tc_launches`` count those launches. f32 and other widths
run the first design (``csrc/bottleneck.cuh``), which stays reachable in
bf16 through ``_forward(..., tc=False)`` and ``_backward(..., tc=False)``.
A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_SIGNATURES = {"nkbx_chain_fwd": [_P] * 22 + [_I] * 7 + [ctypes.c_float, _I, _P],
                   "nkbx_chain_fwd_gemm": [_P] * 23 + [_I] * 7 + [ctypes.c_float, _P]}
_BWD_SIGNATURES = {"nkbx_chain_bwd": [_P] * 40 + [_I] * 10 + [ctypes.c_float, _I, _P],
                   "nkbx_chain_bwd_gemm": [_P] * 41 + [_I] * 10 + [ctypes.c_float, _P]}
_VEC = 8  # widths must be multiples of 8: the kernels load 16-byte vectors of bf16
_WGRAD_TILE = 64  # output tile of the weight-gradient kernel (bottleneck.cuh)
_WGRAD_BLOCKS = 528  # the weight-gradient kernel splits rows until about this many blocks
# the tensor-core route (bottleneck_tc.cuh): its widths, block tile and the
# blocks its weight gradients aim for (3 blocks an SM of 132)
TC_WIDTH = 32
TC_TILE_M, TC_TILE_N = 128, 64
_TC_WGRAD_BLOCKS = 396

# --- nkbx's grouping rule -----------------------------------------------------------

_VMEM_BUDGET = 12_000_000  # bytes (nkbx/ops/bottleneck.py:61)


def _pad(x, t):
    return -(-x // t) * t


def _tile_bytes(g, th, w, c, m, itemsize, bwd):
    """nkbx's static VMEM estimate for one (g, th) tile (double-buffered streams +
    resident weights/grads + f32 intermediates), copied verbatim from
    ``nkbx/ops/bottleneck.py:68-84``."""
    rows = g * th * w
    rows_ext = g * (th + 2) * w
    e = rows * _pad(c, 128)          # padded C-wide elems (core rows)
    e_ext = rows_ext * _pad(c, 128)
    emid = rows * _pad(m, 128)
    emid_ext = rows_ext * _pad(m, 128)
    # streams: x core + 2 halo rows in, out/dx out, dout in (bwd) — x2 buffers
    streams = 2 * (e_ext + e) * itemsize + (2 * e * itemsize if bwd else 0)
    weights = (2 * _pad(c, 8) * _pad(m, 128) + 9 * _pad(m, 8) * _pad(m, 128)) * itemsize
    interm = (4 + 4) * emid_ext + (2 + 4 + 4) * emid + (4 + 4 + 2) * e
    if bwd:
        weights *= 3  # + f32 grad accumulators
        interm += (4 + 4) * e + (4 + 2) * emid + (4 + 2) * emid_ext
    return streams + weights + interm


def stat_band(b, h, w, c, m, g, itemsize=2):
    """The row band ``th`` of a (g x th x W) statistics tile, or None.

    This is nkbx's grouping rule, ``chain_tile`` (nkbx/ops/bottleneck.py:87-100),
    copied verbatim: the largest divisor of ``h`` whose tile passes nkbx's TPU
    VMEM estimate (:func:`_tile_bytes`) forward and backward. It is not a
    resource gate of the Hopper kernels, which take every ``th``: its answer
    is part of the result, because each tile is one BatchNorm statistics
    group. None (``g`` does not divide ``b``, or no band passes) sends the
    block to the plain ghost-BN path, as in nkbx."""
    if g <= 0 or b % g:
        return None
    for th in sorted((d for d in range(1, h + 1) if h % d == 0), reverse=True):
        if (_tile_bytes(g, th, w, c, m, itemsize, bwd=True) <= _VMEM_BUDGET
                and _tile_bytes(g, th, w, c, m, itemsize, bwd=False)
                <= _VMEM_BUDGET):
            return th
    return None


# --- the plain versions -------------------------------------------------------------


def _ext_tiles(x, g, th):
    """(B, H, W, C) -> (nt, g, th+2, W, C): each tile's core rows with one halo
    row above and below, zero rows at the image edges; tile t = i * (H/th) + j
    holds batch rows [i*g, (i+1)*g) and image rows [j*th, (j+1)*th)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))                         # (B, H+2, W, C)
    ext = xp.unfold(1, th + 2, th).permute(0, 1, 4, 2, 3)    # (B, nh, th+2, W, C)
    ext = ext.reshape(b // g, g, h // th, th + 2, w, c).transpose(1, 2)
    return ext.reshape(-1, g, th + 2, w, c)


def _core_tiles(x, g, th):
    """(B, H, W, C) -> (nt, g, th, W, C), the tiles' core rows."""
    b, h, w, c = x.shape
    return x.reshape(b // g, g, h // th, th, w, c).transpose(1, 2).reshape(-1, g, th, w, c)


def _untile(t, b, h):
    """(nt, g, th, W, C) -> (B, H, W, C), the inverse of :func:`_core_tiles`."""
    nt, g, th, w, c = t.shape
    return t.reshape(b // g, h // th, g, th, w, c).transpose(1, 2).reshape(b, h, w, c)


def _tile_moments(u, n):
    """Mean and variance E[u²]−μ² clamped at 0 over dims 1-3 of u (nt, ., ., ., K)."""
    mu = u.sum((1, 2, 3)) / n
    var = torch.clamp((u * u).sum((1, 2, 3)) / n - mu * mu, min=0)
    return mu, var


def _bc(v):
    """(nt, K) -> (nt, 1, 1, 1, K), per tile against (nt, g, rows, W, K)."""
    return v[:, None, None, None, :]


def _recompute(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g, th, eps):
    """The chain's forward on every tile at once, as nkbx's ``_recompute`` and
    ``_fwd_kernel`` compute it per tile, with the intermediates the backward
    needs. Products upcast compute-dtype operands to f32."""
    dt = x.dtype
    b, h, w, c = x.shape
    m = w1.shape[1]
    nh = h // th
    n = g * th * w
    xe = _ext_tiles(x, g, th)                                  # (nt, g, th+2, W, C)
    nt = xe.shape[0]
    u1 = (xe.float().reshape(-1, c) @ w1.float()).reshape(nt, g, th + 2, w, m)
    mu1, var1 = _tile_moments(u1[:, :, 1:th + 1], n)
    rstd1 = torch.rsqrt(var1 + eps)
    xhat1 = (u1 - _bc(mu1)) * _bc(rstd1)
    z1 = xhat1 * s1.float() + b1.float()
    j = torch.arange(nt, device=x.device) % nh
    he = torch.arange(th + 2, device=x.device)
    edge = ((he == 0) & (j[:, None] == 0)) | ((he == th + 1) & (j[:, None] == nh - 1))
    keep = ~edge[:, None, :, None, None]                      # (nt, 1, th+2, 1, 1)
    a1 = torch.where(keep, torch.relu(z1), 0.0).to(dt)
    a1p = F.pad(a1, (0, 0, 1, 1))                              # (nt, g, th+2, W+2, M)
    w2f = w2.float()
    u2 = sum(a1p[:, :, dy:dy + th, dx:dx + w].float().reshape(-1, m) @ w2f[dy, dx]
             for dy in range(3) for dx in range(3)).reshape(nt, g, th, w, m)
    mu2, var2 = _tile_moments(u2, n)
    rstd2 = torch.rsqrt(var2 + eps)
    xhat2 = (u2 - _bc(mu2)) * _bc(rstd2)
    z2 = xhat2 * s2.float() + b2.float()
    a2 = torch.relu(z2).to(dt)
    u3 = (a2.float().reshape(-1, m) @ w3.float()).reshape(nt, g, th, w, c)
    mu3, var3 = _tile_moments(u3, n)
    rstd3 = torch.rsqrt(var3 + eps)
    xhat3 = (u3 - _bc(mu3)) * _bc(rstd3)
    y3 = (xhat3 * s3.float() + b3.float()).to(dt)
    xc = _core_tiles(x, g, th)
    return dict(xe=xe, xhat1=xhat1, rstd1=rstd1, z1=z1, keep=keep, a1p=a1p, xhat2=xhat2,
                rstd2=rstd2, z2=z2, a2=a2, xhat3=xhat3, rstd3=rstd3, y3=y3, xc=xc, n=n,
                stats=(mu1, var1, mu2, var2, mu3, var3))


def reference_chain(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, g, th, eps=1e-5):
    """Plain PyTorch version of K9, vectorised over tiles: ``(out, (m1, v1, m2,
    v2, m3, v3))`` with out like x and the per-tile statistics (nt, M|C) f32,
    nt = B/g * H/th, tile t = i * (H/th) + j (nkbx's order). x (B, H, W, C);
    w1 (C, M), w2 (3, 3, M, M) HWIO, w3 (M, C) in the compute dtype; the six
    BN vectors f32. The twin of nkbx's ``reference_chain`` and Pallas kernel."""
    r = _recompute(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g, th, eps)
    out = torch.relu(r["y3"] + r["xc"])                       # in the compute dtype
    return _untile(out, x.shape[0], x.shape[1]), r["stats"]


def _bn_bwd(dz, xhat, rstd, s, n, core=None):
    """nkbx's ``_bn_bwd_partial`` on every tile: du = rstd * (s*dz - [core] *
    (S1 + xhat*S2)/n) with S1 = Σ s*dz and S2 = Σ s*dz*xhat over all of a
    tile's rows; returns (du, ds, db) with ds = Σ dz*xhat and db = Σ dz over
    every tile."""
    d = dz * s
    s1 = d.sum((1, 2, 3))
    s2 = (d * xhat).sum((1, 2, 3))
    corr = (_bc(s1) + xhat * _bc(s2)) / n
    if core is not None:
        corr = torch.where(core, corr, 0.0)
    du = _bc(rstd) * (d - corr)
    return du, (dz * xhat).sum((0, 1, 2, 3)), dz.sum((0, 1, 2, 3))


def _fold_halos(dx, du1lo, du1hi, w1, g, th):
    """Fold the halo rows' input gradient into dx (B, H, W, C) in place: the du1
    halo row of tile (i, j), (nt, g, W, M), belongs to image row j*th-1 (lo)
    or j*th+th (hi) of batch group i, through w1ᵀ, in the compute dtype (as
    nkbx, bottleneck.py:413-423). Edge tiles' halos are zero."""
    b, h, w, c = dx.shape
    nb, nh = b // g, h // th
    if nh == 1:
        return dx
    wt = w1.t().to(dx.dtype)
    lo = (du1lo.reshape(nb, nh, g, w, -1) @ wt).transpose(1, 2)  # (nb, g, nh, W, C)
    hi = (du1hi.reshape(nb, nh, g, w, -1) @ wt).transpose(1, 2)
    dxv = dx.view(nb, g, nh, th, w, c)
    dxv[:, :, :-1, th - 1] += lo[:, :, 1:]
    dxv[:, :, 1:, 0] += hi[:, :, :-1]
    return dx


def reference_chain_bwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dout, *, g, th, eps=1e-5):
    """Plain PyTorch version of K10: ``(dx, dw1, dw2, dw3, ds1, db1, ds2, db2,
    ds3, db3)`` with dx like x and the rest f32, nkbx's ``_bwd_kernel`` rounding
    point by rounding point (recompute; relu mask from round(y3) + x; BN3, BN2
    backward; du3, du2 rounded for dw3, da2, dw2 and the 3x3 input gradient, a
    full correlation over the th+2 ext rows; BN1 backward with the correction
    on core rows only; du1 rounded for dw1 over the ext rows, dx's core rows
    and the halo fold)."""
    dt = x.dtype
    b, h, w, c = x.shape
    m = w1.shape[1]
    r = _recompute(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g, th, eps)
    n = r["n"]
    nt = r["xe"].shape[0]
    dz3 = torch.where((r["y3"] + r["xc"]).float() > 0, _core_tiles(dout, g, th).float(), 0.0)
    du3, ds3, db3 = _bn_bwd(dz3, r["xhat3"], r["rstd3"], s3.float(), n)
    du3b = du3.to(dt).float().reshape(-1, c)
    dw3 = r["a2"].float().reshape(-1, m).t() @ du3b
    da2 = (du3b @ w3.float().t()).reshape(nt, g, th, w, m)
    dz2 = torch.where(r["z2"] > 0, da2, 0.0)
    du2, ds2, db2 = _bn_bwd(dz2, r["xhat2"], r["rstd2"], s2.float(), n)
    du2b = du2.to(dt).float()                                 # (nt, g, th, W, M)
    a1p, w2f = r["a1p"], w2.float()
    du2p = F.pad(du2b, (0, 0, 1, 1, 2, 2))                    # (nt, g, th+4, W+2, M)
    dw2 = torch.empty(3, 3, m, m, dtype=torch.float32, device=x.device)
    da1 = 0
    for dy in range(3):
        for dx_ in range(3):
            sl = a1p[:, :, dy:dy + th, dx_:dx_ + w].float().reshape(-1, m)
            dw2[dy, dx_] = sl.t() @ du2b.reshape(-1, m)
            slg = du2p[:, :, dy:dy + th + 2, dx_:dx_ + w].reshape(-1, m)
            da1 = da1 + slg @ w2f[2 - dy, 2 - dx_].t()
    da1 = da1.reshape(nt, g, th + 2, w, m)
    dz1 = torch.where((r["z1"] > 0) & r["keep"], da1, 0.0)
    he = torch.arange(th + 2, device=x.device)
    core = ((he >= 1) & (he <= th))[None, None, :, None, None]
    du1, ds1, db1 = _bn_bwd(dz1, r["xhat1"], r["rstd1"], s1.float(), n, core)
    du1b = du1.to(dt)                                         # (nt, g, th+2, W, M)
    dw1 = r["xe"].float().reshape(-1, c).t() @ du1b.float().reshape(-1, m)
    dx_core = (du1b[:, :, 1:th + 1].float().reshape(-1, m) @ w1.float().t()).to(dt)
    dx = _untile((dx_core + dz3.reshape(-1, c).to(dt)).reshape(nt, g, th, w, c), b, h)
    dx = _fold_halos(dx, du1b[:, :, 0], du1b[:, :, th + 1], w1, g, th)
    return dx, dw1, dw2, dw3, ds1, db1, ds2, db2, ds3, db3


# --- the kernels --------------------------------------------------------------------


def takes_tc(dtype, c: int, m: int) -> bool:
    """Whether K9 and K10 take the tensor-core route: bf16 with C and M
    multiples of 32 (every chain block of the ResNets; each ring slab of the
    3x3 products then lies inside one tap). Otherwise the first design runs."""
    return dtype == torch.bfloat16 and c % TC_WIDTH == 0 and m % TC_WIDTH == 0


def chain_runs(b: int, h: int, w: int, g: int, th: int, ext: bool = False) -> tuple:
    """``(len, pieces, count)`` of the runs whose partial sums the route's
    epilogues write (bottleneck_tc.cuh ``global_runs`` / ``ext_runs``): a run
    is one sample's band of ``th * w`` rows in the global layout (``count =
    b * h / th``), or one tile's ``g * (th + 2) * w`` ext rows; a 128-row
    block tile of a product meets at most ``pieces`` = ceil(len / 128) + 1
    of a run's pieces. Run q's piece p is block tile ``q * len // 128 + p``'s
    part of it."""
    length = g * (th + 2) * w if ext else th * w
    count = (b // g) * (h // th) if ext else b * (h // th)
    return length, -(-length // TC_TILE_M) + 1, count


def _wgrad_slab(rows: int, mo: int, no: int) -> int:
    """Rows of a slab (a multiple of 32) of a route's weight gradient, an
    (mo, no) output over ``rows`` rows: slabs enough that the tiles times the
    slabs come to about ``_TC_WGRAD_BLOCKS`` blocks, none under 256 rows."""
    tiles = -(-mo // TC_TILE_M) * -(-no // TC_TILE_N)
    slabs = max(1, min(-(-_TC_WGRAD_BLOCKS // tiles), -(-rows // 256)))
    return -(-(-(-rows // slabs)) // 32) * 32


def chain_slabs(b: int, h: int, w: int, c: int, m: int, g: int, th: int) -> tuple:
    """Rows of a slab of the route's dw3 (as (C, M)), dw2 ((9 M, M)) and dw1
    ((C, M) over the ext rows)."""
    rows = b * h * w
    ext = (b // g) * (h // th) * g * (th + 2) * w
    return _wgrad_slab(rows, c, m), _wgrad_slab(rows, 9 * m, m), _wgrad_slab(ext, c, m)


def chain_scratch(b: int, h: int, w: int, c: int, m: int, g: int, th: int,
                  backward: bool = False) -> dict:
    """The route's scratch in the order of its C entry's arguments: ``{name:
    (elements, dtype)}``. The forward's u1, u2 (f32) and a1, a2 (bf16), the
    runs' partial sums and the three BNs' per-tile rsqrt(var + eps); the
    backward adds dy, du3, du2, du1 (bf16), the gated dz2 (f32), the per-tile
    BN sums, the weight gradients' slab partials and the row-map tables
    (int32); the gated dz1 (f32, ext rows) goes into du3's buffer, sized for
    the larger of the two. No f32 u3, da2 or da1 (the first design keeps all
    three)."""
    rows = b * h * w
    nt = (b // g) * (h // th)
    ext = nt * g * (th + 2) * w
    glen, gpieces, gcount = chain_runs(b, h, w, g, th)
    elen, epieces, ecount = chain_runs(b, h, w, g, th, ext=True)
    part = max(2 * gcount * gpieces * max(c, m), 2 * ecount * epieces * m)
    f32, bf = torch.float32, torch.bfloat16
    out = {"u1": (rows * m, f32), "a1": (ext * m, bf), "u2": (rows * m, f32),
           "a2": (rows * m, bf)}
    rstd = (nt * (2 * m + c), f32)
    if not backward:
        out.update({"part": (part, f32), "rstd": rstd})
        return out
    slabs = chain_slabs(b, h, w, c, m, g, th)
    wpart = max(-(-rows // slabs[0]) * c * m, -(-rows // slabs[1]) * 9 * m * m,
                -(-ext // slabs[2]) * c * m)
    out.update({"dy": (rows * c, bf), "du3": (max(rows * c, 2 * ext * m), bf),
                "dz2": (rows * m, f32), "du2": (rows * m, bf), "du1": (ext * m, bf),
                "sums": (2 * nt * max(c, m), f32), "part": (part, f32), "wpart": (wpart, f32),
                "maps": (rows + ext, torch.int32), "rstd": rstd})
    return out


def _scratch(sizes: dict, dev) -> dict:
    return {k: torch.empty(n, dtype=dt, device=dev) for k, (n, dt) in sizes.items()}


def _check(x, w1, w2, w3, vecs, g, th):
    """Validate the kernels' inputs; returns (B, H, W, C, M, f32 vectors)."""
    if x.dim() != 4:
        raise ValueError(f"bottleneck chain: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    m = w1.shape[-1]
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bottleneck chain kernels take float32 or bfloat16, got {dt}")
    if g <= 0 or b % g or th <= 0 or h % th:
        raise ValueError(f"bottleneck chain: g={g} must divide B={b} and th={th} H={h}")
    if c % _VEC or m % _VEC:
        raise ValueError(f"bottleneck chain kernels need C and M multiples of {_VEC}, "
                         f"got C={c}, M={m}")
    want = {"w1": (c, m), "w2": (3, 3, m, m), "w3": (m, c)}
    for name, t in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} is not {want[name]}")
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}, got {t.dtype} on {t.device}")
    if b * h * w * max(c, m) >= 2 ** 31:
        raise ValueError("bottleneck chain kernels index rows with 32-bit integers: "
                         f"B*H*W*max(C, M) = {b * h * w * max(c, m)} is too large")
    out = []
    for t, size in zip(vecs, (m, m, m, m, c, c)):
        if t.device != dev or t.numel() != size:
            raise ValueError(f"a BatchNorm vector must hold {size} values on {dev}")
        out.append(t.to(torch.float32).contiguous())
    return b, h, w, c, m, out


def _workspace(x, m, g, th):
    """The forward's f32 products and compute-dtype activations: u1, a1 (over
    the tiles' ext rows), u2, a2, u3."""
    b, h, w, c = x.shape
    rows, ext = b * h * w, (b // g) * (h // th) * g * (th + 2) * w
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty(rows, m, **f32), torch.empty(ext, m, dtype=x.dtype, device=x.device),
            torch.empty(rows, m, **f32), torch.empty(rows, m, dtype=x.dtype, device=x.device),
            torch.empty(rows, c, **f32))


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def fused_chain_fwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, g, th, eps=1e-5):
    """K9 on CUDA tensors: ``(out, (m1, v1, m2, v2, m3, v3))`` as
    :func:`reference_chain` computes them, on the tensor-core route where
    :func:`takes_tc` holds, else the first design. Counts its launches on
    ``fused_chain.launches`` and those on the route on
    ``fused_chain.tc_launches``."""
    tc = takes_tc(x.dtype, x.shape[-1], w1.shape[-1])
    out = _forward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g=g, th=th, eps=eps, tc=tc)
    fused_chain.launches += 1
    fused_chain.tc_launches += tc
    return out


def _forward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, g, th, eps, tc):
    """One K9 launch: ``tc`` takes the tensor-core route (``nkbx_chain_fwd_gemm``;
    it raises where :func:`takes_tc` does not hold), else the first design
    (``nkbx_chain_fwd``, every dtype and width). Counts nothing."""
    b, h, w, c, m, vecs = _check(x, w1, w2, w3, (s1, b1, s2, b2, s3, b3), g, th)
    if tc and not takes_tc(x.dtype, c, m):
        raise ValueError(f"bottleneck chain route: needs bf16 with C and M multiples of "
                         f"{TC_WIDTH}, got {x.dtype}, C={c}, M={m}")
    x, w1, w2, w3 = (_build.aligned(t) for t in (x, w1, w2, w3))
    nt = (b // g) * (h // th)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stats = [torch.empty(nt, k, **f32) for k in (m, m, m, m, c, c)]
    lib = _build.load("bottleneck", _FWD_SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            work = _scratch(chain_scratch(b, h, w, c, m, g, th), x.device)
            err = lib.nkbx_chain_fwd_gemm(*_ptrs(x, w1, w2, w3, *vecs, out, *stats,
                                                 *work.values()),
                                          b, h, w, c, m, g, th, float(eps), stream)
        else:
            err = lib.nkbx_chain_fwd(
                *_ptrs(x, w1, w2, w3, *vecs, out, *stats, *_workspace(x, m, g, th)),
                b, h, w, c, m, g, th, float(eps), int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "bottleneck chain launch")
    return out, tuple(stats)


def _slab_rows(rows: int, k: int, n: int, taps: int) -> int:
    """Rows of each slab of the weight-gradient kernel (a multiple of 32): enough
    slabs to give about ``_WGRAD_BLOCKS`` blocks."""
    tiles = -(-k // _WGRAD_TILE) * -(-n // _WGRAD_TILE) * taps
    slabs = max(1, min(-(-_WGRAD_BLOCKS // tiles), -(-rows // 256)))
    return -(-(-(-rows // slabs)) // 32) * 32


def fused_chain_bwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dout, *, g, th, eps=1e-5):
    """Backward of :func:`fused_chain`: ``(dx, dw1, dw2, dw3, ds1, db1, ds2, db2,
    ds3, db3)``, dx like x, the rest f32 sums over tiles. On CUDA tensors this
    launches K10 (recompute, then the chain backward, as a sequence of kernels:
    the tensor-core route where :func:`takes_tc` holds, else the first design)
    and folds the halo rows' du1 into dx; on CPU tensors it computes
    :func:`reference_chain_bwd`."""
    if not x.is_cuda:
        return reference_chain_bwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dout, g=g, th=th,
                                   eps=eps)
    tc = takes_tc(x.dtype, x.shape[-1], w1.shape[-1])
    grads = _backward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dout, g=g, th=th, eps=eps, tc=tc)
    fused_chain_bwd.launches += 1
    fused_chain_bwd.tc_launches += tc
    return grads


def _backward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dout, *, g, th, eps, tc):
    """One K10 launch and the halo fold: ``tc`` takes the tensor-core route
    (``nkbx_chain_bwd_gemm``; it raises where :func:`takes_tc` does not
    hold), else the first design (``nkbx_chain_bwd``). Counts nothing."""
    b, h, w, c, m, vecs = _check(x, w1, w2, w3, (s1, b1, s2, b2, s3, b3), g, th)
    if tc and not takes_tc(x.dtype, c, m):
        raise ValueError(f"bottleneck chain route: needs bf16 with C and M multiples of "
                         f"{TC_WIDTH}, got {x.dtype}, C={c}, M={m}")
    if tuple(dout.shape) != tuple(x.shape) or dout.dtype != x.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} is not x's")
    x, w1, w2, w3, dout = (_build.aligned(t) for t in (x, w1, w2, w3, dout))
    dt, dev = x.dtype, x.device
    f32 = dict(dtype=torch.float32, device=dev)
    nt = (b // g) * (h // th)
    rows, ext = b * h * w, nt * g * (th + 2) * w
    dx = torch.empty_like(x)
    dw1, dw2, dw3 = (torch.empty(s, **f32) for s in ((c, m), (3, 3, m, m), (m, c)))
    dvec = [torch.empty(k, **f32) for k in (m, m, m, m, c, c)]  # ds1 db1 ds2 db2 ds3 db3
    stats = [torch.empty(nt, k, **f32) for k in (m, m, m, m, c, c)]
    lib = _build.load("bottleneck_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tc:
        work = _scratch(chain_scratch(b, h, w, c, m, g, th, backward=True), dev)
        du1 = work["du1"]
        with torch.cuda.device(dev):
            err = lib.nkbx_chain_bwd_gemm(
                *_ptrs(x, w1, w2, w3, *vecs, dout, dx, dw1, dw2, dw3, *dvec, *stats,
                       *work.values()),
                b, h, w, c, m, g, th, *chain_slabs(b, h, w, c, m, g, th), float(eps), stream)
    else:
        u1, a1, u2, a2, u3 = _workspace(x, m, g, th)
        dy, du3 = (torch.empty(rows, c, dtype=dt, device=dev) for _ in range(2))
        da2, du2 = torch.empty(rows, m, **f32), torch.empty(rows, m, dtype=dt, device=dev)
        da1, du1 = torch.empty(ext, m, **f32), torch.empty(ext, m, dtype=dt, device=dev)
        sums = torch.empty(4, nt, max(c, m), **f32)
        slabs = (_slab_rows(rows, m, c, 1), _slab_rows(rows, m, m, 9), _slab_rows(ext, c, m, 1))
        part = torch.empty(max(-(-rows // slabs[0]) * m * c, -(-rows // slabs[1]) * 9 * m * m,
                               -(-ext // slabs[2]) * c * m), **f32)
        with torch.cuda.device(dev):
            err = lib.nkbx_chain_bwd(
                *_ptrs(x, w1, w2, w3, *vecs, dout, dx, dw1, dw2, dw3, *dvec, *stats,
                       u1, a1, u2, a2, u3, dy, du3, da2, du2, da1, du1, sums, part),
                b, h, w, c, m, g, th, *slabs, float(eps), int(dt == torch.bfloat16), stream)
    _build.check(err, "bottleneck chain backward launch")
    du1 = du1.view(nt, g, th + 2, w, m)
    dx = _fold_halos(dx, du1[:, :, 0], du1[:, :, th + 1], w1, g, th)
    return (dx, dw1, dw2, dw3, *dvec)


fused_chain_bwd.launches = 0  # K10 launches, counted by the wrapper
fused_chain_bwd.tc_launches = 0  # those on the tensor-core route


class _Chain(torch.autograd.Function):
    """K9 forward, K10 backward (or the plain versions). Saves the inputs and
    recomputes the rest, as nkbx's custom VJP does (K9's per-tile statistics
    too: kept for the backward, ResNet-50's would raise a batch-64 step's
    peak memory by about 18 MB)."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g, th, eps, plain):
        ctx.save_for_backward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
        ctx.g, ctx.th, ctx.eps, ctx.plain = g, th, eps, plain
        if plain or not x.is_cuda:
            out, stats = reference_chain(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g=g, th=th,
                                         eps=eps)
        else:
            out, stats = fused_chain_fwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g=g, th=th,
                                         eps=eps)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, dout, *_):
        saved = ctx.saved_tensors
        bwd = reference_chain_bwd if ctx.plain else fused_chain_bwd
        grads = bwd(*saved, dout.contiguous(), g=ctx.g, th=ctx.th, eps=ctx.eps)
        return (grads[0], *(gr.to(t.dtype) for gr, t in zip(grads[1:], saved[1:])),
                None, None, None, None)


def fused_chain(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, g, th, eps=1e-5):
    """One stride-1 identity bottleneck block with tile-local BN statistics.

    x (B, H, W, C); w1 (C, M), w2 (3, 3, M, M) HWIO and w3 (M, C) in x's
    dtype; the BN scale/bias pairs f32. Returns ``(out, (m1, v1, m2, v2, m3,
    v3))`` with the per-tile statistics (B/g * H/th, M|C) for the running
    statistics; they carry no gradient. Differentiable in the ten tensors.
    On CUDA tensors K9 and K10 run, unless ``NKBX_FUSED_CHAIN=0`` asks for
    the plain versions; on CPU tensors the plain versions run. Call sites
    take ``th`` from :func:`stat_band`."""
    plain = os.environ.get("NKBX_FUSED_CHAIN", "") in ("0", "false", "False")
    out, *stats = _Chain.apply(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, g, th, eps, plain)
    return out, tuple(stats)


fused_chain.launches = 0  # K9 launches, counted by fused_chain_fwd
fused_chain.tc_launches = 0  # those on the tensor-core route
