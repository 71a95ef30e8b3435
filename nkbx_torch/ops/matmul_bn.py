"""A 1x1 convolution with the BatchNorm-apply + relu epilogue and the output's
statistics: the CUDA kernel X1 and its plain PyTorch version. Counterpart of
``experiments/pallas_fused_matmul_bn.py`` (a forward-only probe of nkbx's,
not a path of its models).

``y = relu((x @ w) * scale + bias)`` over x (N, Cin), with the per-channel
f32 ``sum`` and ``sumsq`` of the f32 y taken before y is rounded to x's
dtype: the next BatchNorm's inputs without a second pass over y.

:func:`fused_matmul_bn_relu_stats` launches ``csrc/matmul_bn.cu`` on CUDA
tensors and computes :func:`reference_matmul_bn_relu_stats` on CPU tensors.
Where :func:`takes_wgmma` holds (bf16, Cin and Cout multiples of 64, Cin at
most 512: every probe shape and ResNet's 1x1 convolutions up to 512 input
channels) it takes the route on ``wgmma`` and TMA (``nkbx_matmul_bn_wgmma``);
f32 and other widths take the first design (``nkbx_matmul_bn``), which
:func:`first_design` also reaches in bf16. The column sums run in a fixed
order, so two runs on one card agree bit for bit. ``python -m
nkbx_torch.ops.matmul_bn [--check]`` runs the probe.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys

import torch

from nkbx_torch.core.runtime import cold_ms, resolve_device
from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_matmul_bn": [_P] * 9 + [_I] * 4 + [_P],
               "nkbx_matmul_bn_wgmma": [_P] * 9 + [_I] * 3 + [_P]}
_TILE_ROWS = {torch.bfloat16: 128, torch.float32: 64}  # rows of one block (matmul_bn.cu)
_GRID = 16  # on the card Cin and Cout are multiples of this
ROUTE_WIDTH = 64  # the route's Cin and Cout are multiples of this (one swizzled row of bf16)
ROUTE_MAX_CIN = 512  # w's (Cin, 128) slice stays in shared memory

# the probe's shapes (its docstring, experiments/pallas_fused_matmul_bn.py:11-13):
# (N, C) with Cin = Cout = C, bf16: ResNet-50 activations at batch 64
SHAPES = [(200_704, 256), (50_176, 512), (802_816, 128)]


@contextlib.contextmanager
def _full_f32():
    """f32 products without TF32 (the plain version's contract)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def reference_matmul_bn_relu_stats(x, w, scale, bias):
    """Plain PyTorch version, the twin of the probe's
    ``reference_matmul_bn_relu_stats``: ``(y, sum, sumsq)``, the product in
    f32 (TF32 off), y in x's dtype, the sums of the f32 y in f32."""
    with _full_f32():
        u = x.float() @ w.float()
    y = torch.relu(u * scale.float() + bias.float())
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


def _check(x, w, scale, bias, tile_rows):
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"matmul_bn: x (N, Cin) and w (Cin, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    n, cout = x.shape[0], w.shape[1]
    if tile_rows <= 0 or n % tile_rows:
        raise ValueError(f"matmul_bn: N={n} is not a multiple of tile_rows={tile_rows}")
    if scale.numel() != cout or bias.numel() != cout:
        raise ValueError(f"matmul_bn: scale and bias must hold Cout={cout} values")


def takes_wgmma(n: int, cin: int, cout: int, dtype) -> bool:
    """Whether X1 takes the route on ``wgmma`` and TMA: bf16, Cin and Cout
    multiples of 64 and Cin at most 512 (w's slice stays in shared memory),
    at least one row."""
    return (dtype == torch.bfloat16 and n > 0 and cin % ROUTE_WIDTH == 0
            and cout % ROUTE_WIDTH == 0 and 0 < cin <= ROUTE_MAX_CIN and cout > 0)


def fused_matmul_bn_relu_stats(x, w, scale, bias, tile_rows: int = 1024):
    """``(y, sum, sumsq)``: y = relu((x @ w) * scale + bias) in x's dtype, and
    the per-channel f32 sum and sum of squares of the f32 y.

    x (N, Cin) and w (Cin, Cout) in float32 or bfloat16; scale and bias
    (Cout,), cast to f32. N must be a multiple of ``tile_rows`` (the
    probe's contract; the kernel tiles rows its own way). On CUDA tensors
    this launches X1 (Cin and Cout multiples of 16) and counts it on
    ``fused_matmul_bn_relu_stats.launches``, and those on the route
    (:func:`takes_wgmma`) also on ``.wgmma_launches``; on CPU tensors it
    computes the plain version."""
    _check(x, w, scale, bias, tile_rows)
    if not x.is_cuda:
        return reference_matmul_bn_relu_stats(x, w, scale, bias)
    return _launch(x, w, scale, bias, takes_wgmma(x.shape[0], x.shape[1], w.shape[1], x.dtype))


def first_design(x, w, scale, bias):
    """X1's first design (``nkbx_matmul_bn``: WMMA in bf16, FMAs in f32) on
    CUDA tensors at any width it takes, off the route; counted on
    ``fused_matmul_bn_relu_stats.launches``. For the card tests and timing."""
    if not x.is_cuda:
        raise ValueError("matmul_bn first_design launches the kernel: it takes CUDA tensors")
    _check(x, w, scale, bias, 1)
    return _launch(x, w, scale, bias, False)


def _launch(x, w, scale, bias, wgmma):
    (n, cin), cout = x.shape, w.shape[1]
    dt, dev = x.dtype, x.device
    if dt not in _TILE_ROWS:
        raise TypeError(f"matmul_bn kernel takes float32 or bfloat16, got {dt}")
    if w.dtype != dt or w.device != dev:
        raise TypeError(f"matmul_bn: w must be {dt} on {dev}, got {w.dtype} on {w.device}")
    if scale.device != dev or bias.device != dev:
        raise TypeError(f"matmul_bn: scale and bias must lie on {dev}")
    if cin % _GRID or cout % _GRID:
        raise ValueError(f"matmul_bn kernel needs Cin and Cout multiples of {_GRID}, got "
                         f"Cin={cin}, Cout={cout}")
    if n == 0:
        raise ValueError("matmul_bn kernel needs at least one row")
    x, w = (_build.aligned(t) for t in (x, w))
    scale, bias = (t.to(torch.float32).contiguous() for t in (scale, bias))
    f32 = dict(dtype=torch.float32, device=dev)
    tiles = -(-n // _TILE_ROWS[dt])
    y = torch.empty(n, cout, dtype=dt, device=dev)
    s, q = torch.empty(cout, **f32), torch.empty(cout, **f32)
    part = torch.empty(2, tiles, cout, **f32)
    lib = _build.load("matmul_bn", _SIGNATURES)
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            s.data_ptr(), q.data_ptr(), part[0].data_ptr(), part[1].data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if wgmma:  # part holds ceil(n / 128) rows, at least the route's groups
            err = lib.nkbx_matmul_bn_wgmma(*ptrs, n, cin, cout, stream)
        else:
            err = lib.nkbx_matmul_bn(*ptrs, n, cin, cout, int(dt == torch.bfloat16), stream)
    _build.check(err, "matmul_bn launch")
    fused_matmul_bn_relu_stats.launches += 1
    fused_matmul_bn_relu_stats.wgmma_launches += int(wgmma)
    return y, s, q


fused_matmul_bn_relu_stats.launches = 0  # X1 launches, counted by _launch
fused_matmul_bn_relu_stats.wgmma_launches = 0  # those on the route


# --- the probe, from the command line ------------------------------------------------


def work(n, cin, cout, itemsize):
    """Bytes (x and w read once, y written once, the four f32 vectors) and
    operations (the product) of one call."""
    return itemsize * (n * cin + cin * cout + n * cout) + 4 * 4 * cout, 2 * n * cin * cout


def inputs(n, cin, cout, dtype, device, seed=0):
    """Seeded x, w (scaled by Cin^-1/2), scale in [0.5, 2) and bias."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return (rn(n, cin).to(dtype), (rn(cin, cout) * cin ** -0.5).to(dtype),
            0.5 + 1.5 * torch.rand(cout, generator=gen, device=device), 0.1 * rn(cout))


def main(iters=20, device=None):
    """At each of the probe's shapes (bf16, the route where
    :func:`takes_wgmma` holds): the kernel's time a launch with a cold L2 and
    its distance from the plain version (y in bf16 ulps of its largest
    value, the sums relative). Returns one dict per shape; launches the
    kernel ``iters + 2`` times a shape."""
    dev = resolve_device(device)
    rows = []
    print(f"{torch.cuda.get_device_name(dev)}: matmul + BN-apply + relu + statistics, bf16")
    print(f"{'N':>8} {'C':>5} {'kernel ms':>10} {'y ulps':>7} {'sums rel':>9}")
    for n, c in SHAPES:
        args = inputs(n, c, c, torch.bfloat16, dev)
        y, s, q = fused_matmul_bn_relu_stats(*args)
        py, ps, pq = reference_matmul_bn_relu_stats(*args)
        ulp = 2.0 ** (torch.floor(torch.log2(py.float().abs().max())) - 7)
        y_ulps = float((y.float() - py.float()).abs().max() / ulp)
        sums_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in ((s, ps), (q, pq)))
        ms = cold_ms(lambda: fused_matmul_bn_relu_stats(*args), iters)
        print(f"{n:8d} {c:5d} {ms:10.4f} {y_ulps:7.2f} {sums_rel:9.2e}")
        rows.append(dict(n=n, c=c, ms=ms, y_ulps=y_ulps, sums_rel=sums_rel))
    return rows


def check(device=None):
    """The probe's test cases (tests/test_experiments_pallas.py): f32 (2048,
    128 -> 256) and an all-negative input through the relu, through the plain
    version on the CPU and the kernel on the card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2048, 128, generator=gen), 0.05 * torch.randn(128, 256, generator=gen)
    scale, bias = 0.5 + 1.5 * torch.rand(256, generator=gen), torch.randn(256, generator=gen)
    want = fused_matmul_bn_relu_stats(x, w, scale, bias, tile_rows=512)
    got = fused_matmul_bn_relu_stats(*(t.to(dev) for t in (x, w, scale, bias)), tile_rows=512)
    for name, a, b, tol in zip(("y", "sum", "sumsq"), got, want, (1e-3, 1e-5, 1e-5)):
        err = float((a.cpu() - b).abs().max() / (1.0 if name == "y" else b.abs().max()))
        print(f"f32 (2048, 128 -> 256) {name}: {err:.2e} (tol {tol:.0e})")
        if err > tol:
            raise AssertionError(f"matmul_bn {name} disagrees with the plain version")
    neg = torch.full((512, 128), -1.0, device=dev)
    y, s, _ = fused_matmul_bn_relu_stats(neg, torch.eye(128, device=dev),
                                         torch.ones(128, device=dev),
                                         torch.zeros(128, device=dev), tile_rows=512)
    if float(y.max()) != 0.0 or float(s.max()) != 0.0:
        raise AssertionError("matmul_bn: the relu did not zero a negative product")
    print("relu check ok")


if __name__ == "__main__":
    check() if "--check" in sys.argv else main()
