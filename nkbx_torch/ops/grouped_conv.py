"""A stride-1, pad-1 3x3 grouped convolution over NHWC: the CUDA kernel X2
and its plain PyTorch version. Counterpart of
``experiments/r3_grouped_conv_vpu.py`` (a forward-only probe of nkbx's at
resnext50_32x4d's stage shapes, not a path of its models).

The weights come in the probe's rotation order: :func:`build_wvec` turns a
grouped HWIO kernel (3, 3, gw, C) into (9·gw, C) rows with
``wvec[tap·gw + r, o] = w[ty, tx, (o % gw + r) % gw, o]``, so that
``out[o] = Σ_tap Σ_r wvec[tap·gw + r, o] · x[g·gw + (o % gw + r) % gw]``,
g = o // gw: C / gw groups, f32 accumulation, out in x's dtype.

:func:`gconv` launches ``csrc/grouped_conv.cu`` on CUDA tensors (gw a power
of two up to 32, C a multiple of 32) and computes :func:`reference_gconv`,
the probe's own formulation (gw within-group rotations x 9 taps of
elementwise f32 FMAs), on CPU tensors. ``python -m
nkbx_torch.ops.grouped_conv [--check] [--wide]`` runs the probe: per
stage, the kernel against cuDNN's grouped convolution, which is timed there
and called nowhere else.
"""

from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from nkbx_torch.core.runtime import cuda_ms, resolve_device
from nkbx_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nkbx_gconv": [_P] * 3 + [_I] * 6 + [_P],
               "nkbx_gconv_smem_bytes": [_I, _I]}
_CHUNK = 32  # channels of one block (grouped_conv.cu kCC): C a multiple, gw at most this

# resnext50_32x4d's stride-1 3x3 grouped convolutions at batch 64, 224 px
# (name, B, H = W, C, gw): 32 groups everywhere (r3_grouped_conv_vpu.py:49-54)
STAGES = [
    ("stage1", 64, 56, 128, 4),
    ("stage2", 64, 28, 256, 8),
    ("stage3", 64, 14, 512, 16),
    ("stage4", 64, 7, 1024, 32),
]
ITERS = 30


def build_wvec(w, gw):
    """(3, 3, gw, C) grouped HWIO kernel -> (9·gw, C) rotation-ordered rows,
    the probe's ``build_wvec``."""
    o = torch.arange(w.shape[-1], device=w.device)
    return torch.stack([w[ty, tx, (o % gw + r) % gw, o]
                        for ty in range(3) for tx in range(3) for r in range(gw)])


def _rotate_within_groups(x, r, gw):
    """out[..., l] = x[..., (l & ~(gw - 1)) | ((l % gw + r) % gw)]."""
    if r == 0:
        return x
    lane = torch.arange(x.shape[-1], device=x.device)
    return x[..., (lane - lane % gw) + (lane % gw + r) % gw]


def reference_gconv(x, wvec, gw):
    """Plain PyTorch version, the probe's kernel step by step: zero-pad x
    (B, H, W, C), upcast to f32, and for each within-group rotation r and
    tap (ty, tx) add ``xrot_r[ty:ty+H, tx:tx+W] * wvec[tap·gw + r]``; out in
    x's dtype."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    acc = torch.zeros(b, h, w, c, dtype=torch.float32, device=x.device)
    for r in range(gw):
        xr = _rotate_within_groups(xp, r, gw)
        for ty in range(3):
            for tx in range(3):
                acc = acc + xr[:, ty:ty + h, tx:tx + w] * wvec[(ty * 3 + tx) * gw + r].float()
    return acc.to(x.dtype)


def _check(x, wvec, gw):
    if x.dim() != 4:
        raise ValueError(f"gconv: x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if gw <= 0 or gw & (gw - 1) or c % gw:
        raise ValueError(f"gconv: gw={gw} must be a power of two that divides C={c}")
    if tuple(wvec.shape) != (9 * gw, c):
        raise ValueError(f"gconv: wvec {tuple(wvec.shape)} is not (9*gw, C) = {(9 * gw, c)}")


def gconv(x, wvec, gw):
    """The 3x3 grouped convolution of x (B, H, W, C) with groups of width
    ``gw`` and the rotation-ordered weights ``wvec`` (9·gw, C)
    (:func:`build_wvec`); out like x. On CUDA tensors this launches X2 and
    counts it on ``gconv.launches``; on CPU tensors it computes the plain
    version."""
    _check(x, wvec, gw)
    if not x.is_cuda:
        return reference_gconv(x, wvec, gw)
    return _launch(x, wvec, gw)


def _launch(x, wvec, gw):
    b, h, w, c = x.shape
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gconv kernel takes float32 or bfloat16, got {dt}")
    if wvec.dtype != dt or wvec.device != dev:
        raise TypeError(f"gconv: wvec must be {dt} on {dev}, got {wvec.dtype} on {wvec.device}")
    if c % _CHUNK or gw > _CHUNK:
        raise ValueError(f"gconv kernel needs C a multiple of {_CHUNK} and gw at most {_CHUNK}, "
                         f"got C={c}, gw={gw}")
    if x.numel() == 0:
        raise ValueError("gconv kernel needs a non-empty x")
    lib = _build.load("grouped_conv", _SIGNATURES)
    if lib.nkbx_gconv_smem_bytes(w, gw) > _build.MAX_SMEM:
        raise ValueError(f"gconv kernel: an image row of W={w} does not fit a block's shared "
                         "memory")
    x, wvec = _build.aligned(x), _build.aligned(wvec)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.nkbx_gconv(x.data_ptr(), wvec.data_ptr(), out.data_ptr(), b, h, w, c, gw,
                             int(dt == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gconv launch")
    gconv.launches += 1
    return out


gconv.launches = 0  # X2 launches, counted by _launch


# --- the probe, from the command line ------------------------------------------------


def conv2d_grouped(x, w, gw):
    """The library's grouped convolution of the same function: F.conv2d with
    C / gw groups on x's channels-last NCHW view (cuDNN on the card), w the
    (3, 3, gw, C) HWIO kernel. A yardstick: the port's X2 path never calls
    it."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(), padding=1,
                   groups=x.shape[-1] // gw)
    return out.permute(0, 2, 3, 1)


def work(b, h, c, gw, itemsize):
    """Bytes (x read once, out written once, wvec) and operations of one call."""
    return itemsize * (2 * b * h * h * c + 9 * gw * c), 2 * b * h * h * c * 9 * gw


def inputs(b, h, c, gw, dtype, device, seed=0):
    """Seeded x (B, H, H, C) and a (3, 3, gw, C) kernel scaled by 0.05, the
    probe's draws in torch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, h, h, c, generator=gen, device=device).to(dtype)
    w = (0.05 * torch.randn(3, 3, gw, c, generator=gen, device=device)).to(dtype)
    return x, w


def main(wide=False, iters=ITERS, device=None):
    """The probe's ``main``: at each stage (bf16; gw > 8 only with ``wide``),
    the kernel's and cuDNN's time a launch and their max|d|. Returns one dict
    per stage (with cuDNN's largest |output|); launches the kernel ``iters +
    2`` times a stage."""
    dev = resolve_device(device)
    print(f"{torch.cuda.get_device_name(dev)}: 3x3 grouped convolution, bf16")
    print(f"{'stage':8} {'gw':>3} {'GFLOP':>7} {'cudnn':>8} {'kernel':>8} {'vs':>6}")
    rows = []
    for name, b, h, c, gw in STAGES:
        if gw > 8 and not wide:
            continue
        x, w = inputs(b, h, c, gw, torch.bfloat16, dev)
        wvec = build_wvec(w, gw)
        lib = conv2d_grouped(x, w, gw).float()
        d = float((gconv(x, wvec, gw).float() - lib).abs().max())
        lib_ms = cuda_ms(lambda: conv2d_grouped(x, w, gw), iters)
        ms = cuda_ms(lambda: gconv(x, wvec, gw), iters)
        gflop = work(b, h, c, gw, 2)[1] / 1e9
        print(f"{name:8} {gw:3d} {gflop:7.2f} {lib_ms:7.3f}m {ms:7.3f}m {lib_ms / ms:5.2f}x  "
              f"max|d|={d:.2e}")
        rows.append(dict(stage=name, gw=gw, ms=ms, library_ms=lib_ms, max_abs_d=d,
                         library_max=float(lib.abs().max())))
    return rows


def check(device=None):
    """The probe's ``check``: gw = 4 and 8, C = 8·gw, x (2, 8, 8, C) f32,
    against the library's grouped convolution (rtol = atol = 1e-4), through
    the plain version on the CPU and the kernel on the card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    for gw in (4, 8):
        c = 8 * gw
        x = torch.randn(2, 8, 8, c, generator=gen)
        w = 0.1 * torch.randn(3, 3, gw, c, generator=gen)
        ref = conv2d_grouped(x, w, gw)
        for where, t in (("cpu, plain", x), (f"{dev}, kernel", x.to(dev))):
            got = gconv(t, build_wvec(w.to(t.device), gw), gw).cpu()
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            print(f"gw={gw} {where}: check ok (max |d| = {float((got - ref).abs().max()):.2e})")


if __name__ == "__main__":
    check() if "--check" in sys.argv else main(wide="--wide" in sys.argv)
