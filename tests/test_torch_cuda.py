"""The port's kernels on a CUDA card, against their plain PyTorch versions.

This file imports neither JAX nor nkbx, so it runs where the card is and
JAX is not. tests/conftest.py imports JAX, so on such a machine run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test marked ``cuda`` skips with a reason where there is no card
(chip_smoke.py is the fuller check on the card). Each wrapper's launch count
shows that the kernel, not its plain version, ran:

- K1 window attention and K2 its backward, in the three mask regimes of
  tests/test_torch_attention.py, a head-broadcast bias and window 12 (N=144);
  K1's and K2's routes (bf16 at D = 32 and N <= 144 on their tensor-core
  designs, f32 on their first designs) at Swin-T's four stage geometries,
  window 12, ragged N = 16, 17, 48, 63, 64, 65 with a shared and a per-head
  bias, and a G that their windows-per-block counts do not divide (K1's
  with two masks whose boundary falls inside a run), two launches
  bit-identical;
- K5 LN -> MLP and K6 its backward, with a ragged tile, a layer-scale,
  Swin-T's widest width and a width off the tensor-core grid; their GEMM
  route (bf16 at C % 32 == 0, F % 64 == 0) at R = 1, 49, 127, 129 and 1000
  and C = 96, 192, 384 and 768, with and without a layer-scale, by count,
  two launches bit-identical; f32 and C = 40 off the route, by count;
- K7 the MLP alone and K8 its backward at the same shapes (ConvNeXt-T's
  widths 96, 192 and 768, ragged last tiles, and C = 40 off the
  tensor-core grid); their GEMM route (bf16 at the same widths) at R = 1,
  49, 129, 1576 and 4000 and C = 96 and 768, by count, two launches
  bit-identical; f32 and C = 40 off it, by count;
- K3 full-sequence attention on separate q, k, v and K4 its backward, at
  the ViT sequences N = 50, 145, 197 and 577 (D = 64), with a (1, N, N) and an
  (H, N, N) bias, masks of M = 2 and 3, and K4 with and without dbias; K3
  also at N = 1, 17, 63, 64, 65, 197 and 577 and K4 at N = 1, 17, 63, 64,
  65 and 197 with None for an absent bias or mask (K4's tensor-core pair in
  bf16), two launches bit-identical; both at the unicom ViTs' N = 196, 49
  and 256 (16 heads) with None, each relaunch bit-identical;
- K5 and K6 at unicom's LayerNorm eps 1e-5 on rows where eps moves the
  output (the GEMM route at C = 768 and ViT-L/14's 1024, the first design in
  f32), against the plain version at 1e-5 and away from it at 1e-6;
- K9 the fused bottleneck chain and K10 its backward, banded (th = 4, 7, 2,
  widths 8 and 14) and single-band (th = H), against the plain chain: the
  output, the six per-tile statistics and the ten gradients; a width the
  kernels do not take raises; their tensor-core route (bf16 at C and M
  multiples of 32) at ragged bands (th = 5 and 2 of 10 rows, M = 96) and a
  single band at C = 96, by count, held to chip_smoke.py's limits (each
  gradient by its relative L2), two launches bit-identical; f32 on the first
  design bit for bit, and the first design still reachable in bf16;
- X1 the matmul with the BatchNorm-apply + relu epilogue and the output's
  statistics, at small shapes (ragged row and column tiles) and one probe
  shape, its sums bit for bit the same in two runs; its bf16 route on wgmma
  + TMA at ragged N and Cin != Cout (64- and 128-wide column tiles, Cin up to
  512), taken by count, a relaunch bit-identical; the first design reachable
  in bf16 through its C entry; the route's entry refusing other widths; X2 the 3x3 grouped
  convolution at the probe's check shapes, ragged widths, gw = 1 and 32 and
  resnext50's stage 2, and at every group width 1-32 with H and W of 7, 13
  and 57 and C from 32 to 1024, two launches bit-identical; both wrappers
  refuse a wrong dtype, shape or device;
- X3-X7, the Swin layout probes (copy, transpose, window gather and
  scatter, merge, split and pad8), at small, ragged, odd and unaligned
  shapes and one probe shape each, equal bit for bit to their plain
  versions, each a fresh tensor; the copy equal to clone at every vector
  width it takes (the bulk ring from 32 MiB with a one-vector last chunk
  and more chunks than its stages, odd counts and offset views, small and
  large); a wrong dtype is refused;
- the collectives of data parallelism (nkbx_torch.parallel.collectives), and
  a scattered ViT-B state's gather and scatter (nkbx_torch.parallel.fsdp)
  on two gloo ranks sharing cuda:0, the BatchNorm sum's backward included;
- the singletask config's device stage (flips, brightness/contrast, HSV,
  coarse dropout, Normalize) on a CUDA batch against the CPU with the same
  draws (1e-3 on the 0-255 scale), and its own draws from a CUDA generator;
- RandAugment and TrivialAugmentWide at ragged sizes, round by round, and
  mixup/CutMix in f32 and bf16, on a CUDA batch against the CPU with the
  same draws, each second run bit-identical; the EMA update on the card
  equal to the CPU's;
- one epoch of the config-driven trainer (``nkbx_torch.train.train``) on a
  tiny Swin through K1, K2, K5 and K6 over an ImageFolder of BMP files,
  with finite metrics, a checkpoint and the launch counts of its steps;
- each forward kernel's registered op (``nkbx_torch::window_attention``,
  ``::attention``, ``::ln_mlp``, ``::mlp``) bit-identical to its launcher
  at a ragged bf16 shape, counted; a tiny bf16 Swin, ViT and ConvNeXt
  exported with ``fused_attention=True`` on the card, reloaded and served
  through the kernels (counted, 2 bf16 ulps of the eager model's largest
  logit); a portable bundle that launches none of them;
- ``remat_stages`` on a tiny bf16 ConvNeXt (K5/K6) and a tiny fused ghost-BN
  ResNet (K9/K10) at ragged batches, bit-equal to the run without it
  (logits, gradients, running statistics; K5 or K9 launched twice); ResNet's
  ``input_norm`` on the card against the CPU;
- a tiny Swin's, a tiny ViT's, a tiny ConvNeXt's and a tiny fused ResNet's
  loss backward through the kernels (the ConvNeXt through K5/K6, and through
  K7/K8 under ``NKBX_FUSED_LN_MLP=0``) gives every parameter a finite,
  non-zero gradient (the autograd graph is not cut).

Tolerances, absolute: K1 f32 1e-4, bf16 3e-2 (P and the output round to
bf16; a last-bit difference flips one rounding of values of order 1). K2
dqkv f32 1e-4, bf16 6e-2 (dS*scale rounds to bf16 too); dbias 1e-4 of its
largest value. K5 f32 5e-4, bf16 1.25e-1 (outputs reach 8, where one bf16
ulp is 3.1e-2). K6, relative to each gradient's largest value: f32 1e-3,
bf16 3e-2. The GEMM route's tests: K5 bf16 4 bf16 ulps of the largest
value, K6 bf16 2e-2 of each gradient's largest, f32 5e-4. K3 as K1; at
ragged N f32 1e-4, bf16 2 bf16 ulps of the largest output. K1's route
tests: 2 bf16 ulps of the largest output (f32 1e-4). K2's route tests: dqkv
within 4 bf16 ulps of its largest value (f32 1e-4 of it), dbias 1e-4 of its
largest. K4, relative to each gradient's largest value: f32
1e-4, bf16 4 bf16 ulps (P, dS*scale and the outputs round to bf16; at
ragged N 4 ulps of the largest of dq, dk, dv); dbias 1e-4 of its largest
value. K7 f32 5e-4, bf16 6.25e-2 (the plain version
rounds u to bf16 before the GELU and adds b1 to a rounded product; the
outputs stay under 4, where one bf16 ulp is 1.6e-2), on either route. K8 as
K6, on either route. K9's
output: f32 5e-4, bf16 4 bf16 ulps of its largest value (a1, a2, y3 and the
residual sum round to bf16); K9's statistics and K10's gradients, relative
to each one's largest value: f32 5e-4, bf16 2e-2 (elementwise holds for the
first design at these small shapes; at ResNet-50's, relu gates within
rounding noise of 0 flip between the two programs, and chip_smoke.py holds
the gradients by their relative L2 error). On the tensor-core route (bf16
at C and M multiples of 32) each gradient is held by its relative L2 error,
2e-2, the route's criterion: it sums in another order than the first
design, and at (B, H, C, M, th) = (2, 14, 128, 64, 2) three of the
output's relu gates flip, which moves those elements of dx by their whole
size (0.15 of dx's largest value) while every gradient's relative L2 stays
under 7e-3. X1: y f32 2e-5 of its largest value, bf16 one bf16 ulp
of each value plus 2^-16 of the largest (the f32 products differ in the
order of their sums, so a rounding may fall to the other neighbour, and
near 0 that noise is coarser than a bf16 ulp); the sums 1e-4 of their
largest value. X2: f32 1e-5 of its largest value, bf16 as X1's y.
"""

import math
import pathlib
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from nkbx_torch.ops import attention as tattn
from nkbx_torch.ops import bottleneck as tbn
from nkbx_torch.ops import grouped_conv as tgc
from nkbx_torch.ops import layout as tlayout
from nkbx_torch.ops import matmul_bn as tmb
from nkbx_torch.ops import mlp as tmlp

ROOT = pathlib.Path(__file__).resolve().parents[1]

ATTN_CASES = [
    # (G, N, heads, d, M, bias heads): M=1 broadcast; W%M==0; W<M
    (8, 9, 2, 8, 1, 2),
    (8, 9, 2, 8, 4, 2),
    (64, 5, 1, 8, 64, 1),
    (6, 13, 3, 4, 3, 1),  # a (1, N, N) bias shared by the heads
    (8, 49, 3, 32, 4, 3),  # Swin-T stage-1 head geometry
    (16, 144, 4, 32, 4, 4),  # window 12
]

MLP_CASES = [(1000, 96, 384, True), (49, 768, 3072, False), (300, 192, 768, False),
             (100, 40, 160, True)]
MLP_ONLY_CASES = [(r, c, f) for r, c, f, _ in MLP_CASES]

SEP_CASES = [
    # (G, N, heads, M, bias heads); D = 64
    (4, 50, 2, 1, 1),  # ViT patch 32 at 224 px
    (2, 145, 2, 1, 1),  # patch 32 at 384 px
    (2, 197, 3, 1, 1),  # patch 16 at 224 px, the zeros-shaped shared bias
    (2, 197, 2, 2, 2),  # a learned (H, N, N) bias and a mask of M = 2
    (1, 577, 2, 1, 1),  # patch 16 at 384 px
    (3, 17, 1, 3, 1),  # a mask per group
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(g, n, heads, d, m, bh, device, dtype):
    rng = np.random.RandomState(0)
    hd = heads * d
    qkv = rng.randn(g, n, 3 * hd).astype(np.float32)
    bias = (rng.randn(bh, n, n) * 0.1).astype(np.float32)
    mask = np.where(rng.rand(m, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    go = rng.randn(g, n, hd).astype(np.float32)
    qkv, bias, mask, go = (torch.from_numpy(v).to(device) for v in (qkv, bias, mask, go))
    return qkv.to(dtype), bias, mask, go.to(dtype)


_MLP_KEYS = ("x", "s", "b", "w0", "b0", "w1", "b1")


def _mlp_inputs(r, c, f, gamma, device, dtype, seed):
    """(x, s, b, w0, b0, w1, b1), shortcut, gamma or None, dy; x, w0, w1,
    shortcut and dy in ``dtype``, the vectors in f32."""
    rng = np.random.RandomState(seed)
    a = dict(
        x=rng.randn(r, c), s=1 + 0.1 * rng.randn(c), b=0.1 * rng.randn(c),
        w0=rng.randn(c, f) / np.sqrt(c), b0=0.1 * rng.randn(f),
        w1=rng.randn(f, c) / np.sqrt(f), b1=0.1 * rng.randn(c), sc=rng.randn(r, c),
        gamma=(1 + 0.1 * rng.randn(c)) if gamma else None, dy=rng.randn(r, c))
    t = {k: None if v is None else torch.from_numpy(v.astype(np.float32)).to(device)
         for k, v in a.items()}
    for k in ("x", "w0", "w1", "sc", "dy"):
        t[k] = t[k].to(dtype)
    return [t[k] for k in _MLP_KEYS], t["sc"], t["gamma"], t["dy"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("g,n,heads,d,m,bh", ATTN_CASES)
def test_attention_kernel_matches_reference_on_card(cuda_device, dtype, tol, g, n, heads, d, m,
                                                    bh):
    qkv, bias, mask, _ = _attn_inputs(g, n, heads, d, m, bh, cuda_device, dtype)
    hd, scale = heads * d, d ** -0.5
    before = tattn.fused_attention_qkv.launches
    got = tattn.fused_attention_qkv(qkv, bias, mask, scale, heads)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv.launches == before + 1
    want = tattn.reference_attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                                     bias, mask, scale, heads)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("g,n,heads,d,m,bh", ATTN_CASES)
def test_attention_bwd_kernel_matches_plain_on_card(cuda_device, dtype, tol, g, n, heads, d,
                                                    m, bh):
    qkv, bias, mask, go = _attn_inputs(g, n, heads, d, m, bh, cuda_device, dtype)
    before = tattn.fused_attention_qkv_bwd.launches
    dqkv, dbias = tattn.fused_attention_qkv_bwd(qkv, bias, mask, go, d ** -0.5, heads)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv_bwd.launches == before + 1
    want_dqkv, want_dbias = tattn.reference_attention_bwd(qkv, bias, mask, go, d ** -0.5, heads)
    assert dqkv.dtype == qkv.dtype and dbias.dtype == torch.float32
    assert (dqkv.float() - want_dqkv.float()).abs().max().item() <= tol
    assert ((dbias - want_dbias).abs().max() <= 1e-4 * want_dbias.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 1.25e-1)])
@pytest.mark.parametrize("r,c,f,gamma", MLP_CASES)
def test_ln_mlp_kernel_matches_reference_on_card(cuda_device, dtype, tol, r, c, f, gamma):
    args, sc, gm, _ = _mlp_inputs(r, c, f, gamma, cuda_device, dtype, seed=4)
    before = tmlp.fused_ln_mlp.launches
    got = tmlp.fused_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    torch.cuda.synchronize()
    assert tmlp.fused_ln_mlp.launches == before + 1
    want = tmlp.reference_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,f,gamma", MLP_CASES)
def test_ln_mlp_bwd_kernel_matches_plain_on_card(cuda_device, dtype, r, c, f, gamma):
    args, _, gm, dy = _mlp_inputs(r, c, f, gamma, cuda_device, dtype, seed=5)
    before = tmlp.fused_ln_mlp_bwd.launches
    got = tmlp.fused_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert tmlp.fused_ln_mlp_bwd.launches == before + 1
    want = tmlp.reference_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    assert (got[7] is None) is (want[7] is None) is (not gamma)
    for gv, wv in zip(got, want):
        if wv is None:
            continue
        assert gv.dtype == wv.dtype
        assert ((gv.float() - wv.float()).abs().max() <= tol * wv.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 6.25e-2)])
@pytest.mark.parametrize("r,c,f", MLP_ONLY_CASES)
def test_mlp_kernel_matches_reference_on_card(cuda_device, dtype, tol, r, c, f):
    args, _, _, _ = _mlp_inputs(r, c, f, False, cuda_device, dtype, seed=6)
    x, _, _, w0, b0, w1, b1 = args
    before = tmlp.fused_mlp.launches
    got = tmlp.fused_mlp(x, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert tmlp.fused_mlp.launches == before + 1
    want = tmlp.reference_mlp(x, w0, b0, w1, b1)
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,f", MLP_ONLY_CASES)
def test_mlp_bwd_kernel_matches_plain_on_card(cuda_device, dtype, r, c, f):
    args, _, _, dy = _mlp_inputs(r, c, f, False, cuda_device, dtype, seed=7)
    x, _, _, w0, b0, w1, b1 = args
    before = tmlp.fused_mlp_bwd.launches
    got = tmlp.fused_mlp_bwd(x, w0, b0, w1, b1, dy)
    torch.cuda.synchronize()
    assert tmlp.fused_mlp_bwd.launches == before + 1
    want = tmlp.reference_mlp_bwd(x, w0, b0, w1, b1, dy)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for gv, wv in zip(got, want):
        assert gv.dtype == wv.dtype and gv.shape == wv.shape
        assert ((gv.float() - wv.float()).abs().max() <= tol * wv.float().abs().max()).item()


GEMM_ROWS = (1, 49, 127, 129, 1000)  # around the 128-row block tile, and a ragged many
GEMM_WIDTHS = (96, 192, 384, 768)  # Swin-T's, ConvNeXt-T's and ViT-B's C (F = 4C)


def _bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2 ** -20))) - 7)


def _max_rel(got, want):
    """The largest difference of each gradient over its largest value."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want) if w is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("c", GEMM_WIDTHS)
@pytest.mark.parametrize("r", GEMM_ROWS)
def test_ln_mlp_gemm_route_matches_plain_on_card(cuda_device, r, c, gamma):
    args, sc, gm, _ = _mlp_inputs(r, c, 4 * c, gamma, cuda_device, torch.bfloat16, seed=8)
    before = tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches
    got = tmlp.fused_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    again = tmlp.fused_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    torch.cuda.synchronize()
    assert (tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches) == (
        before[0] + 2, before[1] + 2)
    want = tmlp.reference_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 4 * _bf16_ulp(want.float().abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("c", GEMM_WIDTHS)
@pytest.mark.parametrize("r", GEMM_ROWS)
def test_ln_mlp_bwd_gemm_route_matches_plain_on_card(cuda_device, r, c, gamma):
    args, _, gm, dy = _mlp_inputs(r, c, 4 * c, gamma, cuda_device, torch.bfloat16, seed=9)
    before = tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches
    got = tmlp.fused_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    again = tmlp.fused_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert (tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches) == (
        before[0] + 2, before[1] + 2)
    want = tmlp.reference_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    assert (got[7] is None) is (want[7] is None) is (not gamma)
    assert all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want)
               if w is not None)
    assert _max_rel(got, want) <= 2e-2
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [(torch.float32, 96), (torch.float32, 768),
                                     (torch.bfloat16, 40)])
def test_ln_mlp_keeps_its_first_design_off_the_gemm_route(cuda_device, dtype, c):
    """f32, and bf16 off the tensor-core grid, run the first design: one
    launch each, none on the GEMM route."""
    args, sc, gm, dy = _mlp_inputs(129, c, 4 * c, True, cuda_device, dtype, seed=10)
    before = (tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches,
              tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches)
    got = tmlp.fused_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    grads = tmlp.fused_ln_mlp_bwd(*args, gm, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert (tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches,
            tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3])
    want = tmlp.reference_ln_mlp(*args, sc, gamma=gm, eps=1e-5)
    err = (got.float() - want.float()).abs().max().item()
    f32 = dtype == torch.float32
    assert err <= (5e-4 if f32 else 4 * _bf16_ulp(want.float().abs().max().item()))
    assert _max_rel(grads, tmlp.reference_ln_mlp_bwd(*args, gm, dy, eps=1e-5)) <= (
        5e-4 if f32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,gemm", [(torch.bfloat16, 96, True), (torch.bfloat16, 768, True),
                                          (torch.float32, 96, False), (torch.bfloat16, 40, False)])
def test_mlp_only_kernels_stay_off_the_gemm_route(cuda_device, dtype, c, gemm):
    """K7 and K8 (the MLP alone) stay off their GEMM route only off the
    tensor-core grid (f32, C = 40: the first design); bf16 at C = 96 and 768
    takes it. One launch each, by count; K5's and K6's counts do not move."""
    args, _, _, dy = _mlp_inputs(129, c, 4 * c, False, cuda_device, dtype, seed=11)
    x, _, _, w0, b0, w1, b1 = args
    fns = (tmlp.fused_mlp, tmlp.fused_mlp_bwd, tmlp.fused_ln_mlp, tmlp.fused_ln_mlp_bwd)
    before = [(fn.launches, fn.gemm_launches) for fn in fns]
    got = tmlp.fused_mlp(x, w0, b0, w1, b1)
    grads = tmlp.fused_mlp_bwd(x, w0, b0, w1, b1, dy)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.gemm_launches) for fn in fns] == [
        (before[0][0] + 1, before[0][1] + gemm), (before[1][0] + 1, before[1][1] + gemm),
        before[2], before[3]]
    f32 = dtype == torch.float32
    want = tmlp.reference_mlp(x, w0, b0, w1, b1)
    assert (got.float() - want.float()).abs().max().item() <= (5e-4 if f32 else 6.25e-2)
    assert _max_rel(grads, tmlp.reference_mlp_bwd(x, w0, b0, w1, b1, dy)) <= (
        1e-3 if f32 else 3e-2)


MLP_GEMM_ROWS = (1, 49, 129, 1576, 4000)  # ragged 128-row tiles, ViT-B's bucket 8 (F split
# into slabs at C = 768), and rows split into slabs for the weight gradients
MLP_GEMM_WIDTHS = (96, 768)  # ConvNeXt-T's first and last stage, ViT-B's


@pytest.mark.cuda
@pytest.mark.parametrize("c", MLP_GEMM_WIDTHS)
@pytest.mark.parametrize("r", MLP_GEMM_ROWS)
def test_mlp_gemm_route_matches_plain_on_card(cuda_device, r, c):
    args, _, _, _ = _mlp_inputs(r, c, 4 * c, False, cuda_device, torch.bfloat16, seed=12)
    x, _, _, w0, b0, w1, b1 = args
    before = tmlp.fused_mlp.launches, tmlp.fused_mlp.gemm_launches
    got = tmlp.fused_mlp(x, w0, b0, w1, b1)
    again = tmlp.fused_mlp(x, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert (tmlp.fused_mlp.launches, tmlp.fused_mlp.gemm_launches) == (before[0] + 2,
                                                                        before[1] + 2)
    want = tmlp.reference_mlp(x, w0, b0, w1, b1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 6.25e-2
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("c", MLP_GEMM_WIDTHS)
@pytest.mark.parametrize("r", MLP_GEMM_ROWS)
def test_mlp_bwd_gemm_route_matches_plain_on_card(cuda_device, r, c):
    args, _, _, dy = _mlp_inputs(r, c, 4 * c, False, cuda_device, torch.bfloat16, seed=13)
    x, _, _, w0, b0, w1, b1 = args
    before = tmlp.fused_mlp_bwd.launches, tmlp.fused_mlp_bwd.gemm_launches
    got = tmlp.fused_mlp_bwd(x, w0, b0, w1, b1, dy)
    again = tmlp.fused_mlp_bwd(x, w0, b0, w1, b1, dy)
    torch.cuda.synchronize()
    assert (tmlp.fused_mlp_bwd.launches, tmlp.fused_mlp_bwd.gemm_launches) == (
        before[0] + 2, before[1] + 2)
    want = tmlp.reference_mlp_bwd(x, w0, b0, w1, b1, dy)
    assert all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
    assert _max_rel(got, want) <= 3e-2
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def _sep_inputs(g, n, heads, m, bh, device, dtype):
    rng = np.random.RandomState(1)
    q, k, v, go = (rng.randn(g, n, heads * 64).astype(np.float32) for _ in range(4))
    bias = (rng.randn(bh, n, n) * 0.1).astype(np.float32)
    mask = np.where(rng.rand(m, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    q, k, v, go, bias, mask = (torch.from_numpy(t).to(device) for t in (q, k, v, go, bias, mask))
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, mask, go.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("g,n,heads,m,bh", SEP_CASES)
def test_sep_attention_kernel_matches_plain_on_card(cuda_device, dtype, tol, g, n, heads, m, bh):
    q, k, v, bias, mask, _ = _sep_inputs(g, n, heads, m, bh, cuda_device, dtype)
    before = tattn.fused_attention.launches
    got = tattn.fused_attention(q, k, v, bias, mask, 0.125, heads)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 1
    want = tattn.reference_attention(q, k, v, bias, mask, 0.125, heads)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


# the streaming K3 at ragged N: (bias heads, M) or None for an absent bias or mask
SEP_RAGGED_N = [1, 17, 63, 64, 65, 197, 577]
SEP_OPERANDS = {"shared": (1, 1), "per_head_m2": (2, 2), "none": (None, None),
                "bias_no_mask": (2, None), "mask_no_bias": (None, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operands", list(SEP_OPERANDS))
@pytest.mark.parametrize("n", SEP_RAGGED_N)
def test_sep_attention_kernel_at_ragged_n(cuda_device, dtype, operands, n):
    """K3 against its plain version at every ragged key count around the
    64-key tile, with a shared or per-head bias, masks of M = 1 and 2, and
    None for an absent bias or mask: bf16 within 2 bf16 ulps of the largest
    output (P and the output round to bf16), f32 1e-4; a second launch is
    bit-identical (the sums run in a fixed order)."""
    bh, m = SEP_OPERANDS[operands]
    q, k, v, bias, mask, _ = _sep_inputs(2, n, 2, m or 1, bh or 1, cuda_device, dtype)
    bias = bias if bh else None
    mask = mask if m else None
    before = tattn.fused_attention.launches
    got = tattn.fused_attention(q, k, v, bias, mask, 0.125, 2)
    again = tattn.fused_attention(q, k, v, bias, mask, 0.125, 2)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 2
    want = tattn.reference_attention(q, k, v, bias, mask, 0.125, 2)
    big = want.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,heads,m,bh", SEP_CASES)
def test_sep_attention_bwd_kernel_matches_plain_on_card(cuda_device, dtype, g, n, heads, m, bh):
    q, k, v, bias, mask, go = _sep_inputs(g, n, heads, m, bh, cuda_device, dtype)
    before = tattn.fused_attention_bwd.launches
    got = tattn.fused_attention_bwd(q, k, v, bias, mask, go, 0.125, heads)
    no_dbias = tattn.fused_attention_bwd(q, k, v, bias, mask, go, 0.125, heads,
                                         need_dbias=False)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches == before + 2
    want = tattn.reference_attention_sep_bwd(q, k, v, bias, mask, go, 0.125, heads)
    tol = 1e-4 if dtype == torch.float32 else 4 * 2.0 ** -8
    for gv, wv in zip(got[:3], want[:3]):
        assert gv.dtype == dtype
        assert ((gv.float() - wv.float()).abs().max() <= tol * wv.float().abs().max()).item()
    assert got[3].dtype == torch.float32 and got[3].shape == bias.shape
    assert ((got[3] - want[3]).abs().max() <= 1e-4 * want[3].abs().max()).item()
    assert no_dbias[3] is None
    for a, b in zip(got[:3], no_dbias[:3]):
        assert torch.equal(a, b)  # the same arithmetic, one group per block or several


# K4 at query and key counts around its 64-row tiles: (bias heads, M, need_dbias),
# None for an absent bias or mask ("none" is the ViT's path)
SEP_BWD_RAGGED_N = [1, 17, 63, 64, 65, 197]
SEP_BWD_OPERANDS = {"none": (None, None, False), "learned_no_dbias": (2, 2, False),
                    "learned_dbias": (2, 2, True), "bias_no_mask": (2, None, True),
                    "mask_no_bias": (None, 2, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operands", list(SEP_BWD_OPERANDS))
@pytest.mark.parametrize("n", SEP_BWD_RAGGED_N)
def test_sep_attention_bwd_kernel_at_ragged_n(cuda_device, dtype, operands, n):
    """K4 against its plain version at ragged N, with None for an absent bias
    or mask (no dbias then) and a learned bias and mask with and without
    dbias: dq, dk, dv within 4 bf16 ulps of the largest value (P, dS*scale
    and the outputs round to bf16) or 1e-4 of it in f32, dbias within 1e-4
    of its largest; a second launch is bit-identical and the launch count
    moves by two."""
    bh, m, need_dbias = SEP_BWD_OPERANDS[operands]
    q, k, v, bias, mask, go = _sep_inputs(2, n, 2, m or 1, bh or 1, cuda_device, dtype)
    bias = bias if bh else None
    mask = mask if m else None
    before = tattn.fused_attention_bwd.launches
    got = tattn.fused_attention_bwd(q, k, v, bias, mask, go, 0.125, 2, need_dbias=need_dbias)
    again = tattn.fused_attention_bwd(q, k, v, bias, mask, go, 0.125, 2, need_dbias=need_dbias)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches == before + 2
    want = tattn.reference_attention_sep_bwd(q, k, v, bias, mask, go, 0.125, 2)
    big = max(w.float().abs().max().item() for w in want[:3])
    tol = 1e-4 * big if dtype == torch.float32 else 4 * 2.0 ** (np.floor(np.log2(big)) - 7)
    for gv, av, wv in zip(got[:3], again[:3], want[:3]):
        assert gv.dtype == dtype and gv.shape == q.shape
        assert (gv.float() - wv.float()).abs().max().item() <= tol
        assert torch.equal(gv, av)
    if need_dbias:
        assert got[3].dtype == torch.float32 and got[3].shape == bias.shape
        assert ((got[3] - want[3]).abs().max() <= 1e-4 * want[3].abs().max()).item()
        assert torch.equal(got[3], again[3])
    else:
        assert got[3] is None


# the unicom ViTs' sequences (no class token): ViT-B/16 N = 196 and B/32 N = 49 with
# 12 heads, L/14 N = 256 with 16 heads; (G, N, heads), bias and mask None
UNICOM_SEQ = [(4, 196, 12), (4, 49, 12), (2, 256, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,heads", UNICOM_SEQ)
def test_sep_attention_at_unicom_sequences(cuda_device, dtype, g, n, heads):
    """K3 and K4 with None for the bias and the mask at the unicom ViTs'
    sequences: K3 within 2 bf16 ulps of the largest output (f32 1e-4), K4's
    dq, dk, dv within 4 bf16 ulps of the largest gradient (f32 1e-4 of it),
    each relaunch bit-identical, two launches each by count."""
    q, k, v, _, _, go = _sep_inputs(g, n, heads, 1, 1, cuda_device, dtype)
    before = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
    got = tattn.fused_attention(q, k, v, None, None, 0.125, heads)
    again = tattn.fused_attention(q, k, v, None, None, 0.125, heads)
    grads = tattn.fused_attention_bwd(q, k, v, None, None, go, 0.125, heads)
    grads_again = tattn.fused_attention_bwd(q, k, v, None, None, go, 0.125, heads)
    torch.cuda.synchronize()
    assert (tattn.fused_attention.launches, tattn.fused_attention_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    want = tattn.reference_attention(q, k, v, None, None, 0.125, heads)
    big = want.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)
    want_g = tattn.reference_attention_sep_bwd(q, k, v, None, None, go, 0.125, heads)
    big = max(w.float().abs().max().item() for w in want_g[:3])
    tol = 1e-4 * big if dtype == torch.float32 else 4 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert grads[3] is None
    for gv, av, wv in zip(grads[:3], grads_again[:3], want_g[:3]):
        assert gv.dtype == dtype and (gv.float() - wv.float()).abs().max().item() <= tol
        assert torch.equal(gv, av)


# K5/K6 where LayerNorm's eps moves the output: rows of variance ~1e-6, so eps
# 1e-5 (unicom's) and 1e-6 (the ViT's) normalise them differently; (dtype, C, rows)
EPS_CASES = [(torch.bfloat16, 768, 1568), (torch.float32, 768, 129), (torch.bfloat16, 1024, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,r", EPS_CASES)
def test_ln_mlp_takes_unicom_eps(cuda_device, dtype, c, r):
    """K5 and K6 at eps 1e-5 on rows whose variance is near eps (bf16: the
    GEMM route, at C = 768 and at unicom ViT-L/14's C = 1024 over its 2048
    rows of a batch of 8; f32: the first design): against the plain version
    at eps 1e-5 as tests above hold them, each relaunch bit-identical, while
    the plain version at eps 1e-6 is 10x farther off than the tolerance."""
    args, sc, _, dy = _mlp_inputs(r, c, 4 * c, False, cuda_device, dtype, seed=12)
    args[0] = (args[0].float() * 1e-3).to(dtype)
    gemm = dtype == torch.bfloat16
    fns = (tmlp.fused_ln_mlp, tmlp.fused_ln_mlp_bwd)
    before = [(fn.launches, fn.gemm_launches) for fn in fns]
    got = tmlp.fused_ln_mlp(*args, sc, eps=1e-5)
    again = tmlp.fused_ln_mlp(*args, sc, eps=1e-5)
    grads = tmlp.fused_ln_mlp_bwd(*args, None, dy, eps=1e-5)
    grads_again = tmlp.fused_ln_mlp_bwd(*args, None, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.gemm_launches) for fn in fns] == [
        (b[0] + 2, b[1] + 2 * gemm) for b in before]
    want = tmlp.reference_ln_mlp(*args, sc, eps=1e-5)
    other = tmlp.reference_ln_mlp(*args, sc, eps=1e-6)
    f32 = dtype == torch.float32
    tol = 5e-4 if f32 else 4 * _bf16_ulp(want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (other.float() - want.float()).abs().max().item() > 10 * tol
    assert torch.equal(got, again)
    want_g = tmlp.reference_ln_mlp_bwd(*args, None, dy, eps=1e-5)
    other_g = tmlp.reference_ln_mlp_bwd(*args, None, dy, eps=1e-6)
    tol_g = 5e-4 if f32 else 2e-2
    assert _max_rel(grads, want_g) <= tol_g
    assert _max_rel(other_g, want_g) > 10 * tol_g
    assert all(g is None or torch.equal(g, h) for g, h in zip(grads, grads_again))


TC_BWD_CASES = [
    # (G, N, heads, M, bias heads), D = 32: Swin-T's four stages (fewer windows),
    # window 12, then ragged N with a shared and a per-head bias
    (128, 49, 3, 64, 3), (32, 49, 6, 16, 6), (8, 49, 12, 4, 12), (2, 49, 24, 1, 24),
    (16, 144, 4, 4, 4), (4, 144, 4, 1, 1),
] + [(6, n, 2, 3, bh) for n in (16, 17, 48, 63, 64, 65) for bh in (1, 2)]


def _hold_window_bwd(qkv, bias, mask, go, heads, tc):
    """K2 twice against its plain version: dqkv within 4 bf16 ulps of its
    largest value (P, dS*scale and the outputs round to bf16) or 1e-4 of it
    in f32, dbias within 1e-4 of its largest; the second launch
    bit-identical; two launches, of the tensor-core design when ``tc``."""
    before = tattn.fused_attention_qkv_bwd.launches, tattn.fused_attention_qkv_bwd.tc_launches
    got = tattn.fused_attention_qkv_bwd(qkv, bias, mask, go, 32 ** -0.5, heads)
    again = tattn.fused_attention_qkv_bwd(qkv, bias, mask, go, 32 ** -0.5, heads)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv_bwd.launches == before[0] + 2
    assert tattn.fused_attention_qkv_bwd.tc_launches == before[1] + (2 if tc else 0)
    want = tattn.reference_attention_bwd(qkv, bias, mask, go, 32 ** -0.5, heads)
    big = want[0].float().abs().max().item()
    tol = 1e-4 * big if qkv.dtype == torch.float32 else 4 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert got[0].dtype == qkv.dtype and got[0].shape == qkv.shape
    assert (got[0].float() - want[0].float()).abs().max().item() <= tol
    assert got[1].dtype == torch.float32 and got[1].shape == bias.shape
    assert ((got[1] - want[1]).abs().max() <= 1e-4 * want[1].abs().max()).item()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,n,heads,m,bh", TC_BWD_CASES)
def test_window_attention_bwd_tc_matches_plain_on_card(cuda_device, dtype, g, n, heads, m, bh):
    """bf16 at D = 32 takes K2's tensor-core design, f32 its first design
    (the route by dtype and shape), each held to the plain version."""
    qkv, bias, mask, go = _attn_inputs(g, n, heads, 32, m, bh, cuda_device, dtype)
    assert tattn.takes_tc(n, 32, dtype) is (dtype == torch.bfloat16)
    _hold_window_bwd(qkv, bias, mask, go, heads, dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49, 144])
def test_window_attention_bwd_tc_at_a_ragged_run_of_windows(cuda_device, n):
    """A G that the tensor-core design's windows-per-block count does not
    divide: the last block's shorter run of windows, and its dbias partial."""
    heads = 4
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    g = 2 * max(1, sms * tattn.bwd_tc_blocks_per_sm(n) // heads) + 1
    wpb = tattn.bwd_tc_windows_per_block(g, heads, n, sms)
    g += g % wpb == 0
    assert wpb > 1 and g % wpb
    qkv, bias, mask, go = _attn_inputs(g, n, heads, 32, 1, heads, cuda_device, torch.bfloat16)
    _hold_window_bwd(qkv, bias, mask, go, heads, True)


def _hold_window_fwd(qkv, bias, mask, heads, tc):
    """K1 twice against its plain version: within 2 bf16 ulps of the largest
    output (P and the output round to bf16) or 1e-4 in f32; the second launch
    bit-identical; two launches, of the tensor-core design when ``tc``."""
    before = tattn.fused_attention_qkv.launches, tattn.fused_attention_qkv.tc_launches
    got = tattn.fused_attention_qkv(qkv, bias, mask, 32 ** -0.5, heads)
    again = tattn.fused_attention_qkv(qkv, bias, mask, 32 ** -0.5, heads)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv.launches == before[0] + 2
    assert tattn.fused_attention_qkv.tc_launches == before[1] + (2 if tc else 0)
    hd = qkv.shape[-1] // 3
    want = tattn.reference_attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                                     bias, mask, 32 ** -0.5, heads)
    big = want.float().abs().max().item()
    tol = 1e-4 if qkv.dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert got.dtype == qkv.dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,n,heads,m,bh", TC_BWD_CASES)
def test_window_attention_tc_matches_plain_on_card(cuda_device, dtype, g, n, heads, m, bh):
    """bf16 at D = 32 takes K1's tensor-core design, f32 its first design
    (the route by dtype and shape), each held to the plain version."""
    qkv, bias, mask, _ = _attn_inputs(g, n, heads, 32, m, bh, cuda_device, dtype)
    assert tattn.takes_tc(n, 32, dtype) is (dtype == torch.bfloat16)
    _hold_window_fwd(qkv, bias, mask, heads, dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49, 144])
def test_window_attention_tc_at_a_ragged_run_of_windows(cuda_device, n):
    """A G that the tensor-core design's windows-per-block count does not
    divide, and two masks whose boundary falls inside a block's run (the
    blocks take their windows in the order of the mask index)."""
    heads = 4
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    g = 2 * max(1, sms * tattn.fwd_tc_blocks_per_sm(n) // heads) + 2
    wpb = tattn.fwd_tc_windows_per_block(g, heads, n, sms)
    assert wpb > 1 and g % wpb and (g // 2) % wpb
    qkv, bias, mask, _ = _attn_inputs(g, n, heads, 32, 2, heads, cuda_device, torch.bfloat16)
    _hold_window_fwd(qkv, bias, mask, heads, True)


@pytest.mark.cuda
def test_every_parameter_gets_a_gradient_through_the_kernels(cuda_device):
    from nkbx_torch.models.classifier import SingletaskClassifier
    from nkbx_torch.models.swin import SwinTransformer
    from nkbx_torch.train import get_loss
    from nkbx_torch.transforms import Compose, Normalize

    torch.manual_seed(0)
    backbone = SwinTransformer(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2,
                               img_size=(32, 32), fused_attention=True, fused_mlp=True)
    module = SingletaskClassifier(backbone, 3).to(cuda_device).train()
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    x = Compose([Normalize()]).device_apply(images.to(cuda_device))
    labels = torch.from_numpy(rng.integers(0, 3, 4)).to(cuda_device)
    mask = torch.tensor([True, True, True, False], device=cuda_device)
    before = tattn.fused_attention_qkv_bwd.launches, tmlp.fused_ln_mlp_bwd.launches
    loss = get_loss({"type": "CrossEntropyLoss"})(module(x), labels, mask=mask)
    loss.backward()
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv_bwd.launches == before[0] + 4
    assert tmlp.fused_ln_mlp_bwd.launches == before[1] + 4
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


@pytest.mark.cuda
def test_every_vit_parameter_gets_a_gradient_through_the_kernels(cuda_device):
    from nkbx_torch.models.classifier import SingletaskClassifier
    from nkbx_torch.models.vit import ViT
    from nkbx_torch.train import get_loss
    from nkbx_torch.transforms import Compose, Normalize

    torch.manual_seed(0)
    backbone = ViT(patch_size=16, dim=128, depth=2, n_heads=2, img_size=(64, 64),
                   fused_attention=True, fused_mlp=True)
    module = SingletaskClassifier(backbone, 3).to(cuda_device).train()
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    x = Compose([Normalize()]).device_apply(images.to(cuda_device))
    labels = torch.from_numpy(rng.integers(0, 3, 4)).to(cuda_device)
    mask = torch.tensor([True, True, True, False], device=cuda_device)
    before = tattn.fused_attention_bwd.launches, tmlp.fused_ln_mlp_bwd.launches
    loss = get_loss({"type": "CrossEntropyLoss"})(module(x), labels, mask=mask)
    loss.backward()
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches == before[0] + 2
    assert tmlp.fused_ln_mlp_bwd.launches == before[1] + 2
    for name, p in module.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        # the key Dense's bias shifts whole score rows: zero gradient in exact arithmetic
        assert name.endswith("key.bias") or p.grad.abs().max() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("ln_off", [False, True])
def test_every_convnext_parameter_gets_a_gradient_through_the_kernels(cuda_device, monkeypatch,
                                                                      ln_off):
    from nkbx_torch.models.classifier import SingletaskClassifier
    from nkbx_torch.models.convnext import ConvNeXt
    from nkbx_torch.train import get_loss
    from nkbx_torch.transforms import Compose, Normalize

    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", "0" if ln_off else "")
    torch.manual_seed(0)
    backbone = ConvNeXt(depths=(1, 1), dims=(32, 64), fused_mlp=True)
    for block in (backbone.ConvNeXtBlock_0, backbone.ConvNeXtBlock_1):
        block.layer_scale.data.uniform_(0.1, 1.0)  # at flax's 1e-6 the MLP grads vanish
    module = SingletaskClassifier(backbone, 3).to(cuda_device).train()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    x = Compose([Normalize()]).device_apply(images.to(cuda_device))
    labels = torch.from_numpy(rng.integers(0, 3, 4)).to(cuda_device)
    mask = torch.tensor([True, True, True, False], device=cuda_device)
    before = tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_mlp_bwd.launches
    loss = get_loss({"type": "CrossEntropyLoss"})(module(x), labels, mask=mask)
    loss.backward()
    torch.cuda.synchronize()
    want = (before[0], before[1] + 2) if ln_off else (before[0] + 2, before[1])
    assert (tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_mlp_bwd.launches) == want
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


CHAIN_CASES = [
    # (B, H = W, C, M, th): banded at ResNet-50's three bands, and one band
    (4, 8, 64, 16, 4),
    (4, 14, 64, 32, 7),
    (2, 14, 128, 64, 2),
    (4, 8, 64, 16, 8),
    # in bf16 on the tensor-core route (C and M multiples of 32): bands of 5
    # and 2 rows of a 10-row image (runs that 128-row block tiles straddle),
    # one band at C = 96, M = 64 (column tiles past C and M), a band of 2 at
    # M = 96
    (4, 10, 64, 32, 5),
    (4, 10, 64, 32, 2),
    (2, 10, 96, 64, 10),
    (4, 8, 64, 96, 2),
]
CHAIN_NAMES = ("m1", "v1", "m2", "v2", "m3", "v3", "dx", "dw1", "dw2", "dw3", "ds1", "db1", "ds2",
               "db2", "ds3", "db3")


def _chain_inputs(b, h, c, m, device, dtype):
    rng = np.random.RandomState(3)
    mk = lambda *s, sc=1.0: torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))  # noqa: E731
    uni = lambda n: torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32))  # noqa: E731
    args = [mk(b, h, h, c), mk(c, m, sc=c ** -0.5), mk(3, 3, m, m, sc=(9 * m) ** -0.5),
            mk(m, c, sc=m ** -0.5), uni(m), mk(m, sc=0.1), uni(m), mk(m, sc=0.1), uni(c),
            mk(c, sc=0.1)]
    args = [t.to(device) for t in args]
    for i in range(4):
        args[i] = args[i].to(dtype)
    return args, mk(b, h, h, c).to(device).to(dtype)


def _hold_chain(out, stats, grads, args, dout, th, route):
    """K9 and K10's results against the plain chain: the output within 5e-4
    (f32) or 4 bf16 ulps of its largest value, each statistic within 5e-4
    (f32) or 2e-2 of its largest value, each gradient within those of its
    largest value, or, on the tensor-core route (``route``), by its relative
    L2 error."""
    dtype = args[0].dtype
    pout, pstats = tbn.reference_chain(*args, g=2, th=th)
    pgrads = tbn.reference_chain_bwd(*args, dout, g=2, th=th)
    ref = pout.float().abs().max().item()
    tol = 5e-4 if dtype == torch.float32 else 4 * 2.0 ** (np.floor(np.log2(ref)) - 7)
    assert out.dtype == dtype and (out.float() - pout.float()).abs().max().item() <= tol
    rel = 5e-4 if dtype == torch.float32 else 2e-2
    for i, (name, got, want) in enumerate(zip(CHAIN_NAMES, tuple(stats) + tuple(grads),
                                              tuple(pstats) + tuple(pgrads))):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        d = got.float() - want.float()
        if route and i >= 6:
            err = d.norm().item()
            assert err <= rel * want.float().norm().item(), (name, err)
        else:
            err = d.abs().max().item()
            assert err <= rel * want.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c,m,th", CHAIN_CASES)
def test_chain_kernels_match_plain_on_card(cuda_device, dtype, b, h, c, m, th):
    args, dout = _chain_inputs(b, h, c, m, cuda_device, dtype)
    route = tbn.takes_tc(dtype, c, m)
    counters = (tbn.fused_chain, "launches"), (tbn.fused_chain, "tc_launches"), \
        (tbn.fused_chain_bwd, "launches"), (tbn.fused_chain_bwd, "tc_launches")
    before = [getattr(f, k) for f, k in counters]
    out, stats = tbn.fused_chain_fwd(*args, g=2, th=th)
    grads = tbn.fused_chain_bwd(*args, dout, g=2, th=th)
    torch.cuda.synchronize()
    assert [getattr(f, k) for f, k in counters] == [n + d for n, d in
                                                     zip(before, (1, route, 1, route))]
    _hold_chain(out, stats, grads, args, dout, th, route)
    out2, stats2 = tbn.fused_chain_fwd(*args, g=2, th=th)
    grads2 = tbn.fused_chain_bwd(*args, dout, g=2, th=th)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, *stats, *grads),
                                                   (out2, *stats2, *grads2)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,c,m,th", [(4, 10, 64, 32, 5), (2, 14, 128, 64, 2)])
def test_chain_keeps_its_first_design_in_f32(cuda_device, b, h, c, m, th):
    """f32 runs the first design: the wrappers' numbers are its launch
    helpers' with tc=False bit for bit, and the route's counters stay."""
    args, dout = _chain_inputs(b, h, c, m, cuda_device, torch.float32)
    before = tbn.fused_chain.tc_launches, tbn.fused_chain_bwd.tc_launches
    out, stats = tbn.fused_chain_fwd(*args, g=2, th=th)
    grads = tbn.fused_chain_bwd(*args, dout, g=2, th=th)
    assert (tbn.fused_chain.tc_launches, tbn.fused_chain_bwd.tc_launches) == before
    fout, fstats = tbn._forward(*args, g=2, th=th, eps=1e-5, tc=False)
    fgrads = tbn._backward(*args, dout, g=2, th=th, eps=1e-5, tc=False)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, *stats, *grads),
                                                   (fout, *fstats, *fgrads)))


@pytest.mark.cuda
def test_chain_first_design_stays_reachable_in_bf16(cuda_device):
    args, dout = _chain_inputs(4, 10, 64, 32, cuda_device, torch.bfloat16)
    out, stats = tbn._forward(*args, g=2, th=5, eps=1e-5, tc=False)
    grads = tbn._backward(*args, dout, g=2, th=5, eps=1e-5, tc=False)
    _hold_chain(out, stats, grads, args, dout, 5, route=False)


@pytest.mark.cuda
def test_chain_kernels_refuse_what_they_cannot_take(cuda_device):
    args, dout = _chain_inputs(2, 8, 12, 8, cuda_device, torch.float32)  # C = 12
    with pytest.raises(ValueError, match="multiples of 8"):
        tbn.fused_chain(*args, g=2, th=4)
    with pytest.raises(ValueError, match="multiples of 8"):
        tbn.fused_chain_bwd(*args, dout, g=2, th=4)


@pytest.mark.cuda
def test_every_resnet_parameter_gets_a_gradient_through_the_kernels(cuda_device, monkeypatch):
    from nkbx_torch.models.classifier import SingletaskClassifier
    from nkbx_torch.models.resnet import Bottleneck, ResNet
    from nkbx_torch.train import get_loss

    monkeypatch.delenv("NKBX_FUSED_CHAIN", raising=False)
    torch.manual_seed(0)
    backbone = ResNet(stage_sizes=(2,), block_cls=Bottleneck, stem_width=8, ghost_bn=2,
                      fused_bottleneck=True)
    module = SingletaskClassifier(backbone, 3).to(cuda_device).train()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32)).to(cuda_device)
    labels = torch.from_numpy(rng.integers(0, 3, 4)).to(cuda_device)
    before = tbn.fused_chain.launches, tbn.fused_chain_bwd.launches
    loss = get_loss({"type": "CrossEntropyLoss"})(module(x), labels,
                                                  mask=torch.ones(4, dtype=torch.bool,
                                                                  device=cuda_device))
    loss.backward()
    torch.cuda.synchronize()
    assert (tbn.fused_chain.launches, tbn.fused_chain_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


MB_CASES = [
    # (N, Cin, Cout, tile_rows): one tile; ragged row and column tiles; a probe shape
    (128, 16, 16, 128),
    (300, 48, 80, 100),
    (4096, 256, 144, 1024),
    (50_176, 512, 512, 1024),
]


def _ulp_err(got, want):
    """The largest |got - want| in units of one bf16 ulp of each value of
    want plus 2^-16 of the largest |want| (near 0 a bf16 ulp is finer than
    the rounding noise of the f32 sums both sides round from)."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return ((got.float() - w).abs() / (ulp + 2.0 ** -16 * w.abs().max())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,cin,cout,tile_rows", MB_CASES)
def test_matmul_bn_kernel_matches_plain_on_card(cuda_device, dtype, n, cin, cout, tile_rows):
    args = tmb.inputs(n, cin, cout, dtype, cuda_device)
    before = tmb.fused_matmul_bn_relu_stats.launches
    y, s, q = tmb.fused_matmul_bn_relu_stats(*args, tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert tmb.fused_matmul_bn_relu_stats.launches == before + 1
    py, ps, pq = tmb.reference_matmul_bn_relu_stats(*args)
    assert y.dtype == dtype and s.dtype == q.dtype == torch.float32
    if dtype == torch.float32:
        assert (y - py).abs().max().item() <= 2e-5 * py.abs().max().item()
    else:
        assert _ulp_err(y, py) <= 1
    for got, want in ((s, ps), (q, pq)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_bn_sums_are_bit_identical_across_runs(cuda_device, dtype):
    """The column sums add the row tiles' partials in a fixed order."""
    args = tmb.inputs(200_704, 256, 256, dtype, cuda_device)
    first = tmb.fused_matmul_bn_relu_stats(*args)
    second = tmb.fused_matmul_bn_relu_stats(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_matmul_bn_kernel_refuses_what_it_cannot_take(cuda_device):
    x, w, scale, bias = tmb.inputs(64, 32, 32, torch.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmb.fused_matmul_bn_relu_stats(x.half(), w.half(), scale, bias, tile_rows=64)
    with pytest.raises(TypeError, match="w must be"):
        tmb.fused_matmul_bn_relu_stats(x, w.cpu(), scale, bias, tile_rows=64)
    with pytest.raises(TypeError, match="scale and bias"):
        tmb.fused_matmul_bn_relu_stats(x, w, scale.cpu(), bias, tile_rows=64)
    with pytest.raises(ValueError, match="multiples of 16"):
        tmb.fused_matmul_bn_relu_stats(x[:, :24], w[:24], scale, bias, tile_rows=64)
    with pytest.raises(ValueError, match="tile_rows"):
        tmb.fused_matmul_bn_relu_stats(x[:48], w, scale, bias, tile_rows=64)


MB_ROUTE_CASES = [
    # (N, Cin, Cout): one partial tile; ragged N with Cin != Cout both ways (a
    # 64-wide and a 128-wide column tile); Cin at the route's limit; three
    # column tiles; ResNet's 256 -> 64 at a ragged stage-1 row count
    (100, 64, 64),
    (1000, 256, 64),
    (1000, 64, 256),
    (777, 512, 512),
    (4096, 128, 384),
    (50_177, 256, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout", MB_ROUTE_CASES)
def test_matmul_bn_route_matches_plain_on_card(cuda_device, n, cin, cout):
    """X1's route on wgmma + TMA (bf16, Cin and Cout multiples of 64): taken
    by count, y within one bf16 ulp of each value, the sums 1e-4 of their
    largest, a relaunch bit-identical."""
    args = tmb.inputs(n, cin, cout, torch.bfloat16, cuda_device, seed=n % 89)
    assert tmb.takes_wgmma(n, cin, cout, torch.bfloat16)
    fn = tmb.fused_matmul_bn_relu_stats
    before = (fn.launches, fn.wgmma_launches)
    first = fn(*args, tile_rows=1)
    again = fn(*args, tile_rows=1)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (before[0] + 2, before[1] + 2)
    py, ps, pq = tmb.reference_matmul_bn_relu_stats(*args)
    y, s, q = first
    assert y.dtype == torch.bfloat16 and y.shape == (n, cout)
    assert _ulp_err(y, py) <= 1
    for got, want in ((s, ps), (q, pq)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_matmul_bn_first_design_stays_reachable_in_bf16(cuda_device):
    """The first design (WMMA) through its own C entry at a width the route
    takes: off the route by count, held as the route is."""
    args = tmb.inputs(1000, 256, 64, torch.bfloat16, cuda_device)
    fn = tmb.fused_matmul_bn_relu_stats
    before = (fn.launches, fn.wgmma_launches)
    y, s, q = tmb.first_design(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1])
    py, ps, pq = tmb.reference_matmul_bn_relu_stats(*args)
    assert _ulp_err(y, py) <= 1
    for got, want in ((s, ps), (q, pq)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_matmul_bn_route_refuses_what_it_cannot_take(cuda_device):
    """The route's C entry raises on widths it does not take (no quiet fall
    back to the first design), and f32 stays off it."""
    for cin, cout in ((48, 64), (64, 80), (576, 64)):
        args = tmb.inputs(128, cin, cout, torch.bfloat16, cuda_device)
        assert not tmb.takes_wgmma(128, cin, cout, torch.bfloat16)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tmb._launch(*args, True)
    fn = tmb.fused_matmul_bn_relu_stats
    before = fn.wgmma_launches
    fn(*tmb.inputs(128, 64, 64, torch.float32, cuda_device), tile_rows=128)
    assert fn.wgmma_launches == before


GC_CASES = [
    # (B, H, W, C, gw): the probe's check shapes, ragged widths, gw 1 and 32, stage 2
    (2, 8, 8, 32, 4),
    (2, 8, 8, 64, 8),
    (1, 5, 9, 32, 1),
    (3, 7, 7, 64, 32),
    (64, 28, 28, 256, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,gw", GC_CASES)
def test_gconv_kernel_matches_plain_on_card(cuda_device, dtype, b, h, w, c, gw):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(b, h, w, c, generator=gen, device=cuda_device).to(dtype)
    wvec = tgc.build_wvec((0.1 * torch.randn(3, 3, gw, c, generator=gen, device=cuda_device))
                          .to(dtype), gw)
    before = tgc.gconv.launches
    got = tgc.gconv(x, wvec, gw)
    torch.cuda.synchronize()
    assert tgc.gconv.launches == before + 1
    want = tgc.reference_gconv(x, wvec, gw)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    else:
        assert _ulp_err(got, want) <= 1


# (B, H, W, C, gw): every group width, ragged H and W of 7, 13 and 57, C from 32
# to 1024, C only a multiple of 32 (96), and gw = C (one group)
GC_WIDTH_CASES = [
    (1, 7, 13, 32, 1),
    (2, 13, 7, 64, 2),
    (1, 57, 13, 96, 4),
    (2, 13, 57, 128, 8),
    (1, 7, 57, 512, 16),
    (2, 57, 7, 1024, 32),
    (1, 13, 13, 32, 32),
    (2, 7, 7, 1024, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,gw", GC_WIDTH_CASES)
def test_gconv_kernel_at_every_group_width(cuda_device, dtype, b, h, w, c, gw):
    """X2 against its plain version at every group width the kernel takes
    (bf16: the tensor-core kernel with block-diagonal packing for gw < 8),
    f32 within 1e-5 of the largest value, bf16 within one ulp of each value
    (as X1's y); a second launch is bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(b, h, w, c, generator=gen, device=cuda_device).to(dtype)
    wvec = tgc.build_wvec((0.1 * torch.randn(3, 3, gw, c, generator=gen, device=cuda_device))
                          .to(dtype), gw)
    got, again = tgc.gconv(x, wvec, gw), tgc.gconv(x, wvec, gw)
    torch.cuda.synchronize()
    want = tgc.reference_gconv(x, wvec, gw)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    else:
        assert _ulp_err(got, want) <= 1
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gconv_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros(1, 4, 4, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgc.gconv(x.half(), torch.zeros(36, 64, device=cuda_device).half(), 4)
    with pytest.raises(TypeError, match="wvec must be"):
        tgc.gconv(x, torch.zeros(36, 64), 4)
    with pytest.raises(ValueError, match="at most 32"):
        tgc.gconv(x, torch.zeros(576, 64, device=cuda_device), 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        tgc.gconv(x[..., :48], torch.zeros(36, 48, device=cuda_device), 4)


LAYOUT_CASES = [  # (function, input shape); the last of each function is a probe shape
    ("stream", (3, 5, 7)), ("stream", (2, 49, 288)), ("stream", (64, 49, 2304)),
    ("transpose_in_kernel", (5, 3, 7)), ("transpose_in_kernel", (3, 5, 129)),
    ("transpose_in_kernel", (49, 2304, 64)),
    ("gather_windows", (2, 7, 21, 5)), ("gather_windows", (512, 7, 56, 288)),
    ("scatter_windows", (2, 3, 49, 5)), ("scatter_windows", (512, 8, 49, 288)),
    ("merge_windows", (2, 7, 7, 3)), ("merge_windows", (512, 7, 7, 288)),
    ("split_windows", (2, 49, 3)), ("split_windows", (512, 49, 288)),
    ("pad8", (2, 7, 7, 3)), ("pad8", (512, 7, 7, 288)),
]
LAYOUT_PLAIN = {"stream": tlayout.reference_copy,
                "transpose_in_kernel": tlayout.reference_transpose,
                "gather_windows": tlayout.reference_gather_windows,
                "scatter_windows": tlayout.reference_scatter_windows,
                "merge_windows": tlayout.reference_merge_windows,
                "split_windows": tlayout.reference_split_windows, "pad8": tlayout.reference_pad8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", LAYOUT_CASES)
def test_layout_kernels_match_plain_on_card(cuda_device, dtype, name, shape):
    fn = getattr(tlayout, name)
    x = torch.randn(*shape, device=cuda_device).to(dtype)
    unaligned = torch.randn(x.numel() + 1, device=cuda_device).to(dtype)[1:].view(shape)
    for t in (x, unaligned):
        before = fn.launches
        got = fn(t)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, LAYOUT_PLAIN[name](t)) and got.data_ptr() != t.data_ptr()


# (elements, offset in elements) of a copy: the bulk ring from 32 MiB (a last
# chunk of one 16-byte vector; more chunks than its stages hold); the vector
# loop at 16 bytes below it, and at 8, 4 and 2 bytes for offset views and odd
# counts, small and large
COPY_CASES = [(16_777_224, 0), (20_000_000, 0), (8, 0), (8200, 0), (8, 4), (8, 2), (8, 1),
              (1001, 0), (8200, 3), (40_001, 6), (10_000_001, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("numel,offset", COPY_CASES)
def test_copy_kernel_equals_clone_at_every_vector_width(cuda_device, numel, offset):
    """X3's copy (the bulk-copy ring from 32 MiB at 16-byte alignment, the
    vector loop otherwise) equals clone bit for bit, in bf16 and f32, as a
    fresh tensor."""
    for dtype in (torch.bfloat16, torch.float32):
        base = torch.randn(numel + offset, device=cuda_device).to(dtype)
        x = base[offset:]
        before = tlayout.stream.launches
        got = tlayout.stream(x)
        torch.cuda.synchronize()
        assert tlayout.stream.launches == before + 1
        assert torch.equal(got, x.clone()) and got.data_ptr() != x.data_ptr()


@pytest.mark.cuda
def test_layout_kernels_refuse_what_they_cannot_take(cuda_device):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tlayout.stream(torch.zeros(4, 4, dtype=torch.float16, device=cuda_device))
    with pytest.raises(ValueError, match="non-empty"):
        tlayout.pad8(torch.zeros(0, 7, 7, 8, device=cuda_device))


def _write_bmp(path, img):
    h, w = img.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    path.write_bytes(struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
                     + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0, 0, 0, 0)
                     + rows.tobytes())


@pytest.mark.cuda
def test_trainer_epoch_through_the_kernels(cuda_device, tmp_path):
    from nkbx_torch import transforms as T
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_local_experiment
    from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
    from nkbx_torch.models.swin import SwinTransformer
    from nkbx_torch.train import get_loss
    from nkbx_torch.train.trainer import train
    from nkbx_torch.utils import Config

    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("val", 6)):
        for i in range(n):
            d = tmp_path / split / f"c{i % 3}"
            d.mkdir(parents=True, exist_ok=True)
            h, w = rng.integers(20, 60, 2)
            _write_bmp(d / f"{i}.bmp", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    pipe = [T.LongestMaxSize(32), T.PadIfNeeded(32, 32)]
    cfg = Config({
        "task": "single", "n_epochs": 1,
        "train_data": {"root": str(tmp_path / "train"), "batch_size": 5, "shuffle": True},
        "val_data": {"root": str(tmp_path / "val"), "batch_size": 5},
        "train_pipeline": T.Compose(pipe + [T.HorizontalFlip(), T.Normalize()]),
        "val_pipeline": T.Compose(pipe + [T.Normalize()]),
        "optimizer": {"type": "adam", "backbone_lr": 1e-3, "classifier_lr": 1e-3},
        "criterion": {"type": "CrossEntropyLoss"},
        "experiment": {"comet": None, "local": {"path": str(tmp_path / "run")}}})
    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    val_loader = get_dataset(cfg.val_data, cfg.val_pipeline)
    backbone = SwinTransformer(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2,
                               img_size=(32, 32), fused_attention=True, fused_mlp=True)
    module = SingletaskClassifier(backbone, 3).to(cuda_device)
    model = ClassificationModel(module, ["c0", "c1", "c2"], "single", backbone.num_features,
                                (32, 32), torch.float32, cuda_device)
    exp = get_local_experiment(cfg.experiment["local"])
    before = tattn.fused_attention_qkv_bwd.launches, tmlp.fused_ln_mlp_bwd.launches
    state = train(model, train_loader, val_loader, get_loss(cfg.criterion), None, exp, cfg)
    torch.cuda.synchronize()
    assert state.step == 3  # 12 images, batch 5
    assert tattn.fused_attention_qkv_bwd.launches == before[0] + 4 * 3
    assert tmlp.fused_ln_mlp_bwd.launches == before[1] + 4 * 3
    lines = (exp.path / "metrics.csv").read_text().splitlines()
    assert len(lines) == 2 and "nan" not in lines[1].lower()
    assert (exp.path / "weights" / "last").is_dir() and (exp.path / "weights" / "last.pt").exists()


@pytest.mark.cuda
def test_device_ops_on_card_match_the_cpu(cuda_device):
    """configs/singletask_config.py's device stage (flips, brightness/contrast,
    HSV, coarse dropout, Normalize) on a CUDA batch of 16 at 128 px against
    the CPU with the same draws: 1e-3 on the 0-255 scale, i.e. 1e-3 / (255 *
    std) after Normalize; then the stage's own draws from a CUDA generator
    run on the card and repeat from a seed."""
    from nkbx_torch.utils import load_config

    pipe = load_config(ROOT / "configs" / "singletask_config.py").train_pipeline
    stage = pipe.device_stage()
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (16, 128, 128, 3),
                                                           dtype=np.uint8))
    draws = stage.draw(tuple(x.shape), torch.Generator().manual_seed(3))
    want = stage(x, draws=draws)
    got = stage(x.to(cuda_device), draws=[{k: v.to(cuda_device) for k, v in d.items()}
                                          for d in draws])
    assert got.device.type == "cuda"
    std = 255.0 * min(pipe.device_transforms[-1].std)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3 / std)
    gen = torch.Generator(device=cuda_device)
    a = stage(x.to(cuda_device), torch.bfloat16, generator=gen.manual_seed(1))
    b = stage(x.to(cuda_device), torch.bfloat16, generator=gen.manual_seed(1))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b) and torch.isfinite(a.float()).all()


POLICY_SHAPES = [(5, 37, 53), (16, 128, 96), (3, 224, 224)]
@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["RandAugment", "TrivialAugmentWide"])
@pytest.mark.parametrize("shape", POLICY_SHAPES)
def test_policy_ops_on_card_match_the_cpu(cuda_device, policy, shape):
    """RandAugment (num_ops = 2, magnitude 9, 4 grids) and
    TrivialAugmentWide on a CUDA uint8 batch at ragged sizes, against the
    CPU with the same draws: each round from the same input, within 1e-3 on
    the 0-255 scale, the samples on identity, a warp, posterize, solarize or
    equalize equal, but for the pixels whose source coordinate lies within
    1e-4 of a .5 tie; the whole stage (Normalize included) within 1e-3 /
    (255 * std) where no round has such a pixel; a second run on the card
    bit-identical; the stage's own draws from a CUDA generator."""
    from nkbx_torch.transforms import device as tdevice
    from nkbx_torch.transforms import spec as tspec

    b, h, w = shape
    t = (tspec.RandAugment(num_ops=2, magnitude=9, num_affine_grids=4, p=0.8)
         if policy == "RandAugment" else tspec.TrivialAugmentWide(num_affine_grids=4, p=0.8))
    pipe = tspec.Compose([t, tspec.Normalize()])
    stage = pipe.device_stage()
    x = torch.from_numpy(np.random.default_rng(b).integers(0, 256, (b, h, w, 3),
                                                           dtype=np.uint8))
    (d,) = stage.draw(tuple(x.shape), torch.Generator().manual_seed(h))
    dc = {k: v.to(cuda_device) for k, v in d.items()}
    xr = x.float()
    for r in range(d["op"].shape[0]):
        point, grids = tdevice.policy_magnitudes(t, d, r, h, w)
        point_c, grids_c = tdevice.policy_magnitudes(t, dc, r, h, w)
        want = tdevice.policy_round(xr, d["op"][r], d["grid"][r], point, grids)
        got = tdevice.policy_round(xr.to(cuda_device), dc["op"][r], dc["grid"][r], point_c,
                                   grids_c).cpu()
        ties = tdevice.policy_ties(t, d, r, h, w)
        keep = ~ties[..., None]
        torch.testing.assert_close(got * keep, want * keep, rtol=0, atol=1e-3)
        exact = torch.isin(d["op"][r], torch.tensor(tdevice.EXACT_OPS))
        assert torch.equal((got * keep)[exact], (want * keep)[exact])
        xr = want
    want = stage(x, draws=[d])
    got = stage(x.to(cuda_device), draws=[dc])
    std = 255.0 * min(pipe.device_transforms[-1].std)
    if not any(tdevice.policy_ties(t, d, r, h, w).any() for r in range(d["op"].shape[0])):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3 / std)
    assert torch.equal(got, stage(x.to(cuda_device), draws=[dc]))
    gen = torch.Generator(device=cuda_device)
    a = stage(x.to(cuda_device), torch.bfloat16, generator=gen.manual_seed(1))
    assert torch.equal(a, stage(x.to(cuda_device), torch.bfloat16, generator=gen.manual_seed(1)))
    assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()


HEAVY_SHAPES = [(5, 37, 53), (16, 128, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAVY_SHAPES)
def test_heavy_ops_on_card_match_the_cpu(cuda_device, shape):
    """MotionBlur (3-9, shifted), RandomShadow (up to 3), RandomFog,
    RandomRain (a negative slant) and Rotate and ShiftScaleRotate in both
    border modes (p = 0.8) on a CUDA uint8 batch at ragged sizes, against
    the CPU with the same draws, each op from the same input: within 1e-3
    on the 0-255 scale, leaving out a MotionBlur sample with a tie tap and a
    shadow's tie pixels; a warp's source coordinates within 5e-4 px, its
    sampling at the CPU's coordinates within 1e-3 and its output within 1e-3
    + 255 x 5e-4; a second run bit-identical."""
    from nkbx_torch.transforms import device as tdevice
    from nkbx_torch.transforms import spec as tspec

    b, h, w = shape
    ops = [tspec.MotionBlur(blur_limit=(3, 9), p=0.8),
           tspec.RandomShadow(num_shadows_upper=3, p=0.8), tspec.RandomFog(p=0.8),
           tspec.RandomRain(slant_lower=-12, slant_upper=-2, p=0.8),
           tspec.Rotate(p=0.8), tspec.Rotate(border_mode="constant", value=77.0, p=0.8),
           tspec.ShiftScaleRotate(p=0.8),
           tspec.ShiftScaleRotate(border_mode="constant", value=200.0, p=0.8)]
    stage = tspec.Compose([*ops, tspec.Normalize()]).device_stage()
    x = torch.from_numpy(np.random.default_rng(b).integers(0, 256, (b, h, w, 3),
                                                           dtype=np.uint8)).float()
    draws = stage.draw((b, h, w, 3), torch.Generator().manual_seed(h))
    for t, d in zip(stage.ops, draws):
        dc = {k: v.to(cuda_device) for k, v in d.items()}
        apply = tdevice._APPLIERS[type(t)]
        want = apply(t, x, d)
        got = apply(t, x.to(cuda_device), dc)
        assert torch.equal(got, apply(t, x.to(cuda_device), dc))
        keep = ~tdevice.op_ties(t, d, h, w)
        tol = 1e-3
        if isinstance(t, (tspec.Rotate, tspec.ShiftScaleRotate)):
            src = tdevice.warp_sources(t, d, h, w)
            for a, c in zip(tdevice.warp_sources(t, dc, h, w), src):
                torch.testing.assert_close(a.cpu(), c, rtol=0, atol=5e-4)
            mode = tdevice.BORDER_MODES[t.border_mode]
            shared = tdevice.bilinear_warp(x.to(cuda_device), *(v.to(cuda_device) for v in src),
                                           mode, t.value)
            torch.testing.assert_close(shared.cpu(), tdevice.bilinear_warp(x, *src, mode, t.value),
                                       rtol=0, atol=1e-3)
            tol = 1e-3 + 255 * 5e-4
        keep = keep[..., None]
        torch.testing.assert_close(got.cpu() * keep, want * keep, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixup_on_card_matches_the_cpu(cuda_device, dtype):
    """Mixup and CutMix on a CUDA batch (ragged 7 x 37 x 53, a padded row)
    against the CPU with the same draws: equal (elementwise f32 products and
    sums, then the cast; CutMix's lam a true division on either device), lam
    equal, a second run bit-identical; the draws from a CUDA generator in
    range."""
    from nkbx_torch.train.mixup import Mixup

    x = torch.from_numpy(np.random.default_rng(2).normal(size=(7, 37, 53, 3)) * 60 + 120).to(
        dtype)
    mask = torch.ones(7, dtype=torch.bool)
    mask[-1] = False
    for cfg in ({"alpha": 0.4}, {"cutmix_alpha": 1.0}):
        mix = Mixup(cfg)
        gen = torch.Generator().manual_seed(len(cfg))
        for _ in range(3):
            d = mix.draw(tuple(x.shape), gen)
            want, lam_w, p_w = mix.apply(x, mask, d)
            dc = {k: v.to(cuda_device) for k, v in d.items()}
            got, lam_g, p_g = mix.apply(x.to(cuda_device), mask.to(cuda_device), dc)
            assert got.dtype == dtype and torch.equal(p_g.cpu(), p_w)
            assert torch.equal(got.cpu(), want) and torch.equal(lam_g.cpu(), lam_w)
            assert torch.equal(got, mix.apply(x.to(cuda_device), mask.to(cuda_device), dc)[0])
        dc = mix.draw(tuple(x.shape), torch.Generator(device=cuda_device).manual_seed(0))
        assert all(v.device.type == torch.device(cuda_device).type for v in dc.values())
        assert 0 <= float(dc["lam0"]) <= 1 and 0 <= int(dc["cy"]) < 37


@pytest.mark.cuda
def test_ema_update_on_card_matches_the_cpu(cuda_device):
    """TrainState.update_ema (parameters and BatchNorm running statistics)
    on the card against the CPU: equal (a product, a product, a sum)."""
    from nkbx_torch.models import get_model
    from nkbx_torch.train import TrainState

    states = []
    for dev in ("cpu", cuda_device):
        model = get_model({"model": "resnet_tiny_test"}, ["a", "b"], input_size=(32, 32),
                          dtype=torch.float32, device=dev)
        state = TrainState.create(model, ema=True)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for t in state.ema_pairs()[1]:
                t.add_(torch.randn(t.shape, generator=gen).to(t.device))
        for _ in range(3):
            state.update_ema(0.9998)
        states.append(state)
    cpu, card = (s.ema_module.state_dict() for s in states)
    assert all(torch.equal(card[k].cpu(), cpu[k]) for k in cpu)
    moved = [k for k in cpu if k.endswith(("running_mean", "weight"))]
    assert moved and all(not torch.equal(cpu[k], states[0].module.state_dict()[k])
                         for k in moved)


OP_CASES = ["window_attention", "attention", "ln_mlp", "mlp"]


def _op_call(name, device):
    """(the registered op's call, the launcher's call, the wrapper whose
    count both advance) at a ragged bf16 shape."""
    rng = np.random.RandomState(5)

    def t(*shape, dtype=torch.bfloat16, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, dtype)

    if name == "window_attention":  # G = 6 windows of N = 17, 2 heads of 32, M = 2 masks
        qkv, bias = t(6, 17, 192), t(2, 17, 17, dtype=torch.float32, scale=0.1)
        mask = torch.from_numpy(np.where(rng.rand(2, 17, 17) < 0.2, -100.0, 0.0)
                                .astype(np.float32)).to(device)
        args = (qkv, bias, mask, 32 ** -0.5, 2)
        return (lambda: tattn.window_attention_op(*args), lambda: tattn._forward(*args),
                tattn.fused_attention_qkv)
    if name == "attention":  # N = 65, 2 heads of 64, bias and mask None
        args = (t(3, 65, 128), t(3, 65, 128), t(3, 65, 128), None, None, 0.125, 2)
        return (lambda: tattn.attention_op(*args), lambda: tattn._sep_forward(*args),
                tattn.fused_attention)
    c, f, r = 96, 384, 129 if name == "ln_mlp" else 49
    w0, w1 = t(c, f, scale=c ** -0.5), t(f, c, scale=f ** -0.5)
    b0, b1 = t(f, dtype=torch.float32, scale=0.1), t(c, dtype=torch.float32, scale=0.1)
    if name == "ln_mlp":
        args = (t(r, c), 1 + t(c, dtype=torch.float32, scale=0.1),
                t(c, dtype=torch.float32, scale=0.1), w0, b0, w1, b1, t(r, c),
                1 + t(c, dtype=torch.float32, scale=0.1), 1e-6)
        return (lambda: tmlp.ln_mlp_op(*args), lambda: tmlp._forward(*args), tmlp.fused_ln_mlp)
    args = (t(r, c), w0, b0, w1, b1)
    return lambda: tmlp.mlp_op(*args), lambda: tmlp._mlp_forward(*args), tmlp.fused_mlp


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_CASES)
def test_registered_op_is_its_launcher_on_card(cuda_device, name):
    """Each forward kernel's torch.library op (what a --fused-attention
    bundle holds) on CUDA tensors: bit-identical to its launcher, and
    counted as one launch of the kernel."""
    op, launcher, counted = _op_call(name, cuda_device)
    want = launcher()
    before = counted.launches
    got = op()
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def _tiny_net(name, device):
    """A tiny classifier with the fused flags on, its input size and the
    launches of one forward ({wrapper: count})."""
    from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
    from nkbx_torch.models.convnext import ConvNeXt
    from nkbx_torch.models.swin import SwinTransformer
    from nkbx_torch.models.vit import ViT

    torch.manual_seed(0)
    if name == "swin":
        backbone, size = SwinTransformer(embed_dim=64, depths=(2, 2), n_heads=(2, 4), window=2,
                                         img_size=(32, 32), fused_attention=True,
                                         fused_mlp=True, dtype=torch.bfloat16), 32
        counts = {tattn.fused_attention_qkv: 4, tmlp.fused_ln_mlp: 4}
    elif name == "vit":
        backbone, size = ViT(patch_size=16, dim=128, depth=2, n_heads=2, img_size=(64, 64),
                             fused_attention=True, fused_mlp=True, dtype=torch.bfloat16), 64
        counts = {tattn.fused_attention: 2, tmlp.fused_ln_mlp: 2}
    else:  # under NKBX_FUSED_LN_MLP=0
        backbone, size = ConvNeXt(depths=(1, 1), dims=(32, 64), fused_mlp=True,
                                  dtype=torch.bfloat16), 64
        counts = {tmlp.fused_mlp: 2}
    module = SingletaskClassifier(backbone, 3).to(device).eval()
    return (ClassificationModel(module, ["a", "b", "c"], "single", backbone.num_features,
                                (size, size), torch.bfloat16, device), size, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["swin", "vit", "convnext"])
def test_fused_bundle_serves_through_the_kernels_on_card(cuda_device, name, tmp_path,
                                                         monkeypatch):
    """A tiny Swin, ViT and ConvNeXt (K7 under NKBX_FUSED_LN_MLP=0), bf16,
    exported on the card with fused_attention=True (static batch 4),
    reloaded and served: each forward kernel launched once a block a
    forward, the logits within 2 bf16 ulps of the largest of the eager
    model's through the same kernels."""
    from nkbx_torch.export import ServingModule, export_model

    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.delenv("NKBX_FUSED_ATTENTION", raising=False)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", "0" if name == "convnext" else "")
    model, size, counts = _tiny_net(name, cuda_device)
    path, meta = export_model(model, (4, size, size, 3), tmp_path / "fused.nkbx",
                              dynamic="none", fused_attention=True)
    assert meta["fused_attention"] is True
    serving = ServingModule(path, warm_up_on_load=False, device=cuda_device)
    assert serving.buckets == [4] and serving.device.type == "cuda"
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, size, size, 3))
                         .astype(np.float32)).to(cuda_device)
    before = {fn: fn.launches for fn in counts}
    got = serving(x)  # a chunk of 4 and one of 2 padded to 4: two forwards
    torch.cuda.synchronize()
    assert {fn: fn.launches - before[fn] for fn in counts} == {fn: 2 * n for fn, n in
                                                               counts.items()}
    with torch.no_grad():
        want = model.module(x)
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert got.shape == (6, 3) and float((got - want).abs().max()) <= 2 * ulp


@pytest.mark.cuda
def test_portable_bundle_launches_none_of_the_kernels_on_card(cuda_device, tmp_path,
                                                              monkeypatch):
    """The default export (dynamic batch, under disable_fused) of the same
    tiny Swin serves on the card through plain operations only."""
    from nkbx_torch.export import ServingModule, export_model

    monkeypatch.delenv("NKBX_FUSED_ATTENTION", raising=False)
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    model, size, _ = _tiny_net("swin", cuda_device)
    path, _ = export_model(model, (8, size, size, 3), tmp_path / "portable.nkbx")
    serving = ServingModule(path, warm_up_on_load=False, device=cuda_device)
    kernels = (tattn.fused_attention_qkv, tattn.fused_attention, tmlp.fused_ln_mlp,
               tmlp.fused_mlp)
    before = [fn.launches for fn in kernels]
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, size, size, 3))
                         .astype(np.float32)).to(cuda_device)
    got = serving(x)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels] == before
    assert not any(str(n.target).startswith("nkbx_torch.") for n in serving.program.graph.nodes)
    assert got.shape == (5, 3) and torch.isfinite(got).all()


REMAT_CASES = [("convnext", 3), ("convnext", 5), ("resnet", 6), ("resnet", 10)]


def _remat_model(family, remat, device):
    """A tiny bf16 model whose every stage runs under remat or none: a
    ConvNeXt through K5/K6 (C = 32 and 64, on the GEMM route) or a ghost-BN
    ResNet whose stride-1 Bottleneck takes the fused chain (K9/K10, C = 256,
    M = 64)."""
    from nkbx_torch.models import convnext, resnet
    from nkbx_torch.models.classifier import SingletaskClassifier

    stages = (0, 1) if remat else ()
    torch.manual_seed(0)
    if family == "convnext":
        backbone = convnext.ConvNeXt(depths=(1, 1), dims=(32, 64), dtype=torch.bfloat16,
                                     fused_mlp=True, remat_stages=stages)
    else:
        backbone = resnet.ResNet(stage_sizes=(2, 1), block_cls=resnet.Bottleneck,
                                 stem_width=16, ghost_bn=2, fused_bottleneck=True,
                                 dtype=torch.bfloat16, remat_stages=stages)
    model = SingletaskClassifier(backbone, 3)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # weights of a scale that moves every block
        for n, p in model.named_parameters():
            if n.endswith("layer_scale"):
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))
    return model.to(device).train()


@pytest.mark.cuda
@pytest.mark.parametrize("family,batch", REMAT_CASES)
def test_remat_is_bit_equal_on_card(cuda_device, family, batch):
    """remat_stages on the card, bf16, at ragged batches: logits, gradients
    and running statistics bit-equal to the run without it, under
    deterministic algorithms; K5 (or K9) launched twice, its backward once."""
    fwd, bwd = ((tmlp.fused_ln_mlp, tmlp.fused_ln_mlp_bwd) if family == "convnext"
                else (tbn.fused_chain, tbn.fused_chain_bwd))
    size = 64 if family == "convnext" else 32
    x = torch.from_numpy(np.random.RandomState(batch).randn(batch, size, size, 3)
                         .astype(np.float32)).to(cuda_device)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = []
    try:
        for remat in (False, True):
            model = _remat_model(family, remat, cuda_device)
            before = fwd.launches, bwd.launches
            out = model(x)
            out.float().square().sum().backward()
            torch.cuda.synchronize()
            runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()},
                         {n: b for n, b in model.named_buffers()},
                         (fwd.launches - before[0], bwd.launches - before[1])))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (o0, g0, b0, n0), (o1, g1, b1, n1) = runs
    assert n0[0] > 0 and n1 == (2 * n0[0], n0[1]) and n0[1] == n0[0]
    assert torch.equal(o0, o1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)


@pytest.mark.cuda
def test_input_norm_on_card_matches_the_cpu(cuda_device):
    """ResNet's input_norm (Normalize folded into the s2d stem) on the card
    against the CPU, f32 with TF32 off: logits within 1e-4 of the largest,
    on a raw 0-255 batch at 48 px."""
    from nkbx_torch.models import resnet
    from nkbx_torch.models.classifier import SingletaskClassifier

    norm = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
    torch.manual_seed(0)
    model = SingletaskClassifier(resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock,
                                               stem_width=16, input_norm=norm), 3).eval()
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (3, 48, 48, 3))
                         .astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(x)
            got = model.to(cuda_device)(x.to(cuda_device)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_bf16_master_update_on_card_matches_the_cpu(cuda_device):
    """One adam step of bf16 master parameters (coupled wd, lr factor 0.75)
    on the card against the CPU: the bf16 moments bit-equal; the card's
    foreach add takes p + alpha * u in f32 and rounds once, as the CPU's
    explicit f32 form does, so a parameter differs only where a fused and
    an unfused multiply-add round apart: at most 0.1% of them, by one ulp."""
    from nkbx_torch.train.optim import apply_updates, get_optimizer, init_opt_state

    bundle = get_optimizer({"type": "adam", "lr": 1e-2, "weight_decay": 1e-3})
    rng = np.random.RandomState(0)
    base = [(rng.randn(*shape) * 0.2).astype(np.float32) for shape in ((64, 96), (96,), (3, 64))]
    grads = [rng.randn(*a.shape).astype(np.float32) for a in base]
    runs = []
    for device in ("cpu", cuda_device):
        params = [torch.from_numpy(a).to(device, torch.bfloat16) for a in base]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g).to(device, torch.bfloat16)
        groups = {"backbone": params[:2], "classifier": params[2:]}
        state = init_opt_state(groups)
        apply_updates(bundle, state, groups, 0.75, 1.0)
        runs.append(([p.cpu() for p in params],
                     [t.cpu() for st in state.values() for t in st.mu + st.nu]))
    (p_cpu, m_cpu), (p_card, m_card) = runs
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(m_cpu, m_card))
    for a, b in zip(p_cpu, p_card):
        off = a != b
        ulp = torch.from_numpy(np.spacing(np.abs(a.float().numpy())).astype(np.float32)) * 2 ** 16
        assert off.float().mean() <= 1e-3
        assert ((a.float() - b.float()).abs() <= ulp).all()


def _collectives_rank(out):
    """A rank of test_collectives_over_gloo_on_one_card (this file run as a
    script, torchrun's variables in the environment): gloo's own all-gather
    of a CUDA tensor, then every function of nkbx_torch.parallel.collectives
    on tensors on cuda:0."""
    import json

    import torch.distributed as dist

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import collectives as C

    info = initialize(distributed=True, device="cuda:0")
    rank, dev = C.rank(), torch.device("cuda", 0)
    res = {"backend": info["backend"]}
    try:  # gloo's own all-gather of a CUDA tensor, which all_gather_rows relies on
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        res["raw_all_gather"] = "ok"
    except Exception as e:  # noqa: BLE001 - reported by the test
        res["raw_all_gather"] = f"{type(e).__name__}: {str(e)[:200]}"
    t = torch.arange(4, dtype=torch.float32, device=dev) + rank
    res["all_reduce"] = C.all_reduce_(t.clone()).tolist()
    res["all_reduce_max"] = C.all_reduce_(t.clone(), op="max").tolist()
    p = torch.nn.Parameter(torch.zeros(3, device=dev))
    p.grad = torch.full((3,), float(rank + 1), device=dev)
    q = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16, device=dev))
    q.grad = torch.full((2,), 0.5 * (rank + 1), dtype=torch.bfloat16, device=dev)
    C.all_reduce_grads([p, q])
    res["grads"] = [p.grad.tolist(), q.grad.float().tolist(), str(q.grad.device)]
    g = C.all_gather_rows(torch.full((2, 2), rank, device=dev))
    res["gather_rows"] = [g.tolist(), str(g.device)]
    res["gather_bool"] = C.all_gather_rows(torch.tensor([rank == 0, True], device=dev)).tolist()
    res["gather_object"] = C.all_gather_object({"rank": rank})
    res["broadcast"] = C.broadcast_object(f"from {rank}")
    res["sum_count"] = C.sum_count(rank + 2)
    res["agreed"] = [C.agreed_any(rank == 1), C.agreed_any(False)]
    C.barrier()
    sums = []
    for device in (dev, torch.device("cpu")):  # the BatchNorm sum and its backward
        x = torch.full((3,), float(rank + 1), device=device, requires_grad=True)
        y = C.sum_across_ranks(x * x)
        (y * torch.tensor([1.0, 2.0, 3.0], device=device)).sum().backward()
        sums.append([y.tolist(), x.grad.tolist(), str(y.device)])
    res["bn_sum"] = sums
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_collectives_over_gloo_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks sharing cuda:0 (``initialize(device="cuda:0")``) run
    every function of nkbx_torch.parallel.collectives on CUDA tensors,
    against the sums worked out here (the CPU's, tests/test_torch_dist.py),
    the differentiable BatchNorm sum and its backward on the card and on the
    CPU; the gathers come back on the card. gloo's own all-gather takes a
    CUDA tensor (all_gather_rows does not stage around it)."""
    import json
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--collectives", str(tmp_path)], cwd=ROOT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o[-2000:] + e[-4000:]
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["raw_all_gather"] == "ok" and res["backend"] == "gloo"
        assert res["all_reduce"] == [1.0, 3.0, 5.0, 7.0]
        assert res["all_reduce_max"] == [1.0, 2.0, 3.0, 4.0]
        assert res["grads"] == [[3.0, 3.0, 3.0], [1.5, 1.5], "cuda:0"]
        assert res["gather_rows"] == [[[0, 0], [0, 0], [1, 1], [1, 1]], "cuda:0"]
        assert res["gather_bool"] == [True, True, False, True]
        assert res["gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert res["broadcast"] == "from 0" and res["sum_count"] == 5
        assert res["agreed"] == [True, False]
        want_grad = [2.0 * (r + 1) * 2 * w for w in (1.0, 2.0, 3.0)]
        assert res["bn_sum"] == [[[5.0] * 3, want_grad, "cuda:0"], [[5.0] * 3, want_grad, "cpu"]]


def _fsdp_rank(out):
    """A rank of test_fsdp_round_trip_of_vit_b_over_gloo_on_one_card (this file
    run as a script, torchrun's variables in the environment)."""
    import json

    import torch.distributed as dist

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import make_mesh
    from nkbx_torch.train import TrainState

    initialize(distributed=True, device="cuda:0")
    mesh = make_mesh()
    dev = torch.device("cuda", 0)
    model = get_model({"model": "vit_base_patch16_224",
                       "backbone_opts": {"fused_attention": True, "fused_mlp": True}},
                      [f"class{i}" for i in range(10)], seed=0, device=dev)
    whole = {k: v.clone() for k, v in model.module.state_dict().items()}
    state = TrainState.create(model, ema=True, mesh=mesh, fsdp=True)
    scat = state.scatter_of(state.module)
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    owners, moments = [], []
    for label, st in state.opt_state.items():  # moments of other values on each rank
        for t in st.mu + st.nu:
            t.normal_(generator=gen)
        owners += state.groups[label] * 2
        moments += st.mu + st.nu
    kept = [t.clone() for t in moments]
    shards = [s.clone() for _, _, s in scat.params]
    res = {"scattered": len(scat.params), "whole": len(scat.replicated),
           "device": str(shards[0].device),
           "empty_at_rest": all(p.numel() == 0 for p, _, _ in scat.params)}
    for module, name in ((state.module, "params"), (state.ema_module, "ema")):
        with state.gathered(module):
            sd = module.state_dict()
            res[name] = all(torch.equal(sd[k], whole[k]) for k in whole)
    full = state.whole(owners, moments)
    res["moments"] = all(torch.equal(state.local(o, f), t)
                         for o, f, t in zip(owners, full, kept))
    scat.load_state_dict(whole)  # the gathered weights scattered again
    res["reload"] = all(torch.equal(s, t) for (_, _, s), t in zip(scat.params, shards))
    with open(f"{out}/fsdp{mesh.rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_fsdp_round_trip_of_vit_b_over_gloo_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 scatter a ViT-B train state (f32 masters,
    nadam moments, the EMA shadow; nkbx's rule at its default threshold),
    gather its parameters, moments and shadow whole, and scatter them again:
    every tensor comes back bit for bit."""
    import json
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--fsdp", str(tmp_path)], cwd=ROOT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o[-2000:] + e[-4000:]
    for r in range(2):
        res = json.loads((tmp_path / f"fsdp{r}.json").read_text())
        # per block: query, key, value, out and the two MLP kernels; patch_embed, pos_embed
        assert res["scattered"] == 6 * 12 + 2 and res["device"] == "cuda:0", res
        assert res["empty_at_rest"] and res["params"] and res["ema"], res
        assert res["moments"] and res["reload"], res


def test_card_tests_collect_without_jax_or_nkbx():
    """The card's machine has no JAX: this file must collect (and its card
    tests skip here) with jax, flax and nkbx unimportable and no conftest."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'nkbx'):\n"
            "    sys.modules[m] = None\n"
            "import pytest\n"
            f"sys.exit(pytest.main(['--noconftest', '-q', '-p', 'no:cacheprovider', "
            f"'-p', 'no:randomly', '-m', 'cuda', {str(pathlib.Path(__file__))!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    n = (2 * 2 * len(ATTN_CASES) + 2 * 2 * len(MLP_CASES) + 2 * 2 * len(MLP_ONLY_CASES)
         + 2 * 2 * len(SEP_CASES) + 2 + 2 + 2 * len(CHAIN_CASES) + 2
         + 2 * len(MB_CASES) + 2 + 1 + 2 * len(GC_CASES) + 1 + 2 * len(LAYOUT_CASES) + 1 + 1
         + 2 * len(SEP_RAGGED_N) * len(SEP_OPERANDS) + 2 * len(GC_WIDTH_CASES)
         + 2 * len(SEP_BWD_RAGGED_N) * len(SEP_BWD_OPERANDS) + 2 * len(TC_BWD_CASES) + 2
         + 2 * len(TC_BWD_CASES) + 2 + 2 * 2 * len(GEMM_ROWS) * len(GEMM_WIDTHS) + 3 + 4
         + 2 * len(MLP_GEMM_ROWS) * len(MLP_GEMM_WIDTHS) + 2 + 1
         + len(MB_ROUTE_CASES) + 2 + len(COPY_CASES) + 1
         + 2 * len(UNICOM_SEQ) + len(EPS_CASES)
         + 2 * len(POLICY_SHAPES) + len(HEAVY_SHAPES) + 2 + 1
         + len(OP_CASES) + 3 + 1 + len(REMAT_CASES) + 1 + 1 + 1 + 1)
    word = "passed" if torch.cuda.is_available() else "skipped"
    assert re.search(rf"\b{n} {word}\b", proc.stdout), proc.stdout[-2000:]


def test_every_card_test_lives_in_this_file():
    """Card tests elsewhere would sit in files that import JAX, which the
    card's machine cannot collect."""
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        if path.name != pathlib.Path(__file__).name:
            assert "@pytest.mark.cuda" not in path.read_text(), path.name


if __name__ == "__main__":
    if sys.argv[1] == "--collectives":
        _collectives_rank(sys.argv[2])
    elif sys.argv[1] == "--fsdp":
        _fsdp_rank(sys.argv[2])
