"""The port's kernels on a CUDA card, against their plain PyTorch versions.

This file imports neither JAX nor nkbx, so it runs where the card is and
JAX is not. tests/conftest.py imports JAX, so on such a machine run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test marked ``cuda`` skips with a reason where there is no card
(chip_smoke.py is the fuller check on the card). Each wrapper's launch count
shows that the kernel, not its plain version, ran:

- K1 window attention and K2 its backward, in the three mask regimes of
  tests/test_torch_attention.py, a head-broadcast bias and window 12 (N=144);
- K5 LN -> MLP and K6 its backward, with a ragged tile, a layer-scale,
  Swin-T's widest width and a width off the tensor-core grid;
- a tiny Swin's loss backward through the kernels gives every parameter a
  finite, non-zero gradient (the autograd graph is not cut).

Tolerances, absolute: K1 f32 1e-4, bf16 3e-2 (P and the output round to
bf16; a last-bit difference flips one rounding of values of order 1). K2
dqkv f32 1e-4, bf16 6e-2 (dS*scale rounds to bf16 too); dbias 1e-4 of its
largest value. K5 f32 5e-4, bf16 1.25e-1 (outputs reach 8, where one bf16
ulp is 3.1e-2). K6, relative to each gradient's largest value: f32 1e-3,
bf16 3e-2.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nkbx_torch.ops import attention as tattn
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
    n = 2 * 2 * len(ATTN_CASES) + 2 * 2 * len(MLP_CASES) + 1
    word = "passed" if torch.cuda.is_available() else "skipped"
    assert re.search(rf"\b{n} {word}\b", proc.stdout), proc.stdout[-2000:]


def test_every_card_test_lives_in_this_file():
    """Card tests elsewhere would sit in files that import JAX, which the
    card's machine cannot collect."""
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        if path.name != pathlib.Path(__file__).name:
            assert "@pytest.mark.cuda" not in path.read_text(), path.name
