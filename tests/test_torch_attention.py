"""nkbx_torch window attention (nkbx_torch/ops/attention.py) against nkbx's.

The port's plain version is held against nkbx's ``reference_attention`` in
the three mask regimes of tests/test_fused_attention.py, and the port's
entry on a CPU tensor against the Pallas kernel run in interpret mode. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX.

Tolerances: float32 1e-4 (the same math; the remaining differences are the
order of sums and nkbx's Newton-refined approximate reciprocal). bfloat16
2e-2: both sides round P and the output to bf16, so a last-bit difference in
f32 can flip one bf16 rounding, a relative 2^-8 of values of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.ops import attention as jattn
from nkbx_torch.ops import attention as tattn

CASES = [
    # (G, N, heads, d, M): M=1 broadcast; W%M==0; W<M (mask per window)
    (8, 9, 2, 8, 1),
    (8, 9, 2, 8, 4),
    (64, 5, 1, 8, 64),
    (6, 13, 3, 4, 3),
    (8, 49, 3, 32, 4),  # Swin-T stage-1 head geometry
]


def _inputs(g, n, heads, d, m, seed=0, bias_heads=None):
    rng = np.random.RandomState(seed)
    hd = heads * d
    qkv = rng.randn(g, n, 3 * hd).astype(np.float32)
    bias = (rng.randn(bias_heads or heads, n, n) * 0.1).astype(np.float32)
    mask = np.where(rng.rand(m, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    return qkv, bias, mask


def _split(a, hd):
    return a[..., :hd], a[..., hd:2 * hd], a[..., 2 * hd:]


@pytest.mark.parametrize("g,n,heads,d,m", CASES)
def test_reference_matches_nkbx_f32(g, n, heads, d, m):
    qkv, bias, mask = _inputs(g, n, heads, d, m)
    hd, scale = heads * d, d ** -0.5
    want = jattn.reference_attention(*_split(jnp.asarray(qkv), hd), jnp.asarray(bias),
                                     jnp.asarray(mask), scale, heads)
    got = tattn.reference_attention(*_split(torch.from_numpy(qkv), hd),
                                    torch.from_numpy(bias), torch.from_numpy(mask), scale, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("g,n,heads,d,m", CASES[:3])
def test_reference_matches_nkbx_bf16(g, n, heads, d, m):
    qkv, bias, mask = _inputs(g, n, heads, d, m, seed=3)
    hd, scale = heads * d, d ** -0.5
    want = jattn.reference_attention(*_split(jnp.asarray(qkv, jnp.bfloat16), hd),
                                     jnp.asarray(bias), jnp.asarray(mask), scale, heads)
    got = tattn.reference_attention(*_split(torch.from_numpy(qkv).bfloat16(), hd),
                                    torch.from_numpy(bias), torch.from_numpy(mask), scale, heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


def test_bias_broadcast_single_head_slot():
    qkv, bias, mask = _inputs(8, 9, 2, 8, 1, bias_heads=1)
    want = jattn.reference_attention(*_split(jnp.asarray(qkv), 16), jnp.asarray(bias),
                                     jnp.asarray(mask), 8 ** -0.5, 2)
    got = tattn.reference_attention(*_split(torch.from_numpy(qkv), 16), torch.from_numpy(bias),
                                    torch.from_numpy(mask), 8 ** -0.5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_packed_entry_matches_pallas_interpret():
    """The port's packed entry on a CPU tensor against nkbx's Pallas kernel
    (interpret mode), shift-mask regime W % M == 0."""
    g, n, heads, d, m = 8, 9, 2, 8, 4
    qkv, bias, mask = _inputs(g, n, heads, d, m, seed=5)
    scale = d ** -0.5
    want = jattn.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask),
                                     scale, heads, interpret=True)
    before = tattn.fused_attention_qkv.launches
    got = tattn.fused_attention_qkv(torch.from_numpy(qkv), torch.from_numpy(bias),
                                    torch.from_numpy(mask), scale, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert tattn.fused_attention_qkv.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("env,flag,on_cuda,want", [
    ("", None, False, False),
    ("", None, True, True),
    ("", True, False, True),
    ("", False, True, False),
    ("0", True, True, False),
    ("1", False, False, True),
])
def test_resolve_fused_precedence(monkeypatch, env, flag, on_cuda, want):
    monkeypatch.setenv("NKBX_FUSED_ATTENTION", env)

    class _T:
        is_cuda = on_cuda

    assert tattn.resolve_fused(flag, _T()) is want


def test_smem_need_of_window12_exceeds_default_limit():
    # N=144 needs the raised dynamic shared-memory limit, and fits a block
    assert 48 * 1024 < tattn.smem_bytes(144, 32) <= tattn._MAX_SMEM
    assert tattn.smem_bytes(49, 32) < 48 * 1024
