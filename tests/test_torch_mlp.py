"""nkbx_torch LN->MLP (nkbx_torch/ops/mlp.py) against nkbx's.

The port's plain version is held against nkbx's ``reference_ln_mlp``, and
the port's entry on a CPU tensor against the Pallas kernel run in interpret
mode (which needs at least 128 rows, nkbx/ops/mlp.py:145). The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX.

Tolerances: float32 1e-4 (the same math; the remaining differences are
nkbx's rational erf and approximate reciprocal against torch's erf, and the
order of sums). bfloat16 6.25e-2: both sides stage through bf16 at the
same points, but a last-bit difference can flip a rounding of u or of the
output, whose values reach 8 here (one bf16 ulp there is 3.1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.ops import mlp as jmlp
from nkbx_torch.ops import mlp as tmlp


def _inputs(r, c, f, seed=0, gamma=False):
    rng = np.random.RandomState(seed)
    a = dict(
        x=rng.randn(r, c), s=1 + 0.1 * rng.randn(c), b=0.1 * rng.randn(c),
        w0=rng.randn(c, f) / np.sqrt(c), b0=0.1 * rng.randn(f),
        w1=rng.randn(f, c) / np.sqrt(f), b1=0.1 * rng.randn(c), sc=rng.randn(r, c),
        gamma=(1 + 0.1 * rng.randn(c)) if gamma else None)
    return {k: None if v is None else v.astype(np.float32) for k, v in a.items()}


def _order(a, conv, dt):
    """Positional args plus gamma, weights and rows in ``dt``."""
    rowish = ("x", "w0", "w1", "sc")
    args = [conv(a[k], dt if k in rowish else None) for k in ("x", "s", "b", "w0", "b0", "w1",
                                                                "b1", "sc")]
    return args, (None if a["gamma"] is None else conv(a["gamma"], None))


def _jax(v, dt):
    return jnp.asarray(v, dt or jnp.float32)


def _torch(v, dt):
    t = torch.from_numpy(v)
    return t.to(dt) if dt is not None else t


@pytest.mark.parametrize("r,c,f,gamma", [
    (10, 8, 32, False),
    (37, 16, 64, True),
    (64, 96, 384, False),  # Swin-T stage-1 widths
])
def test_reference_matches_nkbx_f32(r, c, f, gamma):
    a = _inputs(r, c, f, gamma=gamma)
    jargs, jg = _order(a, _jax, None)
    targs, tg = _order(a, _torch, None)
    want = jmlp.reference_ln_mlp(*jargs, gamma=jg, eps=1e-5)
    got = tmlp.reference_ln_mlp(*targs, gamma=tg, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gamma", [False, True])
def test_reference_matches_nkbx_bf16(gamma):
    a = _inputs(48, 32, 128, seed=1, gamma=gamma)
    jargs, jg = _order(a, _jax, jnp.bfloat16)
    targs, tg = _order(a, _torch, torch.bfloat16)
    want = jmlp.reference_ln_mlp(*jargs, gamma=jg, eps=1e-5)
    got = tmlp.reference_ln_mlp(*targs, gamma=tg, eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=6.25e-2)


def test_entry_matches_pallas_interpret():
    """The port's entry on CPU tensors against nkbx's Pallas kernel
    (interpret mode) with a ragged last row tile and a layer-scale."""
    a = _inputs(200, 16, 64, seed=2, gamma=True)
    jargs, jg = _order(a, _jax, None)
    targs, tg = _order(a, _torch, None)
    want = jmlp.fused_ln_mlp(*jargs, gamma=jg, eps=1e-5, interpret=True)
    before = tmlp.fused_ln_mlp.launches
    got = tmlp.fused_ln_mlp(*targs, gamma=tg, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert tmlp.fused_ln_mlp.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("c,tc,tile", [
    (96, True, 64), (192, True, 32), (384, True, 32), (768, True, 16), (1536, True, 16),
    (96, False, 64), (192, False, 32), (384, False, 32), (768, False, 16), (1536, False, 16),
    (4096, False, None)])
def test_gate_tile_rows_from_shared_memory(c, tc, tile):
    # every Swin width takes a kernel (Swin-T 96..768, Swin-L up to 1536)
    assert tmlp.pick_tile_rows(c, tc) == tile
    if tile is not None:
        assert tmlp.smem_bytes(tile, c, tc) <= tmlp._MAX_SMEM


@pytest.mark.parametrize("dtype,c,f,want", [
    (torch.bfloat16, 96, 384, True), (torch.bfloat16, 768, 3072, True),
    (torch.float32, 96, 384, False), (torch.bfloat16, 40, 160, False),
    (torch.bfloat16, 48, 192, False),
    (torch.bfloat16, 96, 96, False)])
def test_tensor_core_kernel_takes_bf16_at_aligned_widths(dtype, c, f, want):
    assert tmlp.tensor_cores(dtype, c, f) is want


@pytest.mark.parametrize("env_mlp,env_ln,flag,on_cuda,want", [
    ("", "", None, False, None),
    ("", "", None, True, "ln"),
    ("", "", True, False, "ln"),
    ("", "", False, True, None),
    ("0", "", True, True, None),
    ("1", "", False, False, "ln"),
    ("", "0", None, True, None),
])
def test_fused_mlp_mode_precedence(monkeypatch, env_mlp, env_ln, flag, on_cuda, want):
    monkeypatch.setenv("NKBX_FUSED_MLP", env_mlp)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", env_ln)

    x = torch.zeros(2, 96, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", on_cuda)
    assert tmlp.fused_mlp_mode(flag, x, 384) == want


def test_mode_is_plain_where_no_tile_fits():
    assert tmlp.fused_mlp_mode(True, torch.zeros(2, 4096), 16384) is None
