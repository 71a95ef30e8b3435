"""The backward halves of the port's kernels against nkbx's, on the CPU.

- ``reference_attention_bwd`` against ``jax.vjp`` of nkbx's
  ``fused_attention_qkv(..., interpret=True)``: the Pallas backward kernel
  ``_bwd_kernel_packed`` run in interpret mode, in the three mask regimes of
  tests/test_torch_attention.py and with a head-broadcast bias.
- ``reference_ln_mlp_bwd`` against ``jax.vjp`` of nkbx's
  ``fused_ln_mlp(..., interpret=True)`` (``_lnmlp_bwd_kernel``) with a
  ragged last row tile, with and without a layer-scale.
- The ``torch.autograd.Function``s of the port: on CPU tensors both halves
  are the plain versions, so their gradients must equal autograd's through
  the plain forward; x and shortcut as one tensor sum their cotangents, and
  dbias scatters into the relative-position-bias table.
- The K2 and K6 kernels against the plain backward versions are held on
  the card by tests/test_torch_cuda.py, which imports no JAX.

Tolerances: float32 1e-4 relative and absolute (the same math; what is left
is nkbx's rational erf, its approximate reciprocal and the order of sums);
dbias 1e-4 times its largest value (a sum over every window).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.ops import attention as jattn
from nkbx.ops import mlp as jmlp
from nkbx_torch.ops import attention as tattn
from nkbx_torch.ops import mlp as tmlp

ATTN_CASES = [
    # (G, N, heads, d, M, bias heads): M=1 broadcast; W%M==0; W<M
    (8, 9, 2, 8, 1, 2),
    (8, 9, 2, 8, 4, 2),
    (64, 5, 1, 8, 64, 1),
    (6, 13, 3, 4, 3, 1),  # a (1, N, N) bias shared by the heads
]


def _attn_inputs(g, n, heads, d, m, bh, seed=0):
    rng = np.random.RandomState(seed)
    hd = heads * d
    qkv = rng.randn(g, n, 3 * hd).astype(np.float32)
    bias = (rng.randn(bh, n, n) * 0.1).astype(np.float32)
    mask = np.where(rng.rand(m, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    go = rng.randn(g, n, hd).astype(np.float32)
    return qkv, bias, mask, go


def _assert_dbias(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("g,n,heads,d,m,bh", ATTN_CASES)
def test_attention_bwd_matches_pallas_interpret(g, n, heads, d, m, bh):
    qkv, bias, mask, go = _attn_inputs(g, n, heads, d, m, bh)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b: jattn.fused_attention_qkv(a, b, jnp.asarray(mask), scale,
                                                            heads, interpret=True),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(go))
    dqkv, dbias = tattn.reference_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(bias),
                                                torch.from_numpy(mask), torch.from_numpy(go),
                                                scale, heads)
    assert dqkv.dtype == torch.float32 and dbias.shape == bias.shape
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), rtol=1e-4, atol=1e-4)
    _assert_dbias(dbias.numpy(), want_dbias)


def test_attention_bwd_bf16_rounds_like_nkbx():
    """bf16: both sides round P, dS·scale and the outputs to bf16 at the same
    points; a last-bit difference in f32 can flip one rounding, a relative
    2^-8, so the bound is 2 bf16 ulps of the largest dqkv value."""
    qkv, bias, mask, go = _attn_inputs(8, 9, 2, 8, 4, 2, seed=2)
    scale = 8 ** -0.5
    _, vjp = jax.vjp(lambda a: jattn.fused_attention_qkv(a, jnp.asarray(bias), jnp.asarray(mask),
                                                         scale, 2, interpret=True),
                     jnp.asarray(qkv, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(go, jnp.bfloat16))
    got, _ = tattn.reference_attention_bwd(torch.from_numpy(qkv).bfloat16(),
                                           torch.from_numpy(bias), torch.from_numpy(mask),
                                           torch.from_numpy(go).bfloat16(), scale, 2)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** -7 * np.abs(want).max())


def _mlp_inputs(r, c, f, seed=0, gamma=False):
    rng = np.random.RandomState(seed)
    a = dict(
        x=rng.randn(r, c), s=1 + 0.1 * rng.randn(c), b=0.1 * rng.randn(c),
        w0=rng.randn(c, f) / np.sqrt(c), b0=0.1 * rng.randn(f),
        w1=rng.randn(f, c) / np.sqrt(f), b1=0.1 * rng.randn(c),
        gamma=(1 + 0.1 * rng.randn(c)) if gamma else None, dy=rng.randn(r, c))
    return {k: None if v is None else v.astype(np.float32) for k, v in a.items()}


_MLP_KEYS = ("x", "s", "b", "w0", "b0", "w1", "b1")


@pytest.mark.parametrize("r,c,f,gamma", [(200, 16, 64, True), (130, 32, 128, False)])
def test_ln_mlp_bwd_matches_pallas_interpret(r, c, f, gamma):
    """R >= 128 (the Pallas tile minimum) and ragged: the last row tile of
    nkbx's kernel is masked (mlp.py:145)."""
    a = _mlp_inputs(r, c, f, seed=1, gamma=gamma)
    ja = [jnp.asarray(a[k]) for k in _MLP_KEYS]
    jg = jnp.asarray(a["gamma"]) if gamma else jnp.ones(c, jnp.float32)

    def fn(x, s, b, w0, b0, w1, b1, gm, sc):
        return jmlp.fused_ln_mlp(x, s, b, w0, b0, w1, b1, sc, gamma=gm, eps=1e-5,
                                 interpret=True)

    _, vjp = jax.vjp(fn, *ja, jg, jnp.asarray(a["x"]))
    want = vjp(jnp.asarray(a["dy"]))
    ta = [torch.from_numpy(a[k]) for k in _MLP_KEYS]
    tg = torch.from_numpy(a["gamma"]) if gamma else None
    got = tmlp.reference_ln_mlp_bwd(*ta, tg, torch.from_numpy(a["dy"]), eps=1e-5)
    names = ("dx", "ds", "db", "dw0", "db0", "dw1", "db1", "dgamma")
    assert (got[7] is None) is (not gamma)  # no layer-scale, no dgamma
    for name, gv, wv in zip(names, got, want[:8]):
        if gv is None:
            continue
        assert gv.dtype == torch.float32, name
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(np.asarray(want[8]), a["dy"])  # d(shortcut) = dy


def _grads(fn, inputs):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    torch.manual_seed(0)
    (out * torch.randn_like(out)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("bh", [2, 1])
def test_attention_function_matches_autograd_of_plain(bh):
    qkv, bias, mask, _ = _attn_inputs(8, 9, 2, 8, 4, bh, seed=3)
    hd, scale = 16, 8 ** -0.5
    inputs = [torch.from_numpy(qkv), torch.from_numpy(bias)]
    mask_t = torch.from_numpy(mask)
    before = tattn.fused_attention_qkv_bwd.launches
    got = _grads(lambda a, b: tattn.fused_attention_qkv(a, b, mask_t, scale, 2), inputs)
    want = _grads(lambda a, b: tattn.reference_attention(a[..., :hd], a[..., hd:2 * hd],
                                                         a[..., 2 * hd:], b, mask_t, scale, 2),
                  inputs)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-5, atol=1e-5)
    assert tattn.fused_attention_qkv_bwd.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("gamma", [False, True])
def test_ln_mlp_function_matches_autograd_of_plain(gamma):
    """x and shortcut are one tensor, as in Swin (swin.py:149): autograd sums
    dx and d(shortcut) = dy."""
    a = _mlp_inputs(37, 16, 64, seed=4, gamma=gamma)
    inputs = [torch.from_numpy(a[k]) for k in _MLP_KEYS]
    if gamma:
        inputs.append(torch.from_numpy(a["gamma"]))

    def call(fn):
        return lambda x, s, b, w0, b0, w1, b1, *gm: fn(
            x, s, b, w0, b0, w1, b1, x, gamma=gm[0] if gm else None, eps=1e-5)

    before = tmlp.fused_ln_mlp_bwd.launches
    got = _grads(call(tmlp.fused_ln_mlp), inputs)
    want = _grads(call(tmlp.reference_ln_mlp), inputs)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-4, atol=1e-5)
    assert tmlp.fused_ln_mlp_bwd.launches == before


def test_window_attention_scatters_dbias_into_the_table():
    from nkbx_torch.models.swin import WindowAttention

    torch.manual_seed(0)
    mods = [WindowAttention(8, 2, 3, fused=fused) for fused in (True, False)]
    mods[1].load_state_dict(mods[0].state_dict())
    with torch.no_grad():
        mods[0].relative_position_bias_table.normal_()
        mods[1].relative_position_bias_table.copy_(mods[0].relative_position_bias_table)
    x = torch.randn(4, 9, 8)
    mask = torch.from_numpy(np.where(np.random.RandomState(0).rand(2, 9, 9) < 0.3, -100.0,
                                     0.0).astype(np.float32))
    for mod in mods:
        mod(x, mask).square().sum().backward()
    got, want = (m.relative_position_bias_table.grad for m in mods)
    assert got is not None and got.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
