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


class _Like:
    """What the gate reads of a tensor: where it lies."""

    def __init__(self, is_cuda):
        self.is_cuda = is_cuda


@pytest.mark.parametrize("env", ["", "0", "1"])
@pytest.mark.parametrize("min_g", [None, "1", "256"])
def test_resolve_fused_with_groups_matches_nkbx(monkeypatch, env, min_g):
    """The port's gate against nkbx's on every (flag, auto, groups) under
    the env override and NKBX_FUSED_MIN_G: on a CUDA tensor the port's auto
    is nkbx's auto (the family's default on the accelerator), on a CPU
    tensor it is False."""
    monkeypatch.setenv("NKBX_FUSED_ATTENTION", env)
    if min_g is None:
        monkeypatch.delenv("NKBX_FUSED_MIN_G", raising=False)
    else:
        monkeypatch.setenv("NKBX_FUSED_MIN_G", min_g)
    for flag in (None, True, False):
        for auto in (True, False):
            for groups in (None, 1, 64, 255, 256, 4096):
                for on_cuda in (True, False):
                    want = jattn.resolve_fused(flag, auto and on_cuda, groups)
                    got = tattn.resolve_fused(flag, _Like(on_cuda), auto, groups)
                    assert got is want, (flag, auto, groups, on_cuda)


def test_swin_call_sites_pass_their_groups_to_the_gate(monkeypatch):
    """A tiny Swin at batch 2 (G = 32 windows at stage 0, 8 at stage 1): with
    NKBX_FUSED_MIN_G=16 every stage-0 call site takes the kernel's entry and
    every stage-1 call site the plain version, as nkbx's gate answers; the
    gate sees the tensor as if it lay on a card, which the CPU cannot show
    otherwise."""
    from nkbx_torch.models import swin as tswin

    monkeypatch.delenv("NKBX_FUSED_ATTENTION", raising=False)
    monkeypatch.setenv("NKBX_FUSED_MIN_G", "16")
    answers, entries = [], []

    def gate(flag, x, auto=True, groups=None):
        answers.append((groups, tattn.resolve_fused(flag, _Like(True), auto, groups)))
        return answers[-1][1]

    def entry(qkv, *args):
        entries.append(qkv.shape[0])
        return tattn.fused_attention_qkv(qkv, *args)

    monkeypatch.setattr(tswin, "resolve_fused", gate)
    monkeypatch.setattr(tswin, "fused_attention_qkv", entry)
    model = tswin.SwinTransformer(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2,
                                  img_size=(32, 32))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    out = model(x)
    assert out.shape == (2, 32) and torch.isfinite(out).all()
    assert [g for g, _ in answers] == [32, 32, 8, 8]
    for g, got in answers:
        assert got is jattn.resolve_fused(None, True, g) is (g >= 16)
    assert entries == [32, 32]


@pytest.mark.parametrize("n,want", [(16, 16), (17, 32), (48, 48), (49, 64), (63, 64),
                                    (64, 64), (65, 80), (144, 144)])
def test_bwd_tc_sizing(n, want):
    """The backward's tensor-core design pads a window to KP = N rounded up
    to 16: its shared memory (the q/k/v/go ring, one bf16 P/dS tile, the f32
    dbias partial) fits a block at every N it takes, three blocks an SM to N
    = 64 (Swin-T: 65 KB) and one at window 12 (214 KB, above the 48 KB
    default); bf16 at D = 32 and N <= 144 takes it, anything else the first
    design."""
    kp = want
    assert tattn.bwd_tc_smem_bytes(n) == 2 * 4 * kp * 40 * 2 + kp * (kp + 8) * 2 + 4 * kp * kp
    assert tattn.bwd_tc_smem_bytes(n) <= tattn._MAX_SMEM
    assert tattn.bwd_tc_blocks_per_sm(n) == (3 if kp <= 64 else
                                             max(1, 233_472 // (tattn.bwd_tc_smem_bytes(n) + 1024)))
    if kp <= 64:
        assert 3 * (tattn.bwd_tc_smem_bytes(n) + 1024) <= 233_472
    assert tattn.takes_tc(n, 32, torch.bfloat16)
    assert not tattn.takes_tc(n, 32, torch.float32)
    assert not tattn.takes_tc(n, 16, torch.bfloat16)


def test_bwd_tc_route_limits_and_windows_per_block():
    assert tattn.bwd_tc_smem_bytes(49) == 66_560
    assert 48 * 1024 < tattn.bwd_tc_smem_bytes(144) == 218_880 <= tattn._MAX_SMEM
    assert tattn.bwd_tc_blocks_per_sm(144) == 1
    assert not tattn.takes_tc(145, 32, torch.bfloat16)
    assert not tattn.takes_tc(0, 32, torch.bfloat16)
    # Swin-T's stages at batch 64 on 132 SMs fill 384 resident slots once
    for s in range(4):
        g, heads = 64 * (8 >> s) ** 2, 3 << s
        wpb = tattn.bwd_tc_windows_per_block(g, heads, 49, 132)
        assert heads * -(-g // wpb) == 384
    # window 12 (swin_base at 384 px, batch 16): one block an SM
    assert 4 * -(-256 // tattn.bwd_tc_windows_per_block(256, 4, 144, 132)) <= 132
    assert tattn.bwd_tc_windows_per_block(3, 24, 49, 132) == 1


@pytest.mark.parametrize("n,want", [(16, 16), (17, 32), (48, 48), (49, 64), (63, 64),
                                    (64, 64), (65, 80), (144, 144)])
def test_fwd_tc_sizing(n, want):
    """The forward's tensor-core design pads a window to KP = N rounded up
    to 16: its shared memory is the q/k/v ring alone, with no (N, N) term,
    and fits its blocks at every N it takes, four blocks an SM to N = 64
    (Swin-T: 30 KB) and one above; bf16 at D = 32 and N <= 144 takes it,
    anything else the first design."""
    kp = want
    assert tattn.fwd_tc_smem_bytes(n) == 2 * 3 * kp * 40 * 2
    assert tattn.fwd_tc_blocks_per_sm(n) == (4 if kp <= 64 else 1)
    assert tattn.fwd_tc_blocks_per_sm(n) * (tattn.fwd_tc_smem_bytes(n) + 1024) <= 233_472
    assert tattn.fwd_tc_smem_bytes(n) <= tattn._MAX_SMEM
    assert tattn.takes_tc(n, 32, torch.bfloat16)
    assert not tattn.takes_tc(n, 32, torch.float32)
    assert not tattn.takes_tc(n, 64, torch.bfloat16)


def test_fwd_tc_route_limits_and_windows_per_block():
    assert tattn.fwd_tc_smem_bytes(49) == 30_720
    assert 48 * 1024 < tattn.fwd_tc_smem_bytes(144) == 69_120 < tattn.smem_bytes(144, 32)
    assert not tattn.takes_tc(145, 32, torch.bfloat16)
    assert not tattn.takes_tc(0, 32, torch.bfloat16)
    # Swin-T's stages at bucket 64 on 132 SMs fill most of the 528 resident slots once
    for s, blocks in enumerate((513, 516, 516, 528)):
        g, heads = 64 * (8 >> s) ** 2, 3 << s
        wpb = tattn.fwd_tc_windows_per_block(g, heads, 49, 132)
        assert heads * -(-g // wpb) == blocks
    assert tattn.fwd_tc_windows_per_block(4096, 3, 49, 132) == 24
    # window 12 (swin_base at 384 px, batch 16): one block an SM
    assert 4 * -(-256 // tattn.fwd_tc_windows_per_block(256, 4, 144, 132)) <= 132
    assert tattn.fwd_tc_windows_per_block(3, 24, 49, 132) == 1


def test_packed_entry_on_cpu_counts_no_launch_of_either_design():
    """A bf16 CPU tensor at a shape the tensor-core design takes computes
    the plain version: neither launch count moves."""
    qkv, bias, mask = _inputs(4, 49, 2, 32, 2, seed=7)
    qkv = torch.from_numpy(qkv).bfloat16()
    bias, mask = torch.from_numpy(bias), torch.from_numpy(mask)
    before = tattn.fused_attention_qkv.launches, tattn.fused_attention_qkv.tc_launches
    got = tattn.fused_attention_qkv(qkv, bias, mask, 32 ** -0.5, 2)
    want = tattn.reference_attention(*_split(qkv, 64), bias, mask, 32 ** -0.5, 2)
    assert torch.equal(got, want)
    assert (tattn.fused_attention_qkv.launches, tattn.fused_attention_qkv.tc_launches) == before
