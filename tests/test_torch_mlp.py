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

import contextlib
import types

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
    (torch.bfloat16, 96, 384, True), (torch.bfloat16, 192, 768, True),
    (torch.bfloat16, 384, 1536, True), (torch.bfloat16, 768, 3072, True),
    (torch.float32, 96, 384, False), (torch.float32, 768, 3072, False),
    (torch.bfloat16, 40, 160, False), (torch.bfloat16, 48, 192, False),
    (torch.bfloat16, 96, 96, False)])
def test_tensor_core_kernel_takes_bf16_at_aligned_widths(dtype, c, f, want):
    # also the predicate of K5's and K6's GEMM route
    assert tmlp.tensor_cores(dtype, c, f) is want


@pytest.mark.parametrize("env_mlp,env_ln,flag,on_cuda,want", [
    ("", "", None, False, None),
    ("", "", None, True, "ln"),
    ("", "", True, False, "ln"),
    ("", "", False, True, None),
    ("0", "", True, True, None),
    ("1", "", False, False, "ln"),
    ("", "0", None, True, "mlp"),  # nkbx's MLP-only kernels (K7/K8)
])
def test_fused_mlp_mode_precedence(monkeypatch, env_mlp, env_ln, flag, on_cuda, want):
    monkeypatch.setenv("NKBX_FUSED_MLP", env_mlp)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", env_ln)

    x = torch.zeros(2, 96, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", on_cuda)
    assert tmlp.fused_mlp_mode(flag, x, 384) == want


def test_mode_is_plain_where_no_tile_fits():
    assert tmlp.fused_mlp_mode(True, torch.zeros(2, 4096), 16384) is None


# --- the GEMM route of K5 and K6 (bf16 at the tensor-core widths) -----------------


class _FakeLib:
    """Records the C entries a wrapper calls and their arguments; every
    call reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors that the wrappers take for CUDA ones, and a fake kernel
    library: the launch path runs up to the C entry, which is recorded."""
    lib = _FakeLib()
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    monkeypatch.setattr(tmlp, "_sms", lambda dev: 132)
    monkeypatch.setattr(tmlp._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _route_inputs(r, c, dt, gamma):
    a = _inputs(r, c, 4 * c, seed=3, gamma=gamma)
    args, g = _order(a, _torch, dt)
    return args, g, torch.from_numpy(a["x"]).to(dt)


@pytest.mark.parametrize("r,c,dt,gamma,entry", [
    (300, 96, torch.bfloat16, False, "nkbx_ln_mlp_gemm"),
    (49, 768, torch.bfloat16, True, "nkbx_ln_mlp_gemm"),
    (300, 96, torch.float32, False, "nkbx_ln_mlp"),
    (300, 40, torch.bfloat16, True, "nkbx_ln_mlp"),
])
def test_forward_takes_the_gemm_route_only_where_it_applies(fake_card, r, c, dt, gamma, entry):
    args, g, _ = _route_inputs(r, c, dt, gamma)
    before = tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches
    tmlp.fused_ln_mlp(*args, gamma=g, eps=1e-5)
    (name, cargs), = fake_card.calls
    assert name == entry and len(cargs) == len(tmlp._SIGNATURES[name])
    gemm = entry == "nkbx_ln_mlp_gemm"
    assert (tmlp.fused_ln_mlp.launches, tmlp.fused_ln_mlp.gemm_launches) == (
        before[0] + 1, before[1] + gemm)
    if gemm:  # rows, C, F, then the depth of g·w1's slabs of K
        assert cargs[13:17] == (r, c, 4 * c, tmlp.gemm_slabs(r, c, 4 * c)["g·w1"])
    else:  # the first design: tensor cores off for f32 and C = 40
        assert cargs[-2] == 0


@pytest.mark.parametrize("r,c,dt,gamma,entry", [
    (300, 96, torch.bfloat16, True, "nkbx_ln_mlp_bwd_gemm"),
    (1576, 768, torch.bfloat16, False, "nkbx_ln_mlp_bwd_gemm"),
    (300, 96, torch.float32, True, "nkbx_ln_mlp_bwd"),
    (300, 40, torch.bfloat16, False, "nkbx_ln_mlp_bwd"),
])
def test_backward_takes_the_gemm_route_only_where_it_applies(fake_card, r, c, dt, gamma, entry):
    args, g, dy = _route_inputs(r, c, dt, gamma)
    before = tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches
    out = tmlp.fused_ln_mlp_bwd(*args[:7], g, dy, eps=1e-5)
    (name, cargs), = fake_card.calls
    assert name == entry and len(cargs) == len(tmlp._BWD_SIGNATURES[name])
    gemm = entry == "nkbx_ln_mlp_bwd_gemm"
    assert (tmlp.fused_ln_mlp_bwd.launches, tmlp.fused_ln_mlp_bwd.gemm_launches) == (
        before[0] + 1, before[1] + gemm)
    assert (out[7] is None) is (not gamma)
    if gemm:  # rows, C, F, the slab depths of du·w0ᵀ and of the weight gradients, eps, gamma
        sl = tmlp.gemm_slabs(r, c, 4 * c)
        assert cargs[25:30] == (r, c, 4 * c, sl["du·w0ᵀ"], sl["wgrad"])
        assert cargs[31] == int(gamma)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_mlp_only_kernels_keep_their_first_design(fake_card, dt):
    """K7 and K8 (the MLP alone, under NKBX_FUSED_LN_MLP=0) never take the
    GEMM route: their own C entries, tensor cores on in bf16."""
    args, _, dy = _route_inputs(300, 96, dt, False)
    x, _, _, w0, b0, w1, b1, _ = args
    gemm = tmlp.fused_ln_mlp.gemm_launches, tmlp.fused_ln_mlp_bwd.gemm_launches
    tmlp.fused_mlp(x, w0, b0, w1, b1)
    tmlp.fused_mlp_bwd(x, w0, b0, w1, b1, dy)
    assert [n for n, _ in fake_card.calls] == ["nkbx_mlp", "nkbx_mlp_bwd"]
    assert fake_card.calls[0][1][-2] == int(dt == torch.bfloat16)
    assert (tmlp.fused_ln_mlp.gemm_launches, tmlp.fused_ln_mlp_bwd.gemm_launches) == gemm


@pytest.mark.parametrize("depth,slab", [(3072, 1024), (3072, 512), (200704, 2688), (1576, 1600),
                                        (197, 224), (96, 32), (1000, 96)])
def test_slabs_cover_every_row_once_in_order(depth, slab):
    ranges = tmlp.slab_ranges(depth, slab)
    assert ranges[0][0] == 0 and ranges[-1][1] == depth
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 < e - s <= slab for s, e in ranges)
    assert len(ranges) == -(-depth // slab)


@pytest.mark.parametrize("shape,slabs", [
    # (R, C): slabs of g·w1, du·w0ᵀ, the weight gradients on 132 SMs
    ((200704, 96), (1, 1, 66)), ((50176, 192), (1, 1, 17)), ((12544, 384), (3, 3, 6)),
    ((3136, 768), (3, 3, 3)), ((12608, 768), (1, 1, 3)), ((1576, 768), (3, 3, 1)),
    ((197, 768), (6, 6, 1)), ((1, 96), (1, 1, 1))])
def test_split_of_k_at_the_models_shapes(shape, slabs):
    r, c = shape
    f = 4 * c
    sl = tmlp.gemm_slabs(r, c, f)
    got = tuple(len(tmlp.slab_ranges(d, sl[k]))
                for k, d in (("g·w1", f), ("du·w0ᵀ", f), ("wgrad", r)))
    assert got == slabs
    assert all(v % tmlp.GEMM_SLAB_K == 0 for v in sl.values())
    assert sl["g·w1"] >= min(f, 512) and sl["wgrad"] >= min(r, 1024)


def test_split_depth_fills_the_waves():
    # 300 tiles on 264 resident slots: 1 slab fills 57% of its waves, 2 slabs 76%
    assert tmlp.split_depth(300, 3072, 512) == 1536
    assert tmlp.split_depth(1188, 3072, 512) == 3072  # 90% full unsplit
    assert tmlp.split_depth(300, 1024, 512) == 512  # no slab under the least depth
    assert tmlp.split_depth(300, 3072, 512, sms=150) == 3072  # 300 blocks fill 300 slots


@pytest.mark.parametrize("r,c,backward,gamma,want", [
    (12608, 768, False, False, [("ln_mlp_layernorm_kernel", 1576), ("ln_mlp_gemm_kernel", 2376),
                                ("ln_mlp_gemm_kernel", 594)]),
    (3136, 768, False, True, [("ln_mlp_layernorm_kernel", 392), ("ln_mlp_gemm_kernel", 600),
                              ("ln_mlp_gemm_kernel", 450), ("ln_mlp_fc2_finish_kernel", 4704)]),
    (1576, 768, True, False, [("ln_mlp_bwd_rows_kernel", 197), ("ln_mlp_bwd_db1_kernel", 300),
                              ("ln_mlp_bwd_dual_kernel", 624), ("ln_mlp_bwd_gemm_kernel", 234),
                              ("ln_mlp_bwd_lnb_kernel", 197), ("ln_mlp_bwd_colsum_kernel", 48),
                              ("ln_mlp_bwd_colsum_kernel", 24), ("ln_mlp_bwd_colsum_kernel", 96),
                              ("ln_mlp_bwd_gemm_kernel", 144), ("ln_mlp_bwd_gemm_kernel", 144)]),
    (1000, 96, True, True, [("ln_mlp_bwd_rows_kernel", 125), ("ln_mlp_bwd_db1_kernel", 32),
                            ("ln_mlp_bwd_dual_kernel", 48), ("ln_mlp_bwd_gemm_kernel", 8),
                            ("ln_mlp_bwd_gemm_kernel", 8), ("ln_mlp_bwd_lnb_kernel", 125),
                            ("ln_mlp_bwd_colsum_kernel", 6), ("ln_mlp_bwd_colsum_kernel", 3),
                            ("ln_mlp_bwd_colsum_kernel", 3), ("ln_mlp_bwd_colsum_kernel", 12),
                            ("ln_mlp_bwd_gemm_kernel", 3), ("ln_mlp_bwd_gemm_kernel", 3)]),
])
def test_gemm_plan_block_grids(r, c, backward, gamma, want):
    plan = tmlp.gemm_plan(r, c, 4 * c, backward=backward, has_gamma=gamma)
    assert [(k, blocks) for k, _, blocks in plan] == want


@pytest.mark.parametrize("r,c,gamma", [(12608, 768, False), (3136, 768, True), (1, 96, True),
                                       (200704, 96, False)])
def test_gemm_scratch_sizes(r, c, gamma):
    f = 4 * c
    sl = tmlp.gemm_slabs(r, c, f)
    fwd = tmlp.gemm_scratch(r, c, f)
    n_fc2 = len(tmlp.slab_ranges(f, sl["g·w1"]))
    assert fwd == {"h": ((r, c), torch.bfloat16), "g": ((r, f), torch.bfloat16),
                   "part": ((n_fc2 if n_fc2 > 1 else 0, r, c), torch.float32)}
    bwd = tmlp.gemm_scratch(r, c, f, backward=True, has_gamma=gamma)
    n_dh = len(tmlp.slab_ranges(f, sl["du·w0ᵀ"]))
    n_w = len(tmlp.slab_ranges(r, sl["wgrad"]))
    tiles, tiles_m = -(-r // 64), -(-r // 128)
    assert list(bwd) == ["h", "dy2", "gact", "du", "dh", "stats", "part_c", "part_b1", "part_g",
                         "part_f", "part_w"]
    assert bwd["dh"][0] == (n_dh, r, c) and bwd["part_c"][0] == (2, n_dh * tiles_m, c)
    assert bwd["part_b1"][0] == (tiles, c) and bwd["part_f"][0] == (tiles_m, f)
    assert bwd["part_g"][0] == ((tiles_m if gamma else 0), c)
    assert bwd["part_w"][0] == ((n_w if n_w > 1 else 0), c * f)
    assert all(bwd[k][1] == torch.bfloat16 for k in ("h", "dy2", "gact", "du"))


@pytest.mark.parametrize("c,dtype,want", [
    (96, torch.bfloat16, "ln"), (768, torch.bfloat16, "ln"), (1536, torch.bfloat16, None),
    (96, torch.float32, "ln"), (768, torch.float32, "ln"), (1536, torch.float32, None)])
def test_fused_mlp_mode_answers_are_unchanged(monkeypatch, c, dtype, want):
    """The route does not move the gate: it mirrors nkbx's, by shared memory
    of the first design (C = 1536 fits no backward tile)."""
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.delenv("NKBX_FUSED_LN_MLP", raising=False)
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    assert tmlp.fused_mlp_mode(None, torch.zeros(2, c, dtype=dtype), 4 * c) == want


@pytest.mark.parametrize("x_dt,c,f,w0_shape,err", [
    (torch.float32, 96, 384, None, TypeError),
    (torch.float16, 96, 384, None, TypeError),
    (torch.bfloat16, 40, 160, None, ValueError),
    (torch.bfloat16, 96, 96, None, ValueError),
    (torch.bfloat16, 96, 384, (384, 96), ValueError),
])
def test_gemm_route_refuses_what_it_cannot_take(x_dt, c, f, w0_shape, err):
    x = torch.zeros(4, c, dtype=x_dt)
    w0 = torch.zeros(w0_shape or (c, f), dtype=x_dt)
    w1 = torch.zeros(f, c, dtype=x_dt)
    with pytest.raises(err):
        tmlp.check_gemm_operands(x, w0, w1)


@pytest.mark.parametrize("bad", ["dtype", "w1_dtype", "shortcut"])
def test_wrapper_refuses_mistyped_inputs(fake_card, bad):
    args, g, _ = _route_inputs(64, 96, torch.bfloat16, False)
    if bad == "dtype":
        args = [a.half() if a.dtype == torch.bfloat16 else a for a in args]
    elif bad == "w1_dtype":
        args[5] = args[5].float()
    else:
        args[7] = args[7][:, :48]
    with pytest.raises((TypeError, ValueError)):
        tmlp.fused_ln_mlp(*args, gamma=g, eps=1e-5)
    assert fake_card.calls == []
