"""Host-side parts of the bottleneck chain's tensor-core route (K9/K10 on
``csrc/bottleneck_tc.cuh``), on the CPU.

- ``takes_tc``, the route's predicate: bf16 with C and M multiples of 32.
- The layout of the epilogues' partial sums: a numpy model of the kernels'
  pieces (a 128-row block tile's part of a run of rows, summed over its two
  64-row halves with four interleaved accumulators, the halves of a piece
  that spans row 64 added lower first) and of ``stats_finish``'s order
  (a tile's runs, each run's pieces in order), sized by ``chain_runs``,
  against ``_tile_moments`` at ResNet-50's three bands and two ragged ones,
  in the global and the ext layout. Every piece the finisher reads was
  written once.
- ``chain_scratch`` and ``chain_slabs``: the route's buffers at ResNet-50's
  stages (no f32 u3, da2 or da1, dz1 in du3's buffer; less than the first
  design's workspace) and slabs that are multiples of 32.
- The wrappers' choice of C entry through a fake kernel library on CPU
  tensors taken for CUDA ones: the route's entries and argument counts, the
  first design for f32 and off-grid widths, and the launch counters.

Tolerances: the model's statistics against ``_tile_moments`` 1e-5 relative
(two f32 summation orders over at most 1,120 rows).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from nkbx_torch.ops import bottleneck as tbn

G = 2
TILE_M = tbn.TC_TILE_M
# (B, H = W, th): ResNet-50's three bands at batch 4 (the band structure of
# batch 64's, fewer tiles), and ragged bands whose runs 128-row block tiles
# straddle at every offset
BANDS = [(4, 56, 8), (4, 28, 7), (4, 14, 2), (4, 10, 5), (2, 7, 1)]


@pytest.mark.parametrize("dtype,c,m,want", [
    (torch.bfloat16, 256, 64, True),
    (torch.bfloat16, 1024, 256, True),
    (torch.bfloat16, 96, 64, True),
    (torch.bfloat16, 64, 32, True),
    (torch.float32, 256, 64, False),
    (torch.bfloat16, 40, 32, False),
    (torch.bfloat16, 64, 24, False),
    (torch.bfloat16, 72, 96, False),
])
def test_route_predicate(dtype, c, m, want):
    assert tbn.takes_tc(dtype, c, m) is want


def _piece_sums(v, length, pieces, count):
    """The kernels' pieces of two sums (v and v², float32) of each column of
    v (rows of a product, in its row order), as ``run_sums`` writes them:
    (2, count * pieces, n), NaN where no piece was written."""
    rows, n = v.shape
    part = np.full((2, count * pieces, n), np.nan, np.float32)
    half = TILE_M // 2
    for m0 in range(0, rows, TILE_M):
        valid, blk = min(TILE_M, rows - m0), m0 // TILE_M
        split = valid > half and (m0 + half) % length != 0
        carry = None
        for h in (0, 1):
            r, r_end = h * half, min(valid, (h + 1) * half)
            while r < r_end:
                q, r0 = (m0 + r) // length, r
                end = min(r_end, (q + 1) * length - m0)
                a = np.zeros((4, n), np.float32)
                b = np.zeros((4, n), np.float32)
                while r + 4 <= end:
                    x = v[m0 + r:m0 + r + 4]
                    a += x
                    b += x * x
                    r += 4
                while r < end:
                    x = v[m0 + r]
                    a[0] += x
                    b[0] += x * x
                    r += 1
                s = np.stack([(a[0] + a[1]) + (a[2] + a[3]), (b[0] + b[1]) + (b[2] + b[3])])
                first = q * length // TILE_M
                assert 0 <= blk - first < pieces
                o = q * pieces + blk - first
                if split and h == 0 and end == half:
                    carry = s
                elif split and h == 1 and r0 == half:
                    assert np.isnan(part[:, o]).all()
                    part[:, o] = carry + s
                else:
                    assert np.isnan(part[:, o]).all()
                    part[:, o] = s
    return part


def _tile_totals(part, length, pieces, runs_of):
    """``stats_finish``'s sums: each tile's runs (``runs_of(t)``) in order,
    each run's pieces in order; (2, nt, n)."""
    out = []
    for runs in runs_of:
        s = np.zeros(part.shape[::2], np.float32)
        for q in runs:
            first, last = q * length // TILE_M, ((q + 1) * length - 1) // TILE_M
            for blk in range(first, last + 1):
                s = s + part[:, q * pieces + blk - first]
        out.append(s)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("b,h,th", BANDS)
def test_statistics_pieces_add_up_to_the_tile_moments(b, h, th):
    """The global layout (u1, u2, u3 and BN3's/BN2's backward sums): runs of
    one sample's th W rows; a tile's g runs at its band."""
    w, n = h, 3
    rng = np.random.default_rng(b * h + th)
    u = rng.standard_normal((b * h * w, n)).astype(np.float32) + 1.5
    length, pieces, count = tbn.chain_runs(b, h, w, G, th)
    assert (length, count) == (th * w, b * (h // th))
    part = _piece_sums(u, length, pieces, count)
    nh = h // th
    runs_of = [[((t // nh) * G + gi) * nh + t % nh for gi in range(G)]
               for t in range((b // G) * nh)]
    s, s2 = _tile_totals(part, length, pieces, runs_of)
    assert np.isfinite(s).all() and np.isfinite(s2).all()  # every piece read was written
    cnt = G * th * w
    mean = s / cnt
    var = np.maximum(s2 / cnt - mean * mean, 0)
    core = tbn._core_tiles(torch.from_numpy(u).reshape(b, h, w, n), G, th)
    want_mean, want_var = tbn._tile_moments(core, cnt)
    np.testing.assert_allclose(mean, want_mean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, want_var.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,h,th", BANDS)
def test_ext_pieces_add_up_to_each_tiles_sums(b, h, th):
    """The ext layout (BN1's backward sums over every ext row): runs of one
    tile's g (th + 2) W rows, a tile's single run."""
    w, n = h, 3
    nt = (b // G) * (h // th)
    rng = np.random.default_rng(7 * h + th)
    v = rng.standard_normal((nt * G * (th + 2) * w, n)).astype(np.float32)
    length, pieces, count = tbn.chain_runs(b, h, w, G, th, ext=True)
    assert (length, count) == (G * (th + 2) * w, nt)
    part = _piece_sums(v, length, pieces, count)
    s, s2 = _tile_totals(part, length, pieces, [[t] for t in range(nt)])
    want = v.reshape(nt, length, n)
    np.testing.assert_allclose(s, want.sum(1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2, (want * want).sum(1), rtol=1e-5, atol=1e-5)


RESNET50 = [(64, 56, 256, 64, 8), (64, 28, 512, 128, 7), (64, 14, 1024, 256, 2)]


@pytest.mark.parametrize("b,h,c,m,th", RESNET50)
def test_route_scratch_at_resnet50_stages(b, h, c, m, th):
    rows, nt = b * h * h, (b // G) * (h // th)
    ext = nt * G * (th + 2) * h
    fwd = tbn.chain_scratch(b, h, h, c, m, G, th)
    assert list(fwd) == ["u1", "a1", "u2", "a2", "part", "rstd"]
    bwd = tbn.chain_scratch(b, h, h, c, m, G, th, backward=True)
    assert list(bwd) == ["u1", "a1", "u2", "a2", "dy", "du3", "dz2", "du2", "du1", "sums", "part",
                         "wpart", "maps", "rstd"]
    f32, bf = torch.float32, torch.bfloat16
    want = {"u1": (rows * m, f32), "a1": (ext * m, bf), "u2": (rows * m, f32),
            "a2": (rows * m, bf), "dy": (rows * c, bf),
            "du3": (max(rows * c, 2 * ext * m), bf),  # then dz1, (ext, m) f32
            "dz2": (rows * m, f32), "du2": (rows * m, bf),
            "du1": (ext * m, bf), "sums": (2 * nt * max(c, m), f32),
            "maps": (rows + ext, torch.int32), "rstd": (nt * (2 * m + c), f32)}
    for k, v in want.items():
        assert bwd[k] == v, k
        if k in fwd:
            assert fwd[k] == v, k
    # the runs' partials: two planes of the larger layout
    g_len, g_pieces, g_count = tbn.chain_runs(b, h, h, G, th)
    e_len, e_pieces, e_count = tbn.chain_runs(b, h, h, G, th, ext=True)
    assert fwd["part"] == bwd["part"] == (max(2 * g_count * g_pieces * c,
                                              2 * e_count * e_pieces * m), f32)
    # no f32 buffer of C-wide rows (u3) and none of M-wide rows beyond u1, u2, dz2, dz1
    assert not any(n >= rows * c and dt == f32 for k, (n, dt) in bwd.items())
    # every weight gradient's slab partials fit
    s3, s2, s1 = tbn.chain_slabs(b, h, h, c, m, G, th)
    assert all(s % 32 == 0 and s > 0 for s in (s3, s2, s1))
    assert bwd["wpart"][0] >= max(-(-rows // s3) * c * m, -(-rows // s2) * 9 * m * m,
                                  -(-ext // s1) * c * m)

    def nbytes(d):
        return sum(n * torch.empty(0, dtype=dt).element_size() for n, dt in d.values())

    first = (2 * rows * m * 4 + ext * m * 2 + rows * m * 2 + rows * c * 4  # u1 u2 a1 a2 u3
             + 2 * rows * c * 2 + rows * m * (4 + 2) + ext * m * (4 + 2))  # dy du3 da2 du2 da1 du1
    assert nbytes(bwd) < first


def test_route_scratch_at_stage_1_is_pinned():
    """ResNet-50's stage 1 at batch 64, in bytes: the route's forward and
    backward workspaces."""
    fwd = tbn.chain_scratch(64, 56, 56, 256, 64, G, 8)
    bwd = tbn.chain_scratch(64, 56, 56, 256, 64, G, 8, backward=True)

    def nbytes(d):
        return sum(n * torch.empty(0, dtype=dt).element_size() for n, dt in d.values())

    assert nbytes(fwd) == 165_494_784
    assert nbytes(bwd) == 495_308_800  # the first design's: 745,013,248 and its partials


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
    monkeypatch.setattr(tbn._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _inputs(b, h, c, m, dtype):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    args = [t(b, h, h, c).to(dtype), t(c, m).to(dtype), t(3, 3, m, m).to(dtype),
            t(m, c).to(dtype), t(m), t(m), t(m), t(m), t(c), t(c)]
    return args, t(b, h, h, c).to(dtype)


@pytest.mark.parametrize("dtype,c,m,entry", [
    (torch.bfloat16, 64, 32, "nkbx_chain_fwd_gemm"),
    (torch.bfloat16, 96, 64, "nkbx_chain_fwd_gemm"),
    (torch.float32, 64, 32, "nkbx_chain_fwd"),
    (torch.bfloat16, 40, 32, "nkbx_chain_fwd"),
])
def test_forward_takes_the_route_only_where_it_applies(fake_card, dtype, c, m, entry):
    args, _ = _inputs(4, 10, c, m, dtype)
    before = tbn.fused_chain.launches, tbn.fused_chain.tc_launches
    tbn.fused_chain_fwd(*args, g=G, th=5)
    (name, cargs), = fake_card.calls
    assert name == entry and len(cargs) == len(tbn._FWD_SIGNATURES[name])
    tc = entry == "nkbx_chain_fwd_gemm"
    assert (tbn.fused_chain.launches, tbn.fused_chain.tc_launches) == (before[0] + 1,
                                                                      before[1] + tc)
    # the geometry and eps, before the stream (and the first design's dtype flag)
    assert (cargs[-9:-1] if tc else cargs[-10:-2]) == (4, 10, 10, c, m, G, 5, 1e-5)


@pytest.mark.parametrize("dtype,c,m,entry", [
    (torch.bfloat16, 64, 32, "nkbx_chain_bwd_gemm"),
    (torch.float32, 64, 32, "nkbx_chain_bwd"),
    (torch.bfloat16, 64, 24, "nkbx_chain_bwd"),
])
def test_backward_takes_the_route_only_where_it_applies(fake_card, dtype, c, m, entry):
    args, dout = _inputs(4, 10, c, m, dtype)
    before = tbn.fused_chain_bwd.launches, tbn.fused_chain_bwd.tc_launches
    grads = tbn.fused_chain_bwd(*args, dout, g=G, th=5)
    (name, cargs), = fake_card.calls
    assert name == entry and len(cargs) == len(tbn._BWD_SIGNATURES[name])
    tc = entry == "nkbx_chain_bwd_gemm"
    assert (tbn.fused_chain_bwd.launches, tbn.fused_chain_bwd.tc_launches) == (
        before[0] + 1, before[1] + tc)
    assert len(grads) == 10 and grads[0].shape == args[0].shape
    if tc:  # the geometry, then the slabs of dw3, dw2 and dw1
        assert cargs[-12:-2] == (4, 10, 10, c, m, G, 5,
                                 *tbn.chain_slabs(4, 10, 10, c, m, G, 5))


def test_the_launch_helpers_refuse_the_route_where_it_does_not_apply(fake_card):
    args, dout = _inputs(4, 10, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="multiples of 32"):
        tbn._forward(*args, g=G, th=5, eps=1e-5, tc=True)
    with pytest.raises(ValueError, match="multiples of 32"):
        tbn._backward(*args, dout, g=G, th=5, eps=1e-5, tc=True)
    assert not fake_card.calls
    bargs = [a.to(torch.bfloat16) if i < 4 else a for i, a in enumerate(args)]
    tbn._forward(*bargs, g=G, th=5, eps=1e-5, tc=False)  # the first design stays reachable
    assert [n for n, _ in fake_card.calls] == ["nkbx_chain_fwd"]
