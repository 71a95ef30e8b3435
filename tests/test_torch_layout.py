"""The port's counterparts of nkbx's Swin layout probes (X3-X7,
``nkbx_torch.ops.layout``) on the CPU, against the probes' own Pallas
kernels in interpret mode, from the same numpy inputs.

- X3/X4: ``r3_layout_tax.stream`` and ``transpose_in_kernel`` (they
  interpret off the TPU) at each swin_tiny stage's N and C with G = 16.
- X5/X6: ``gather_kernel`` and ``scatter_kernel`` through
  ``pl.pallas_call(..., interpret=True)``, as the probe's
  ``check_gather_semantics`` runs them, on three (7, 56, 288) stripes.
- X7: the five bodies of ``r3_map_attention_probe2`` (``k_reshape``,
  ``k_rowconcat``, ``k_scratch`` with its VMEM scratch, ``k_split``,
  ``k_pad8``) through ``pallas_call(interpret=True)`` on (4, 7, 7, 288)
  blocks (the probe's ``DTYPE``, which k_pad8's zeros take, set to the
  case's dtype).

These are copies and permutations: every comparison is exact, in f32 and
in bf16. The wrappers' refusals and the library calls (the yardsticks of
chip_smoke.py) are checked too.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import r3_layout_tax as jtax  # noqa: E402
import r3_map_attention_probe as jmap  # noqa: E402
import r3_map_attention_probe2 as jmap2  # noqa: E402
from nkbx_torch.ops import layout as L  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pair(shape, jdt, tdt, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _same(got, want):
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("stage", L.STAGES, ids=[s[0] for s in L.STAGES])
def test_stream_and_transpose_match_the_probe(jdt, tdt, stage):
    _, _, n, c = stage
    g = 16
    jx, tx = _pair((g, n, c), jdt, tdt)
    _same(L.stream(tx), jtax.stream(jx, jtax._pick_w(g)))
    jxt, txt = jnp.transpose(jx, (1, 2, 0)), tx.permute(1, 2, 0).contiguous()
    _same(L.transpose_in_kernel(txt), jtax.transpose_in_kernel(jxt, jtax._pick_w(g)))


def _probe_call(kernel, x, in_block, out_block, jdt, scratch=None):
    imap_in = lambda i: (i,) + (0,) * (len(in_block) - 1)  # noqa: E731
    imap_out = lambda i: (i,) + (0,) * (len(out_block) - 1)  # noqa: E731
    kw = {"scratch_shapes": [pltpu.VMEM(scratch, jdt)]} if scratch else {}
    return pl.pallas_call(kernel, grid=(x.shape[0],),
                          in_specs=[pl.BlockSpec(in_block, imap_in)],
                          out_specs=pl.BlockSpec(out_block, imap_out),
                          out_shape=jax.ShapeDtypeStruct((x.shape[0],) + out_block[1:], jdt),
                          interpret=True, **kw)(x)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_window_gather_and_scatter_match_the_probe(jdt, tdt):
    k, n, c3 = jmap.K, jmap.N, jmap.C3
    jx, tx = _pair((3, 7, 7 * k, c3), jdt, tdt, seed=1)
    want = _probe_call(jmap.gather_kernel, jx, (1, 7, 7 * k, c3), (1, k, n, c3), jdt)
    got = L.gather_windows(tx)
    assert got.shape == (3, k, n, c3)
    _same(got, want)
    back = _probe_call(jmap.scatter_kernel, want, (1, k, n, c3), (1, 7, 7 * k, c3), jdt)
    _same(L.scatter_windows(got), back)
    _same(L.scatter_windows(got), jx)


X7_BODIES = [  # (probe body, port function, input block, output block, scratch)
    ("k_reshape", L.merge_windows, (1, 7, 7, 288), (1, 49, 288), None),
    ("k_rowconcat", L.merge_windows, (1, 7, 7, 288), (1, 49, 288), None),
    ("k_scratch", L.merge_windows, (1, 7, 7, 288), (1, 49, 288), (56, 288)),
    ("k_split", L.split_windows, (1, 49, 288), (1, 7, 7, 288), None),
    ("k_pad8", L.pad8, (1, 7, 7, 288), (1, 56, 288), None),
]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("body,fn,in_block,out_block,scratch", X7_BODIES,
                         ids=[b[0] for b in X7_BODIES])
def test_x7_bodies_match_the_probe(monkeypatch, jdt, tdt, body, fn, in_block, out_block,
                                  scratch):
    monkeypatch.setattr(jmap2, "DTYPE", jdt)  # k_pad8's zeros take the probe's dtype
    jx, tx = _pair((4,) + in_block[1:], jdt, tdt, seed=2)
    want = _probe_call(getattr(jmap2, body), jx, in_block, out_block, jdt, scratch)
    got = fn(tx)
    assert got.shape == want.shape and got.dtype == tdt
    _same(got, want)


def test_pad8_rows_and_zeros():
    x = torch.randn(2, 7, 7, 8)
    out = L.pad8(x).view(2, 7, 8, 8)
    assert torch.equal(out[:, :, :7], x) and not out[:, :, 7].any()


@pytest.mark.parametrize("k,c3", [(1, 3), (3, 5), (8, 288)])
def test_window_permutations_at_other_widths(k, c3):
    """The plain versions' index tables (layout.cu's source_row) at widths
    off the probe's, against the library's view/permute."""
    x = torch.randn(2, 7, 7 * k, c3)
    w = L.gather_windows(x)
    assert torch.equal(w, L.library_gather_windows(x))
    assert torch.equal(L.scatter_windows(w), x)
    assert torch.equal(L.library_scatter_windows(w), x)


def test_plain_versions_equal_the_library_calls_and_return_fresh_tensors():
    for row, name, fn, plain, library, shape in L.probe_cases(small=True):
        x = L.inputs(shape, torch.bfloat16, "cpu")
        got = fn(x)
        assert torch.equal(got, library(x)), (row, name)
        assert got.data_ptr() != x.data_ptr(), (row, name)


def test_probe_cli_runs_on_the_cpu(capsys):
    rows = L.main(device="cpu")
    assert len(rows) == len(L.probe_cases()) and all(r["equal"] for r in rows)
    assert "plain equals the library call: True" in capsys.readouterr().out


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="dim 1"):
        L.gather_windows(torch.zeros(2, 6, 14, 8))
    with pytest.raises(ValueError, match="multiple of 7"):
        L.gather_windows(torch.zeros(2, 7, 15, 8))
    with pytest.raises(ValueError, match="dim 2"):
        L.scatter_windows(torch.zeros(2, 3, 48, 8))
    with pytest.raises(ValueError, match="3-d"):
        L.transpose_in_kernel(torch.zeros(4, 5))
    with pytest.raises(ValueError, match="dim 1"):
        L.split_windows(torch.zeros(2, 50, 8))
