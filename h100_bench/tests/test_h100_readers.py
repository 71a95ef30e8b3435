"""Every per-layer metric's reader on a synthetic trace, in every cell
that lists it: each returns a finite number, and a share stays in
(0, 100]."""

import math

import pytest

from h100_bench import spec, trace
from h100_bench.drivers import Context


def _trace(ln_s=0.5, attn_s=0.2):
    dev = [("void (anonymous namespace)::ln_mlp_gemm_kernel<64>(Args)", 0.0, ln_s * 1e6),
           ("void (anonymous namespace)::ln_mlp_bwd_gemm_kernel<64>(Args)", 0.0, ln_s * 1e6),
           ("void (anonymous namespace)::attention_fwd_tc<64>(Args)", 1e5, attn_s * 1e6),
           ("void (anonymous namespace)::attention_bwd_rows_tc(Args)", 1.5e6, attn_s * 1e6),
           ("void at::native::multi_tensor_apply_kernel<X>(Y)", 2e5, 3e3),
           ("Memcpy HtoD (Pageable -> Device)", 3e5, 5e2)]
    device = [(n, trace.categorize(n), s, d) for n, s, d in dev]
    return trace.Trace(device, [("aten::copy_", 0.0, 3e6)], 0.0, 3e6)


@pytest.mark.parametrize("cell_name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_every_reader_reads_a_synthetic_trace(cell_name):
    cell = spec.cell(cell_name)
    train = cell.mix["kind"] == "train"
    batches = [cell.mix["batch"]] * 6 if train else list(range(8, 97))
    ctx = Context(cell=cell, device_name="NVIDIA H100 80GB HBM3", train=train, window_s=20.0,
                  window_images=128 * 180, peak_window_bytes=13 * 2**30,
                  trace=_trace(), trace_batches=batches, capacity_s=20.0,
                  capacity_images=50000)
    assert cell.per_layer
    for m in cell.per_layer:
        value = spec.reader(m["name"])(ctx)
        assert value is not None and math.isfinite(value), m["name"]
        if m["unit"] == "%":
            assert 0 < value <= 100, (m["name"], value)


def test_readers_find_nothing_without_a_trace():
    cell = spec.cell("vit_b16.train.b128")
    ctx = Context(cell=cell, device_name="cpu", train=True)
    for m in cell.per_layer:
        assert spec.reader(m["name"])(ctx) is None, m["name"]
