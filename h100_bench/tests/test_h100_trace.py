"""The trace arithmetic: busy time is the union of the device's intervals,
idle gaps are named by the innermost host span, a chrome trace parses."""

import pytest

from h100_bench import trace

K = "void (anonymous namespace)::ln_mlp_gemm_kernel<1>(Args)"


def test_overlapping_kernels_count_once():
    # 0-40 and 20-60 overlap; 70-80 alone; a copy 90-95; the stretch 0-100 us
    dev = [(K, "port kernels", 0.0, 40.0), ("gemm_a", "cublas gemm", 20.0, 40.0),
           ("gemm_b", "cublas gemm", 70.0, 10.0), ("Memcpy HtoD (Pageable -> Device)",
                                                   "copies/memset", 90.0, 5.0)]
    t = trace.Trace(dev, [], 0.0, 100.0)
    assert t.busy_s() == pytest.approx(75e-6)
    assert t.idle_gaps() == [(60.0, 70.0), (80.0, 90.0), (95.0, 100.0)]
    assert t.kernel_s(["ln_mlp_gemm_kernel"]) == pytest.approx(40e-6)
    assert t.kernel_s(["gemm_kernel"]) == 0.0  # names match whole


def test_intervals_are_clipped_to_the_stretch():
    t = trace.Trace([("k", "other", -50.0, 100.0), ("k", "other", 90.0, 50.0)], [], 0.0, 100.0)
    assert t.busy_s() == pytest.approx(60e-6)


def test_idle_gaps_take_the_innermost_host_span():
    host = [("aten::linear", 0.0, 100.0), ("aten::addmm", 55.0, 20.0), ("cudaLaunchKernel", 90.0, 2.0)]
    t = trace.Trace([("k", "other", 0.0, 50.0), ("k", "other", 80.0, 20.0)], host, 0.0, 100.0)
    assert t.host_at(65.0) == "aten::addmm"
    assert t.host_at(78.0) == "aten::linear"
    assert t.host_at(150.0) == "python"
    b = t.breakdown()
    assert b["idle_gaps"] == [["aten::addmm", pytest.approx(30e-6)]]
    assert b["device_ops"] == [["other: k", pytest.approx(70e-6)]]


def test_categories_follow_the_program_kernel_names():
    assert trace.categorize(K) == "port kernels"
    assert trace.categorize("void at::native::multi_tensor_apply_kernel<X>(Y)") == \
        "optimizer foreach"
    assert trace.categorize("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == "cublas gemm"
    assert trace.categorize("Memcpy HtoD (Pageable -> Device)") == "copies/memset"
    assert trace.short_name(K) == "ln_mlp_gemm_kernel"


def test_a_chrome_trace_parses_with_and_without_the_host():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": 100, "dur": 50,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 105, "dur": 10, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 105, "dur": 10, "tid": 2},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 110, "dur": 20},
          {"ph": "X", "cat": "gpu_user_annotation", "name": trace.STRETCH, "ts": 110, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 400, "dur": 20}]
    t = trace.parse(ev)
    assert (t.start, t.end) == (100.0, 150.0)
    assert [d[0] for d in t.device] == ["gemm"]
    assert t.host == [("aten::mm", 105.0, 10.0)]
    assert t.busy_s() / t.wall_s == pytest.approx(20 / 50)
    alone = trace.parse([e for e in ev if e["cat"] == "kernel"][:1], wall_us=40.0)
    assert (alone.start, alone.end) == (110.0, 150.0)
    with pytest.raises(ValueError):
        trace.parse([])


def test_capture_on_the_cpu_finds_no_device_work():
    import torch

    t = trace.capture(lambda: torch.ones(8).sum())
    assert t.device == [] and t.wall_s > 0
