"""The port's trace aggregation (``nkbx_torch/core/profiling.py``) and
``profile_trace`` (``nkbx_torch/core/runtime.py``), mirroring
``tests/test_profiling.py`` for nkbx's, on the CPU.

- Synthetic chrome traces in torch.profiler's format: the device events
  (``kernel``, ``gpu_memcpy``, ``gpu_memset``) summed by name and by kind,
  host events left out, names largest first, the ``extra_category`` hook,
  the newest trace under a directory, ``.json`` and ``.json.gz``; a
  directory without a trace raises.
- The breakdown's text is nkbx's ``format_breakdown``'s for the same table.
- The kinds of CUDA kernel names: the port's own (named from the
  ``__global__`` functions of ``nkbx_torch/ops/csrc``), cuDNN, cuBLAS,
  reductions, elementwise, the optimizer's foreach, copies and memsets.
- ``kernel_ms`` reads the same ms from a trace's ``by_name`` as from
  ``key_averages`` events (stand-ins here), K7/K8 by K5/K6's names.
- ``profile_trace(device="cpu")`` writes a trace that ``aggregate_trace``
  reads (CPU operators only, no device time); without a card the default
  device raises. The CLI in a subprocess prints the breakdown.
"""

import gzip
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from nkbx.core.profiling import format_breakdown as jformat_breakdown
from nkbx_torch.core import profiling as P
from nkbx_torch.core.runtime import profile_trace

REPO = Path(__file__).resolve().parent.parent

K5 = "void (anonymous namespace)::ln_mlp_gemm_kernel<128, 64, 2>(Params)"
K6 = "void (anonymous namespace)::ln_mlp_bwd_gemm_kernel<128, 64>(Params)"
K9 = "void chain::tc::chain_gemm<4>(chain::Args)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
NVJET = "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT"
REDUCE = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>(...)"
FOREACH = "void at::native::multi_tensor_apply_kernel<at::native::FpAdd>(...)"
MEMCPY = "Memcpy DtoD (Device -> Device)"


def _events():
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "dur": 99000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 7000},
        {"ph": "X", "cat": "kernel", "name": K5, "dur": 3000},
        {"ph": "X", "cat": "kernel", "name": K5, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": K6, "dur": 2500},
        {"ph": "X", "cat": "kernel", "name": CUDNN, "dur": 5000},
        {"ph": "X", "cat": "kernel", "name": NVJET, "dur": 500},
        {"ph": "X", "cat": "gpu_memcpy", "name": MEMCPY, "dur": 250},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 250},
        {"ph": "i", "cat": "kernel", "name": K5, "s": "t"},
    ]


def _write(path, events, gz=True):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "run" / "traces"
    d.mkdir(parents=True)
    _write(d / "old.json.gz", _events()[:3])
    time.sleep(0.01)
    _write(d / "trace_1.json.gz", _events())
    os.utime(d / "old.json.gz", (1, 1))
    return tmp_path / "run"


def test_aggregate_sums_and_filters(trace_dir):
    agg = P.aggregate_trace(trace_dir)
    assert agg["total_ms"] == pytest.approx(12.5)  # host and instant events left out
    assert agg["by_name"][K5] == pytest.approx(4.0)
    assert "aten::linear" not in agg["by_name"] and "cudaLaunchKernel" not in agg["by_name"]
    assert list(agg["by_name"])[0] == CUDNN
    assert agg["by_category"] == pytest.approx({
        "port kernels": 6.5, "cudnn convolution": 5.0, "cublas gemm": 0.5,
        "copies/memset": 0.5})
    assert list(agg["by_category"]) == ["port kernels", "cudnn convolution", "cublas gemm",
                                        "copies/memset"]


def test_plain_json_and_host_operators(tmp_path):
    _write(tmp_path / "t.json", _events(), gz=False)
    agg = P.aggregate_trace(tmp_path / "t.json")
    assert agg["total_ms"] == pytest.approx(12.5) and agg["events"] == "device"
    _write(tmp_path / "host.json", [e for e in _events() if e["cat"] not in P.DEVICE_CATS],
           gz=False)  # a trace of the CPU alone: its operators are counted
    host = P.aggregate_trace(tmp_path / "host.json")
    assert host["by_name"] == {"aten::linear": pytest.approx(99.0)} and host["events"] == "host"
    assert P.format_breakdown(host).startswith("total host operator time: 99.00 ms")


def test_extra_category_hook(trace_dir):
    agg = P.aggregate_trace(trace_dir, extra_category=lambda n: "K5" if n == K5 else None)
    assert agg["by_category"]["K5"] == pytest.approx(4.0)
    assert agg["by_category"]["port kernels"] == pytest.approx(2.5)


def test_format_breakdown_is_nkbx(trace_dir):
    agg = P.aggregate_trace(trace_dir)
    text = P.format_breakdown(agg, top=3)
    assert text == jformat_breakdown(agg, top=3)
    assert "total device time: 12.50 ms" in text and "ln_mlp_gemm_kernel" in text


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="profile_trace"):
        P.aggregate_trace(tmp_path)


def test_categorizer_buckets():
    want = {K5: "port kernels", K6: "port kernels", K9: "port kernels",
            "void (anonymous namespace)::window_attention_tc<7>(...)": "port kernels",
            CUDNN: "cudnn convolution", NVJET: "cublas gemm",
            "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128>(...)": "cublas gemm",
            REDUCE: "reductions", ELEMENTWISE: "elementwise", FOREACH: "optimizer foreach",
            MEMCPY: "copies/memset", "Memset (Device)": "copies/memset",
            "void at::native::(anonymous namespace)::max_pool_forward_nhwc(...)": "other"}
    assert {n: P.categorize_kernel(n) for n in want} == want
    assert set(want.values()) <= set(P.KINDS)
    names = P.port_kernel_names()
    assert {"window_attention_tc", "attention_fwd_tc", "ln_mlp_gemm_kernel", "chain_gemm",
            "matmul_bn_wgmma_kernel", "gconv_tc_kernel", "copy_bulk_kernel"} <= names


class _Event:
    def __init__(self, key, us, count=1):
        self.key, self.device_time_total, self.count = key, us, count
        self.device_type = "DeviceType.CUDA"


class _Prof:
    def key_averages(self):
        return [_Event(K5, 4000.0, 2), _Event(CUDNN, 5000.0), _Event(K6, 2500.0),
                type("Cpu", (), {"key": "aten::mm", "device_time_total": 0,
                                 "device_type": "DeviceType.CPU"})()]


def test_kernel_ms_reads_a_trace_as_key_averages(trace_dir):
    events = P.device_events(_Prof())
    assert [e.key for _, e in events] == [CUDNN, K5, K6]
    by_name = P.aggregate_trace(trace_dir)["by_name"]
    want = {"ln_mlp": 1, "ln_mlp_bwd": 1, "mlp": 0, "mlp_bwd": 0}
    for name, ms in (("ln_mlp", 4.0), ("ln_mlp_bwd", 2.5)):
        assert P.kernel_ms(events, name, 1, want) == pytest.approx(ms)
        assert P.kernel_ms(by_name, name, 2, want) == pytest.approx(ms / 2)
    with pytest.raises(ValueError, match="both ran"):
        P.kernel_ms(by_name, "mlp", 1, want)
    assert P.kernel_ms(by_name, "mlp", 1, {"ln_mlp": 0}) == pytest.approx(4.0)
    kinds = P.kernel_kinds(events, 1)
    assert list(kinds) == list(P.KINDS)
    assert kinds["port kernels"] == pytest.approx(6.5) and kinds["other"] == 0.0
    assert P.kernel_kinds(by_name, 1)["copies/memset"] == pytest.approx(0.5)


def test_profile_trace_on_the_cpu(tmp_path):
    with profile_trace(tmp_path / "tb", device="cpu") as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert prof is not None
    files = list((tmp_path / "tb").glob("trace_*.json.gz"))
    assert len(files) == 1
    host = P.aggregate_trace(tmp_path / "tb")  # no device event: the host's operators
    assert host["events"] == "host" and host["by_name"]["aten::mm"] > 0
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.core.profiling", str(tmp_path / "tb")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "aten::mm" in r.stdout, r.stderr


def test_profile_trace_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile_trace(tmp_path):
            pass


def test_cli(trace_dir):
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.core.profiling", str(trace_dir),
                        "--top", "2"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == P.format_breakdown(P.aggregate_trace(trace_dir), 2)
