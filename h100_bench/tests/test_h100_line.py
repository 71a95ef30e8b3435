"""The last line's shape: the result's keys, the cell's metrics by name
and unit, strict JSON, each compared number beside its limit under the
key that comes last; and no line without a card."""

import json
import time

import pytest

from h100_bench import run, spec
from h100_bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name,trace_on", [("vit_b16.train.b128", False),
                                           ("convnext_t.train.b128", True),
                                           ("vit_b16.serve.crops", True),
                                           ("vit_b16.serve.crops", False)])
def test_the_line_of_a_tiny_run(name, trace_on):
    cell = tiny_cell(name)
    line = run.execute(cell, 2**31 + 9, 0.3, trace_on, "cpu", time.perf_counter())
    json.dumps(line, allow_nan=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace_on:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert all(v["unit"] == units[k] for k, v in line["metrics"].items())
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]  # float32 on both sides: rounding only


def test_no_line_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "vit_b16.train.b128", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_line_for_an_unknown_cell(capsys):
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert capsys.readouterr().out == ""


def test_every_cell_reports_its_metrics():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
