"""On the card, at each cell's own size: the control (the reference in
float8 e4m3, the precision below the configuration's bf16, put in the
program's place) fails the cell's limits, and for a training cell so does
the step that leaves out half of the batch.

    python3 -m pytest -p no:cacheprovider -m cuda h100_bench/tests/test_h100_control.py

Skips where there is no CUDA card (decided in the fixture)."""

import pytest

from h100_bench import calibrate, spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limits(card, name):
    cell = spec.cell(name)
    got = calibrate.readings(cell, 2**31 + 101, card)
    assert got["control"]["fails_limits"], got
    if "half_batch" in got:
        assert got["half_batch"]["fails_limits"], got
