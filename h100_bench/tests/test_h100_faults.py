"""A run with the timed path broken underneath comes out not correct: the
training step that returns its state unchanged, the step that leaves out
half of the batch (the mean over the rest), and the serving answer
altered where it is produced. The harness's look for a card is skipped;
the rest of the run is the run."""

import time

import pytest
import torch

from h100_bench import run
from h100_bench.drivers import serve, train
from h100_bench.tests.tiny import tiny_cell


def _run(name):
    return run.execute(tiny_cell(name), 2**31 + 21, 0.3, False, "cpu", time.perf_counter())


def _broken_train(monkeypatch, breaker):
    real = train.build

    def build(cell, seed, device, start):
        prog = real(cell, seed, device, start)
        prog.step = breaker(prog.step)
        return prog

    monkeypatch.setattr(train, "build", build)


@pytest.mark.parametrize("name", ["vit_b16.train.b128", "convnext_t.train.b128"])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, name):
    def breaker(step):
        def unchanged(state, image, label, mask, lr_factor, freeze_scale):
            return state, {"loss": torch.tensor(7.0)}
        return unchanged

    _broken_train(monkeypatch, breaker)
    line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["vit_b16.train.b128", "convnext_t.train.b128"])
def test_half_of_the_batch_left_out(monkeypatch, name):
    def breaker(step):
        def half(state, image, label, mask, lr_factor, freeze_scale):
            h = image.shape[0] // 2
            return step(state, image[:h], label[:h], mask[:h], lr_factor, freeze_scale)
        return half

    _broken_train(monkeypatch, breaker)
    line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] > line["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("name", ["vit_b16.serve.crops"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, name):
    real = serve.build

    def build(cell, seed, device):
        serving = real(cell, seed, device)
        forward = serving.forward

        def altered(im):
            out = forward(im).clone()
            out[0] = out[0].roll(1)
            return out

        serving.forward = altered
        return serving

    monkeypatch.setattr(serve, "build", build)
    line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]
