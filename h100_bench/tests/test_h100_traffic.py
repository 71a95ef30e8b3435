"""The generators: request sizes, schedules, batches and weights are fixed
by the seed and differ across seeds; every cycle sends every size once."""

import numpy as np
import torch

from h100_bench import spec, weights
from h100_bench.drivers import serve

BIG = 2**31 + 4099  # seeds may pass 32 signed bits


def _mix():
    return spec.cell("vit_b16.serve.crops").mix


def test_request_sizes_are_fixed_by_the_seed():
    mix = _mix()
    a, b = serve.schedule(mix, BIG, 500), serve.schedule(mix, BIG, 500)
    assert a == b
    assert serve.schedule(mix, BIG + 1, 500) != a
    lo, hi = mix["sizes"]
    assert all(lo <= n <= hi and 0 <= o <= mix["pool_images"] - n for n, o in a)


def test_every_cycle_sends_every_size_once():
    mix = _mix()
    lo, hi = mix["sizes"]
    k = hi - lo + 1
    for seed in (1, BIG):
        s = serve.sizes(mix, seed, 3 * k)
        for c in range(3):
            assert sorted(s[c * k:(c + 1) * k]) == list(range(lo, hi + 1))


def test_the_sample_holds_the_largest_request():
    mix = _mix()
    reqs = serve.schedule(mix, BIG, 480)
    picked = serve.sample(mix, BIG, reqs)
    assert picked == serve.sample(mix, BIG, reqs)
    assert max(n for n, _ in reqs) in {reqs[i][0] for i in picked}
    assert len(picked) >= mix["sample_requests"]


def test_batches_and_weights_are_fixed_by_the_seed():
    dev = torch.device("cpu")
    a = weights.uint8_images(3, 8, BIG, dev)
    assert torch.equal(a, weights.uint8_images(3, 8, BIG, dev))
    assert not torch.equal(a, weights.uint8_images(3, 8, BIG + 1, dev))
    assert torch.equal(weights.labels(16, 10, BIG, dev), weights.labels(16, 10, BIG, dev))
    shapes = [("backbone.Dense_0.weight", (16, 8)), ("backbone.Dense_0.bias", (16,)),
              ("backbone.LayerNorm_0.weight", (8,)), ("backbone.ConvNeXtBlock_0.layer_scale", (8,))]
    w = weights.make(shapes, BIG, dev)
    assert all(torch.equal(w[k], v) for k, v in weights.make(shapes, BIG, dev).items())
    assert not torch.equal(w["backbone.Dense_0.weight"],
                           weights.make(shapes, BIG + 1, dev)["backbone.Dense_0.weight"])
    assert float(w["backbone.Dense_0.weight"].std()) == pytest_approx(1 / np.sqrt(8), 0.5)
    assert float(w["backbone.LayerNorm_0.weight"].mean()) == pytest_approx(1.0, 0.2)


def pytest_approx(x, rel):
    import pytest

    return pytest.approx(x, rel=rel)


def test_sub_seeds_differ_by_stream_and_fit_a_generator():
    s = {weights.sub_seed(BIG, k) for k in range(5)}
    assert len(s) == 5 and all(0 <= v < 2**63 for v in s)
    torch.Generator().manual_seed(max(s))
