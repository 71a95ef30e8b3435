"""Seeded weights and inputs, made on the device in a few large calls.

The benchmark makes every tensor that both sides see: the weights (one
normal draw for all parameters, each slice shifted and scaled by the rule
below), the training batches and the serving pool. The same ``--seed``
gives the same tensors; the reference makes them again after the window
instead of keeping a copy.

The rule, by parameter name and shape (random weights: the scales keep
every layer's activations and gradients of order one):

- a matrix or convolution kernel: normal, std 1/sqrt(fan-in);
- ``pos_embed``, ``cls_token``: normal, std 0.02;
- ``layer_scale``: normal, mean 0.5, std 0.1 (a trained ConvNeXt's
  layer-scales are of this order; the published 1e-6 init would leave
  every block's MLP without a gradient worth comparing);
- any other vector ending in ``weight`` (a LayerNorm's scale): mean 1,
  std 0.1; one ending in ``bias``: std 0.02.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the streams derived from one --seed
WEIGHTS, DATA, STATE, ORDER, SAMPLE = range(5)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream``, derived from the run's ``seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def rule(name: str, shape) -> tuple:
    """(mean, std) of a parameter by its name and shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "cls_token"):
        return 0.0, 0.02
    if leaf == "layer_scale":
        return 0.5, 0.1
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "weight":
        return 1.0, 0.1
    return 0.0, 0.02


def make(named_shapes, seed: int, device) -> dict:
    """{name: float32 tensor} for ``named_shapes`` ((name, shape) pairs, in
    order), from one normal draw on ``device``."""
    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    total = sum(math.prod(s) for _, s in named_shapes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        mean, std = rule(name, shape)
        out[name] = z[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


@torch.no_grad()
def load(module, weights: dict):
    """Copy ``weights`` into ``module``'s parameters by name; the two name
    sets must be equal."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"parameter names differ: module only {missing[:5]}, "
                         f"weights only {extra[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} against "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def uint8_images(count: int, size: int, seed: int, device) -> torch.Tensor:
    """(count, size, size, 3) uniform uint8 NHWC images on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    return torch.randint(0, 256, (count, size, size, 3), generator=g, device=device,
                         dtype=torch.uint8)


def labels(count: int, classes: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA) ^ 1)
    return torch.randint(0, classes, (count,), generator=g, device=device)
