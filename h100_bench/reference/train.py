"""Plain float32 training steps: the device stage (random flips, then
Normalize), the mean cross-entropy over the batch, autograd's backward,
and the mix's optimizer (``reference/optim_<type>.py``, found by name).

The flips' draws: one ``torch.rand(B)`` a flip from a generator seeded with
the train state's seed, in pipeline order, row i flipped where its draw is
under the flip's probability. That is the order in which the program
documents its draws (``nkbx_torch.transforms.device.draw``: the gate, B
uniforms under ``p``); the reference makes its own draws in that order
from the seed the benchmark gave both sides.

The batch runs through the model in ``micro`` rows at a time, each chunk's
summed loss divided by the batch's rows, so that the float32 activations
fit beside nothing else on the card.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

_FLIP_DIM = {"horizontal": 2, "vertical": 1}  # NHWC


def device_stage(image_u8, mix: dict, generator=None) -> torch.Tensor:
    """uint8 NHWC -> normalised float32, the flips drawn from ``generator``
    (none without one)."""
    x = image_u8.float()
    b = x.shape[0]
    for kind, p in (mix.get("flips") or []) if generator is not None else []:
        gate = torch.rand(b, generator=generator, device=generator.device) < p
        x = torch.where(gate.to(x.device).view(-1, 1, 1, 1), x.flip(_FLIP_DIM[kind]), x)
    norm = mix["normalize"]
    mean = torch.tensor(norm["mean"], device=x.device) * 255.0
    std = torch.tensor(norm["std"], device=x.device) * 255.0
    return (x - mean) / std


def is_backbone(name: str) -> bool:
    return name.split(".", 1)[0] == "backbone"


def optimizer(model, cfg: dict):
    """The mix's optimizer over two groups, the backbone and the head."""
    groups = {"backbone": [], "classifier": []}
    for name, p in model.named_parameters():
        groups["backbone" if is_backbone(name) else "classifier"].append(p)
    mod = importlib.import_module(f"h100_bench.reference.optim_{cfg['type']}")
    return mod.make([{"params": groups[g], "lr": cfg[f"{g}_lr"],
                      "weight_decay": cfg.get(f"{g}_weight_decay", 0.0)} for g in groups])


def steps(model, mix: dict, batches, state_seed: int, rows=None, micro: int = 32):
    """Train ``model`` over ``batches`` ((uint8 image, label) pairs) one
    step each. ``rows`` (a slice) keeps only those rows of every batch
    after the device stage (the half-batch fault). Returns the losses, the
    first step's gradients ({name: tensor}) and the final parameters."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(state_seed)
    opt = optimizer(model, mix["optimizer"])
    losses, first = [], None
    for image, label in batches:
        x = device_stage(image, mix, gen)
        if rows is not None:
            x, label = x[rows], label[rows]
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for i in range(0, x.shape[0], micro):
            logits = model(x[i:i + micro])
            loss = F.cross_entropy(logits, label[i:i + micro], reduction="sum") / x.shape[0]
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        opt.step()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, first, params
