"""The yardstick's arithmetic: the card's peaks, the least time a layer's
work needs, and the model FLOPs of a step or a forward.

A layer's work is counted from the model's shapes (each input byte read
once, each output byte written once; the operations the algorithm needs,
no recomputation), the same whichever kernel implements it. The least
time is the larger of operations over the bf16 peak and bytes over the
memory bandwidth, summed over the calls.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BF16 = 2  # bytes of an activation or a weight in the compute dtype
F32 = 4  # bytes of a master parameter's gradient, a LayerNorm vector, a bias


def peaks(device_name: str):
    """(bf16 FLOP/s, bytes/s) of the card named ``device_name``, or None
    for a card the table does not hold."""
    cards = json.loads((HERE / "peaks.json").read_text())["cards"]
    for key, p in cards.items():
        if key in device_name:
            return p["bf16_flops_per_s"], p["hbm_bytes_per_s"]
    return None


def bound_s(flops: float, nbytes: float, peak) -> float:
    return max(flops / peak[0], nbytes / peak[1])


def ln_mlp_bound_s(calls: list, train: bool, peak) -> float:
    """Least seconds of LN->MLP calls (``shortcut + gamma * fc2(gelu(fc1(
    LN(x))))`` over rows x C, hidden F): the forward reads x (and a shortcut
    apart from it), the LayerNorm, bias and layer-scale vectors and both
    weights, and writes the output, at 4 R C F operations; with ``train``
    the backward reads x, the output's gradient and both weights, writes
    the input's gradient, both weights' and the vectors' gradients, at
    8 R C F."""
    total = 0.0
    for c in calls:
        r, ch, f = c["rows"], c["c"], c["f"]
        vecs = (2 * ch + f + ch + (ch if c["gamma"] else 0)) * F32
        weights = 2 * ch * f * BF16
        acts = r * ch * BF16
        fwd_bytes = acts * (2 if c["shortcut"] else 1) + weights + vecs + acts
        total += bound_s(4.0 * r * ch * f, fwd_bytes, peak)
        if train:
            bwd_bytes = 2 * acts + weights + acts + 2 * ch * f * F32 + vecs
            total += bound_s(8.0 * r * ch * f, bwd_bytes, peak)
    return total


def attention_bound_s(calls: list, train: bool, peak) -> float:
    """Least seconds of softmax(Q K^T / sqrt(D)) V over B sequences of N
    tokens and H heads of width D: the forward reads Q, K, V and writes
    the output, at 4 B H N^2 D operations; with ``train`` the backward
    reads Q, K, V, the output, its gradient and the row statistics (f32),
    writes the gradients of Q, K and V, at 8 B H N^2 D."""
    total = 0.0
    for c in calls:
        b, h, n, d = c["b"], c["h"], c["n"], c["d"]
        t = b * n * h * d * BF16
        total += bound_s(4.0 * b * h * n * n * d, 4 * t, peak)
        if train:
            total += bound_s(8.0 * b * h * n * n * d, 8 * t + b * h * n * F32, peak)
    return total


def model_flops(family, cfg: dict, images: int, train: bool) -> float:
    """2 x the forward's multiply-adds for each image, 3 x that for a train
    step (forward, and the backward's two products per forward product)."""
    return (6.0 if train else 2.0) * family.macs_per_image(cfg) * images
