"""The training driver: one trainer in a closed loop, the program's train
step called as ``train_epoch`` calls it (one call a batch, the loss read
back on the host after each call).

Set-up builds the program once: the model through
``nkbx_torch.models.get_model`` with the benchmark's seeded weights, the
train state, the step of ``nkbx_torch.train.build_train_step`` with the
mix's device stage, loss and optimizer, and a pool of distinct seeded
uint8 batches on the card. It drives that same step through its first
``checked_steps`` calls (on pool batches 0, 1, 2), keeping the losses, the
first gradient's norms (from the optimizer's state) and the norms of the
parameters' change, then ``warmup_steps`` more, and hands the state to the
window. The window cycles through the pool for ``--seconds``. With
``--trace 1`` a stretch of ``trace_steps`` more steps runs under the
profiler tracing the device alone (the metrics' stretch), and one more
such stretch with the host's spans too (the idle gaps' names). Then the program is dropped and the reference runs the first
steps again from the same weights, batches and flips.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

from h100_bench import checks, trace, weights
from h100_bench.drivers import Context, Outcome, release
from h100_bench.reference import train as ref_train

_FLIPS = {"horizontal": "HorizontalFlip", "vertical": "VerticalFlip"}


@dataclasses.dataclass
class Program:
    model: object
    state: object
    step: object


def reference_shapes(cell):
    """(name, shape) of the reference model's parameters, in its order:
    the order in which :func:`weights.make` lays the seeded draw out."""
    import torch

    with torch.device("meta"):
        ref = cell.family.build(cell.config)
    return [(n, tuple(p.shape)) for n, p in ref.named_parameters()]


def build(cell, seed: int, device, start: dict) -> Program:
    """The program under test, with the benchmark's weights ``start``
    loaded."""
    import torch

    from nkbx_torch import transforms as T
    from nkbx_torch.models import get_model
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer

    cfg, mix = cell.config, cell.mix
    size = cfg["image_size"]
    model = get_model({"task": "single", "model": cfg["model"],
                       "backbone_opts": cfg.get("backbone_opts") or {}},
                      [str(i) for i in range(cfg["num_classes"])], input_size=(size, size),
                      dtype=getattr(torch, cfg["compute_dtype"]), device=device)
    weights.load(model.module, start)
    norm = mix["normalize"]
    pipeline = T.Compose([getattr(T, _FLIPS[kind])(p=p) for kind, p in mix["flips"]]
                         + [T.Normalize(mean=norm["mean"], std=norm["std"])])
    step = build_train_step(model, get_loss({"task": "single", "type": mix["loss"]}),
                            get_optimizer(mix["optimizer"]), augment_fn=pipeline.device_apply)
    state = TrainState.create(model, seed=weights.sub_seed(seed, weights.STATE))
    return Program(model, state, step)


def run(cell, seed: int, seconds: float, trace_on: bool, device, t0: float) -> Outcome:
    import torch

    marks = {"imports": time.perf_counter() - t0}  # set-up's points, seconds from the start
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    b, size, n_pool = mix["batch"], cfg["image_size"], mix["pool_batches"]
    images = weights.uint8_images(n_pool * b, size, seed, dev).view(n_pool, b, size, size, 3)
    labels = weights.labels(n_pool * b, cfg["num_classes"], seed, dev).view(n_pool, b)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    marks["card_and_inputs"] = time.perf_counter() - t0
    start = weights.make(reference_shapes(cell), seed, dev)
    prog = build(cell, seed, dev, start)
    marks["program"] = time.perf_counter() - t0
    first_grad = importlib.import_module(f"h100_bench.first_grad.{mix['optimizer']['type']}")

    def call(i):
        prog.state, m = prog.step(prog.state, images[i % n_pool], labels[i % n_pool], mask,
                                  1.0, 1.0)
        return float(m["loss"])  # the host read train_epoch makes after each call

    # the checked steps: the window's own step on pool batches 0..k-1
    mine = {"losses": []}
    for i in range(mix["checked_steps"]):
        mine["losses"].append(call(i))
        if i == 0:
            mine["grad_norms"] = checks.norms(first_grad.first_gradient(prog.state))
    mine["change_norms"] = checks.change_norms(dict(prog.model.module.named_parameters()),
                                               start)
    del start
    marks["checked_steps"] = time.perf_counter() - t0
    done = mix["checked_steps"]
    for _ in range(mix["warmup_steps"]):
        call(done)
        done += 1
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    failed = steps = 0
    w0 = time.perf_counter()
    while True:
        loss = call(done)
        done += 1
        steps += 1
        failed += not math.isfinite(loss)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    ctx = Context(cell=cell, device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
                  train=True, window_s=window_s, window_images=steps * b,
                  peak_window_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None)
    notes = {"setup_marks_s": marks, "window_step_ms": 1e3 * window_s / steps}
    if trace_on:
        k = mix["trace_steps"]

        def stretch():
            nonlocal done
            for _ in range(k):
                call(done)
                done += 1

        ctx.trace, ctx.trace_batches = trace.capture(stretch, host=False), [b] * k
        ctx.host_trace = trace.capture(stretch)
        notes["stretch_step_ms"] = 1e3 * ctx.trace.wall_s / k
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del prog
    release()
    ref = reference(cell, seed, dev, images, labels, "f32")
    numbers = checks.train_numbers(mine, ref)
    ok, shown = checks.verdict(numbers, cell.limits)
    return Outcome(correct=ok and failed == 0, attempted=steps, failed=failed,
                   end_to_end={"train_img_s": steps * b / window_s, "setup_s": setup_s},
                   context=ctx, memory_peak_bytes=peak, checks=shown,
                   notes={**notes, "where": numbers["_where"], "losses": mine["losses"],
                          "reference_losses": ref["losses"]})


def reference(cell, seed: int, dev, images, labels, precision: str, rows=None) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    the checked steps, from the benchmark's weights and batches."""
    from h100_bench.reference.common import no_tf32

    no_tf32()
    mix = cell.mix
    model = cell.family.build(cell.config, precision).to(dev)
    start = weights.make(reference_shapes(cell), seed, dev)
    weights.load(model, start)
    k = mix["checked_steps"]
    losses, first, params = ref_train.steps(
        model, mix, [(images[i], labels[i]) for i in range(k)],
        weights.sub_seed(seed, weights.STATE), rows=rows)
    out = {"losses": losses, "grad_norms": checks.norms(first),
           "change_norms": checks.change_norms(params, start)}
    del model, start, first, params
    release()
    return out
