"""The serving driver: requests of uint8 NHWC images from one caller at a
fixed rate (an open loop: request i is due at i / rate seconds), served in
turn by the program's ``nkbx_torch.export.serving.ServingModule`` (bucket
padding, chunking past the largest bucket, the copy to the card, Normalize
on the card, the forward); each request's logits are copied back to the
host before the next request is taken. A request's latency runs from the
moment it was due to its logits on the host, so a request that waits
behind a slow one counts its wait.

The request sizes: every size of the mix's range once a cycle, each cycle
in an order drawn from the seed, so that every seed sends the same sizes.
Each request takes a contiguous run of images from a seeded pool, at an
offset drawn from the seed.

With ``--trace 1`` the cycle of requests then runs back to back, over and
over for as long as the window, unprofiled (the capacity and the serving
MFU, on the host's clock), and then once under the profiler tracing the
device alone (the metrics' stretch), and once more with the host's spans
too (the idle gaps' names).
After the window the program is dropped and the reference's forward of a
seeded sample of the window's requests, the largest among them, is held
against the logits the window returned.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from h100_bench import checks, trace, weights
from h100_bench.drivers import Context, Outcome, release
from h100_bench.drivers.train import reference_shapes
from h100_bench.reference.train import device_stage


def sizes(mix: dict, seed: int, count: int) -> list:
    """``count`` request sizes: cycles of every size in the mix's range,
    each cycle in its own seeded order."""
    lo, hi = mix["sizes"]
    rng = np.random.default_rng([weights.sub_seed(seed, weights.ORDER), 0])
    out = []
    while len(out) < count:
        out += [int(n) for n in rng.permutation(np.arange(lo, hi + 1))]
    return out[:count]


def schedule(mix: dict, seed: int, count: int) -> list:
    """(size, pool offset) of ``count`` requests."""
    ns = sizes(mix, seed, count)
    rng = np.random.default_rng([weights.sub_seed(seed, weights.ORDER), 1])
    return [(n, int(rng.integers(0, mix["pool_images"] - n + 1))) for n in ns]


def sample(mix: dict, seed: int, reqs: list) -> set:
    """Indices of the requests whose answers are checked: a seeded sample
    of ``sample_requests`` and the first of the largest."""
    rng = np.random.default_rng([weights.sub_seed(seed, weights.SAMPLE)])
    largest = max(range(len(reqs)), key=lambda i: reqs[i][0])
    return set(rng.choice(len(reqs), size=min(len(reqs), mix["sample_requests"]),
                          replace=False).tolist()) | {largest}


def build(cell, seed: int, device):
    import torch

    from nkbx_torch.export.serving import ServingModule
    from nkbx_torch.models import get_model

    cfg = cell.config
    size = cfg["image_size"]
    model = get_model({"task": "single", "model": cfg["model"],
                       "backbone_opts": cfg.get("backbone_opts") or {}},
                      [str(i) for i in range(cfg["num_classes"])], input_size=(size, size),
                      dtype=getattr(torch, cfg["compute_dtype"]), device=device)
    weights.load(model.module, weights.make(reference_shapes(cell), seed, device))
    return ServingModule(model, buckets=cell.mix["buckets"], warm_up_on_load=True)


def _wait_until(t: float):
    """Sleep to within a millisecond of ``t``, then spin."""
    left = t - time.perf_counter()
    if left > 2e-3:
        time.sleep(left - 1e-3)
    while time.perf_counter() < t:
        pass


def window(serve, reqs: list, rate: float, keep: set, classes: int) -> dict:
    """Serve ``reqs`` ((size, offset)), request i due at i / ``rate`` s from
    now, each once the previous one is answered; keep the answers of the
    indices ``keep``. Returns the latencies (from due to answer), the
    service times (from taken to answer), the answers kept, the failures
    and the seconds from the first due time to the last answer."""
    kept, lat, busy, failed = {}, [], [], 0
    gap = 1.0 / rate
    w0 = time.perf_counter()
    for i, (n, o) in enumerate(reqs):
        due = w0 + i * gap
        _wait_until(due)
        taken = time.perf_counter()
        try:
            out = serve(n, o)
            good = tuple(out.shape) == (n, classes)
        except RuntimeError:
            out, good = None, False
        done = time.perf_counter()
        lat.append(done - due)
        busy.append(done - taken)
        failed += not good
        if i in keep and good:
            kept[i] = out
    return {"latency_s": lat, "service_s": busy, "kept": kept, "failed": failed,
            "seconds": time.perf_counter() - w0}


def run(cell, seed: int, seconds: float, trace_on: bool, device, t0: float) -> Outcome:
    import torch

    marks = {"imports": time.perf_counter() - t0}  # set-up's points, seconds from the start
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    size = cfg["image_size"]
    pool = weights.uint8_images(mix["pool_images"], size, seed, dev).cpu().numpy()
    marks["card_and_inputs"] = time.perf_counter() - t0
    serving = build(cell, seed, dev)
    marks["program"] = time.perf_counter() - t0

    def serve(n, o):
        return serving.forward(pool[o:o + n]).cpu()

    cycle = schedule(mix, seed, mix["sizes"][1] - mix["sizes"][0] + 1)
    for n, o in sorted(cycle, key=lambda r: -r[0])[:mix["warmup_requests"]]:
        serve(n, o)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    count = max(1, int(seconds * mix["rate_rps"]))
    reqs = schedule(mix, seed, count)
    picked = sample(mix, seed, reqs)
    w = window(serve, reqs, mix["rate_rps"], picked, cfg["num_classes"])
    kept, lat, failed, window_s = w["kept"], w["latency_s"], w["failed"], w["seconds"]
    images = sum(n for n, _ in reqs)
    ctx = Context(cell=cell, device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
                  train=False, window_s=window_s, window_images=images,
                  peak_window_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None)
    notes = {"setup_marks_s": marks}
    if trace_on:
        def back_to_back():
            for n, o in cycle:
                serve(n, o)

        c0 = time.perf_counter()
        for n, o in itertools.cycle(cycle):
            serve(n, o)
            ctx.capacity_images += n
            ctx.capacity_s = time.perf_counter() - c0
            if ctx.capacity_s >= seconds:
                break
        ctx.trace = trace.capture(back_to_back, host=False)
        ctx.host_trace = trace.capture(back_to_back)
        ctx.trace_batches = [n for n, _ in cycle]
        notes["stretch_img_s"] = ctx.trace_images / ctx.trace.wall_s
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del serving
    release()
    order = sorted(kept)
    ref = reference(cell, seed, dev, pool, [reqs[i] for i in order], "f32")
    number = checks.logit_gap([kept[i] for i in order], ref)
    ok, shown = checks.verdict({"logit_gap": number}, cell.limits)
    missing = len(picked) - len(kept)
    return Outcome(correct=ok and failed == 0 and missing == 0, attempted=count, failed=failed,
                   end_to_end={"serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                               "setup_s": setup_s},
                   context=ctx, memory_peak_bytes=peak, checks=shown,
                   notes={**notes, "compared_requests": len(order),
                          "compared_images": sum(reqs[i][0] for i in order),
                          "served_img_s": images / window_s,
                          "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                          "service_ms_mean": float(np.mean(w["service_s"])) * 1e3,
                          "service_img_s": images / float(np.sum(w["service_s"]))})


def reference(cell, seed: int, dev, pool, reqs, precision: str, micro: int = 32) -> list:
    """The reference's logits (on the host) of requests ((size, offset))."""
    import torch

    from h100_bench.reference.common import no_tf32

    no_tf32()
    model = cell.family.build(cell.config, precision).to(dev)
    weights.load(model, weights.make(reference_shapes(cell), seed, dev))
    out = []
    with torch.no_grad():
        for n, o in reqs:
            x = device_stage(torch.from_numpy(pool[o:o + n]).to(dev), cell.mix)
            out.append(torch.cat([model(x[i:i + micro]) for i in range(0, n, micro)]).cpu())
    del model
    release()
    return out

