#!/usr/bin/env python3
"""Smoke run of the nkbx_torch port on one CUDA card (an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Builds every kernel in nkbx_torch/ops/csrc with nvcc (all at once) and
   prints the build time and ptxas's register/shared-memory report.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the Swin-T serving path gives it at bucket 64 (and one window-12
   case), in bf16 and in f32 with TF32 off; prints the errors against the
   stated tolerances and the times of the kernel, the plain version and, for
   window attention, scaled_dot_product_attention on the same inputs.
3. Drives the serving path: get_model(swin_tiny_patch4_window7_224, bf16,
   random weights from a seed) in a ServingModule with buckets (1, 8, 64)
   answers requests of 1, 5, 64 and 70 seeded uint8 224x224 images. Checks
   the launch counts, finite logits of the right shapes, and agreement with
   the same model run through the plain versions; then times benchmark(64)
   through the kernels and through the plain versions, the peak memory, and
   a profile of where the device time goes.
4. Prints the kernels' JSON line, the card's name and power limit, and last
   {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, without a CUDA device, outside
a checkout of the repository, or when any check fails.
"""

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense bf16 tensor core / f32 without
DEPTHS = (2, 2, 6, 2)  # swin_tiny blocks per stage
BUCKET = 64
OUT_DIR = "chiprun_out"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


try:
    import numpy as np
    import torch
    import torch.nn.functional as F
except ImportError as e:
    fail(f"needs numpy and torch: {e}")

if not torch.cuda.is_available():
    fail("no CUDA device (torch.cuda.is_available() is false)")

try:
    from nkbx_torch.export import ServingModule
    from nkbx_torch.models import get_model
    from nkbx_torch.models.swin import _shift_attn_mask
    from nkbx_torch.ops import _build
    from nkbx_torch.ops import attention as A
    from nkbx_torch.ops import mlp as M
except ImportError as e:
    fail(f"run from the root of an nkbx checkout: {e}")

DEV = torch.device("cuda")
DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=10, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(x, 2 ** -20))) - 7)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: window attention (K1) -----------------------------------------

def attn_case(g, heads, m_windows, grid, window, dtype, gen):
    n, d = window * window, 32
    c = heads * d
    qkv = torch.randn(g, n, 3 * c, generator=gen, device=DEV).to(DT[dtype])
    bias = (0.5 * torch.randn(heads, n, n, generator=gen, device=DEV)).contiguous()
    if m_windows > 1:
        mask = torch.as_tensor(_shift_attn_mask(grid, grid, window, window // 2), device=DEV)
    else:
        mask = torch.zeros(1, n, n, device=DEV)
    return qkv, bias, mask, d ** -0.5


def attn_plain(qkv, bias, mask, scale, heads):
    c = qkv.shape[-1] // 3
    return A.reference_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                                 mask, scale, heads)


def attn_sdpa_inputs(qkv, bias, mask, heads):
    """q, k, v as (G/M, M*H, N, D) and bias+mask as (1, M*H, N, N), so one
    scaled_dot_product_attention call computes the same function."""
    g, n, c3 = qkv.shape
    m, d = mask.shape[0], c3 // 3 // heads
    t = qkv.view(g, n, 3, heads, d).permute(2, 0, 3, 1, 4).contiguous()
    q, k, v = (t[i].view(g // m, m * heads, n, d) for i in range(3))
    am = (bias[None] + mask[:, None]).reshape(1, m * heads, n, n).to(qkv.dtype)
    return q, k, v, am


def check_attention():
    gen = torch.Generator(device=DEV).manual_seed(1)
    tol = {"f32": lambda ref: 1e-4, "bf16": lambda ref: 2 * bf16_ulp(ref)}
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    # (stage, G, heads, M, grid, window): Swin-T at bucket 64, shifted blocks
    # for stages 0-2 (the mask with M windows), none at stage 3; then window 12
    cases = [(s, BUCKET * (8 >> s) ** 2, 3 << s, (8 >> s) ** 2 if s < 3 else 1, 56 >> s, 7)
             for s in range(4)]
    cases.append(("w12", 256, 4, 64, 96, 12))
    for stage, g, heads, m, grid, window in cases:
        for dtype in ("bf16", "f32"):
            qkv, bias, mask, scale = attn_case(g, heads, m, grid, window, dtype, gen)
            got = A.fused_attention_qkv(qkv, bias, mask, scale, heads)
            torch.cuda.synchronize()
            ref = attn_plain(qkv, bias, mask, scale, heads)
            err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim
            log(f"K1 stage {stage} G={g} H={heads} N={window ** 2} M={m} {dtype}: "
                f"max|err| {err:.3e} (tol {lim:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"window attention disagrees with its plain version at stage {stage} {dtype}")
            if dtype != "bf16":
                continue
            n, c = window * window, heads * 32
            ms = cuda_ms(lambda: A.fused_attention_qkv(qkv, bias, mask, scale, heads))
            plain = cuda_ms(lambda: attn_plain(qkv, bias, mask, scale, heads))
            q, k, v, am = attn_sdpa_inputs(qkv, bias, mask, heads)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                  scale=scale))
            nbytes = 2 * g * n * 4 * c + 4 * (heads + m) * n * n
            b, by = bound_ms(nbytes, 4 * g * heads * n * n * 32, "bf16")
            log(f"   bf16 times: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                f"bound {b:.4f} ms ({by})")
            rows.append(dict(stage=stage, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by))
            del q, k, v, am
    return rows, worst


# --- phase 2: LN -> MLP (K5) --------------------------------------------------

def mlp_case(r, c, dtype, gen, gamma=False):
    f = 4 * c
    dt = DT[dtype]

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=DEV)

    x, sc = rn(r, c).to(dt), rn(r, c).to(dt)
    args = (x, 1 + rn(c, s=0.1), rn(c, s=0.1), rn(c, f, s=c ** -0.5).to(dt), rn(f, s=0.1),
            rn(f, c, s=f ** -0.5).to(dt), rn(c, s=0.1), sc)
    return args, (1 + rn(c, s=0.1) if gamma else None)


def check_mlp():
    gen = torch.Generator(device=DEV).manual_seed(2)
    tol = {"f32": lambda ref: 5e-4, "bf16": lambda ref: 4 * bf16_ulp(ref)}
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    cases = [(s, BUCKET * (56 >> s) ** 2, 96 << s, False) for s in range(4)]
    cases.append(("ragged+gamma", 1000, 96, True))
    cases.append(("fma-width", 1000, 40, True))  # F = 160: the float-FMA kernel in bf16 too
    for stage, r, c, use_gamma in cases:
        for dtype in ("bf16", "f32"):
            args, gamma = mlp_case(r, c, dtype, gen, use_gamma)
            got = M.fused_ln_mlp(*args, gamma=gamma, eps=1e-5)
            torch.cuda.synchronize()
            ref = M.reference_ln_mlp(*args, gamma=gamma, eps=1e-5)
            err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim
            log(f"K5 stage {stage} R={r} C={c} F={4 * c} tile={M.pick_tile_rows(c, M.tensor_cores(DT[dtype], c, 4 * c))} tc={M.tensor_cores(DT[dtype], c, 4 * c)} {dtype}: "
                f"max|err| {err:.3e} (tol {lim:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"LN-MLP disagrees with its plain version at stage {stage} {dtype}")
            if dtype != "bf16" or use_gamma:
                continue
            ms = cuda_ms(lambda: M.fused_ln_mlp(*args, eps=1e-5))
            plain = cuda_ms(lambda: M.reference_ln_mlp(*args, eps=1e-5))
            f = 4 * c
            b, by = bound_ms(2 * (3 * r * c + 2 * c * f) + 4 * (4 * c + f), 4 * r * c * f, "bf16")
            log(f"   bf16 times: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b:.4f} ms ({by})")
            rows.append(dict(stage=stage, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by))
    return rows, worst


def per_forward(rows, key):
    """One bucket-64 forward's time: each stage's launches times its time."""
    vals = [r[key] for r in rows]
    if any(v is None for v in vals):
        return None
    return sum(d * v for d, v in zip(DEPTHS, vals))


# --- phase 3: the serving path --------------------------------------------------

def set_plain(on):
    for k in ("NKBX_FUSED_ATTENTION", "NKBX_FUSED_MLP"):
        if on:
            os.environ[k] = "0"
        else:
            os.environ.pop(k, None)


def serve_all(serving, requests):
    outs = [serving(r) for r in requests]
    torch.cuda.synchronize()
    return outs


def profile_forward(serving, x, step_ms):
    """Device time by kernel over 3 forwards at bucket 64 (torch.profiler);
    the idle share is against ``step_ms``, a forward's time measured without
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    serving(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            serving(x)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    # kernel events only: a CPU op's device time repeats its kernels' time
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        log("profile: no device time recorded (not measured)")
        return
    total = sum(dev_us(e) for e in events) / 1e3 / 3
    log(f"profile: device busy {total:.3f} ms per bucket-64 forward, against "
        f"{step_ms:.3f} ms compute_p50 unprofiled (idle share {max(0.0, 1 - total / step_ms):.3f})")
    events.sort(key=lambda e: -dev_us(e))
    lines = [f"{dev_us(e) / 1e3 / 3:10.4f} ms  {e.count // 3:5d}x  {e.key[:90]}"
             for e in events]
    for line in lines[:12]:
        log("  " + line)
    with open(os.path.join(OUT_DIR, "profile_bucket64.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def check_path():
    classes = [f"class{i}" for i in range(10)]
    model = get_model({"model": "swin_tiny_patch4_window7_224"}, classes, seed=0,
                      dtype=torch.bfloat16)
    serving = ServingModule(model, buckets=(1, 8, BUCKET), warm_up_on_load=False)
    rng = np.random.default_rng(0)
    sizes = (1, 5, 64, 70)
    requests = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8) for n in sizes]
    forwards = 1 + 1 + 1 + 2  # 70 = a chunk of 64 and a bucket-8 chunk of 6

    set_plain(False)
    A.fused_attention_qkv.launches = 0
    M.fused_ln_mlp.launches = 0
    outs = serve_all(serving, requests)
    la, lm = A.fused_attention_qkv.launches, M.fused_ln_mlp.launches
    stages_on = sum(d for d, c in zip(DEPTHS, (96, 192, 384, 768))
                    if M.pick_tile_rows(c, M.tensor_cores(torch.bfloat16, c, 4 * c)) is not None)
    log(f"path: {forwards} forwards; launches: window_attention {la} (expect {12 * forwards}), "
        f"ln_mlp {lm} (expect {stages_on * forwards})")
    if la != 12 * forwards or lm != stages_on * forwards or la == 0 or lm == 0:
        fail("the serving path did not go through the kernels as expected")
    for n, o in zip(sizes, outs):
        if tuple(o.shape) != (n, 10) or o.dtype != torch.float32 or not torch.isfinite(o).all():
            fail(f"logits of request {n}: shape {tuple(o.shape)}, dtype {o.dtype}")

    set_plain(True)
    plain = serve_all(serving, requests)
    set_plain(False)
    worst_rel = 0.0
    for n, o, p in zip(sizes, outs, plain):
        rel = max_err(o, p) / float(p.abs().max())
        worst_rel = max(worst_rel, rel)
        log(f"path request {n}: max|kernel - plain| / max|plain| = {rel:.3e} (tol 5.0e-02)")
    if worst_rel > 5e-2:
        fail("bf16 logits through the kernels disagree with the plain versions")

    # the same check in f32 (TF32 off), where the kernels should agree closely
    m32 = get_model({"model": "swin_tiny_patch4_window7_224"}, classes, seed=0,
                    dtype=torch.float32)
    s32 = ServingModule(m32, buckets=(8,), warm_up_on_load=False)
    o32 = serve_all(s32, requests[1:2])[0]
    set_plain(True)
    p32 = serve_all(s32, requests[1:2])[0]
    set_plain(False)
    rel32 = max_err(o32, p32) / float(p32.abs().max())
    log(f"path f32 request 5: max|kernel - plain| / max|plain| = {rel32:.3e} (tol 1.0e-03)")
    if rel32 > 1e-3:
        fail("f32 logits through the kernels disagree with the plain versions")
    del m32, s32

    bench = {}
    for label, plain_on in (("kernels", False), ("plain", True), ("kernels", False)):
        set_plain(plain_on)
        torch.cuda.reset_peak_memory_stats()
        r = serving.benchmark(BUCKET, iters=20)
        r["max_memory_allocated_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        bench.setdefault(label, []).append(r)
        log(f"benchmark({BUCKET}) {label}: {json.dumps(r)}")
    set_plain(False)
    try:  # a measurement only: the checks above decide the run
        profile_forward(serving, requests[2], bench["kernels"][-1]["compute_p50_ms"])
    except Exception as e:  # noqa: BLE001
        log(f"profile: not measured ({type(e).__name__}: {e})")
    return la, lm, bench


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built) or 'nothing (cached)'}")
    for name, (secs, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    attn_rows, attn_err = check_attention()
    mlp_rows, mlp_err = check_mlp()
    la, lm, _ = check_path()

    kernels = []
    for name, src, replaces, rows, err, launches in (
            ("window_attention", "nkbx_torch/ops/csrc/window_attention.cu",
             "nkbx/ops/attention.py:302", attn_rows[:4], attn_err, la),
            ("ln_mlp", "nkbx_torch/ops/csrc/ln_mlp.cu", "nkbx/ops/mlp.py:504",
             mlp_rows[:4], mlp_err, lm)):
        bound = per_forward(rows, "bound_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err["bf16"], "max_abs_err_f32": err["f32"],
            "ms": per_forward(rows, "ms"), "plain_ms": per_forward(rows, "plain_ms"),
            "bound_ms": bound,
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": per_forward(rows, "library_ms") if "library_ms" in rows[0] else None,
            "per": "one bucket-64 swin_tiny forward, bf16",
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
