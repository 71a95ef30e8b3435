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
3. The same for the backward kernels, window attention (K2) and LN -> MLP
   (K6), at the shapes of a batch-64 Swin-T train step (and window 12 for
   K2, a ragged tile with a layer-scale and an FMA width for K6); for K2 the
   library time is the backward alone of scaled_dot_product_attention with
   the additive mask requiring grad, and the SDPA backend that ran.
4. Drives the serving path: get_model(swin_tiny_patch4_window7_224, bf16,
   random weights from a seed) in a ServingModule with buckets (1, 8, 64)
   answers requests of 1, 5, 64 and 70 seeded uint8 224x224 images. Checks
   the launch counts, finite logits of the right shapes, and agreement with
   the same model run through the plain versions; then times benchmark(64)
   through the kernels and through the plain versions, the peak memory, and
   a profile of where the device time goes.
5. Drives the training path: the same model at full width and depth (bf16,
   10 classes), nadam with two groups, cross-entropy, flips + Normalize, a
   seeded uint8 batch of 64 with the last 6 rows masked out. 5 steps through
   the kernels (launch counts per step, finite grads, falling loss) and the
   same 5 steps from the same weights through the plain versions (losses
   agree). Every tensor's grads of one backward of that batch, in bf16 and
   in f32 (TF32 off), through the kernels and through the plain versions
   (launch counts checked): in f32 the kernels agree with plain, and in bf16
   they are no farther from the f32 grads than plain bf16 is (within 2x).
   Then step time, img/s and peak memory
   of both paths, and a profile of one step.
6. Prints the kernels' JSON line, the card's name and power limit, and last
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
DTYPE_NAME = {v: k for k, v in DT.items()}


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


def sdpa_backend(fn):
    """The SDPA implementation ``fn`` ran, from the names of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for word, backend in (("flash", "flash"), ("fmha", "efficient"), ("efficient", "efficient"),
                          ("cudnn", "cudnn")):
        if word in names:
            return backend
    return "math"


def check_attention_bwd():
    gen = torch.Generator(device=DEV).manual_seed(3)
    # dqkv against max|plain|: f32 1e-4; bf16 4 ulps (P, dS*scale and the
    # outputs round to bf16, so a last-bit difference flips a rounding).
    # dbias, an f32 sum over windows: 1e-4 of its largest value.
    tol = {"f32": 1e-4, "bf16": 4 * 2.0 ** -8}
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    cases = [(s, BUCKET * (8 >> s) ** 2, 3 << s, (8 >> s) ** 2 if s < 3 else 1, 56 >> s, 7)
             for s in range(4)]
    cases.append(("w12", 256, 4, 64, 96, 12))
    for stage, g, heads, m, grid, window in cases:
        for dtype in ("bf16", "f32"):
            qkv, bias, mask, scale = attn_case(g, heads, m, grid, window, dtype, gen)
            n, c = window * window, heads * 32
            go = torch.randn(g, n, c, generator=gen, device=DEV).to(DT[dtype])
            dqkv, dbias = A.fused_attention_qkv_bwd(qkv, bias, mask, go, scale, heads)
            torch.cuda.synchronize()
            rq, rb = A.reference_attention_bwd(qkv, bias, mask, go, scale, heads)
            err, err_b = max_err(dqkv, rq), max_err(dbias, rb)
            lim = tol[dtype] * float(rq.float().abs().max())
            lim_b = 1e-4 * float(rb.abs().max())
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim and err_b <= lim_b
            log(f"K2 stage {stage} G={g} H={heads} N={n} M={m} {dtype}: max|err| dqkv {err:.3e} "
                f"(tol {lim:.3e}), dbias {err_b:.3e} (tol {lim_b:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"window attention backward disagrees with its plain version at stage "
                     f"{stage} {dtype}")
            if dtype != "bf16":
                continue
            ms = cuda_ms(lambda: A.fused_attention_qkv_bwd(qkv, bias, mask, go, scale, heads))
            plain = cuda_ms(lambda: A.reference_attention_bwd(qkv, bias, mask, go, scale, heads))
            lib, backend = None, "not measured"
            try:  # a yardstick only: the port never calls SDPA
                q, k, v, am = (t.detach().requires_grad_() for t in
                               attn_sdpa_inputs(qkv, bias, mask, heads))
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
                gout = go.view(g // m, m, n, heads, 32).permute(0, 1, 3, 2, 4).reshape(out.shape)

                def sdpa_bwd():
                    return torch.autograd.grad(out, (q, k, v, am), gout, retain_graph=True)

                lib = cuda_ms(sdpa_bwd)
                backend = sdpa_backend(sdpa_bwd)
                del q, k, v, am, out, gout
            except RuntimeError as e:
                log(f"   sdpa backward: not measured ({e})")
            nbytes = 2 * g * n * 7 * c + 4 * (2 * heads + m) * n * n
            b, by = bound_ms(nbytes, 10 * g * heads * n * n * 32, "bf16")
            log(f"   bf16 times: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa backward "
                f"{lib if lib is None else round(lib, 4)} ms ({backend}), bound {b:.4f} ms ({by})")
            rows.append(dict(stage=stage, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by, backend=backend))
    return rows, worst


def check_mlp_bwd():
    gen = torch.Generator(device=DEV).manual_seed(4)
    # each gradient against max|plain|: f32 5e-4; bf16 2e-2 (h, g, du and dx
    # round to bf16, and a last-bit difference in f32 flips a rounding)
    tol = {"f32": 5e-4, "bf16": 2e-2}
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    cases = [(s, BUCKET * (56 >> s) ** 2, 96 << s, False) for s in range(4)]
    cases.append(("ragged+gamma", 1000, 96, True))
    cases.append(("fma-width", 1000, 40, True))
    names = ("dx", "ds", "db", "dw0", "db0", "dw1", "db1", "dgamma")
    for stage, r, c, use_gamma in cases:
        for dtype in ("bf16", "f32"):
            args, gamma = mlp_case(r, c, dtype, gen, use_gamma)
            args = args[:7]
            dy = torch.randn(r, c, generator=gen, device=DEV).to(DT[dtype])
            got = M.fused_ln_mlp_bwd(*args, gamma, dy, 1e-5)
            torch.cuda.synchronize()
            want = M.reference_ln_mlp_bwd(*args, gamma, dy, 1e-5)
            rel = {}
            for name, gv, wv in zip(names, got, want):
                if (gv is None) != (wv is None):
                    fail(f"LN-MLP backward: {name} is None on one side only")
                if gv is not None:
                    rel[name] = max_err(gv, wv) / max(float(wv.float().abs().max()), 1e-30)
                    worst[dtype] = max(worst[dtype], max_err(gv, wv))
            bad = max(rel.values())
            ok = bad <= tol[dtype]
            f = 4 * c
            tc = M.tensor_cores(DT[dtype], c, f)
            log(f"K6 stage {stage} R={r} C={c} F={f} tile="
                f"{M.pick_tile_rows(c, tc, M.bwd_smem_bytes)} tc={tc} {dtype}: max rel err "
                f"{bad:.3e} ({max(rel, key=rel.get)}; tol {tol[dtype]:.1e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"LN-MLP backward disagrees with its plain version at stage {stage} {dtype}")
            if dtype != "bf16" or use_gamma:
                continue
            ms = cuda_ms(lambda: M.fused_ln_mlp_bwd(*args, None, dy, 1e-5), iters=5)
            plain = cuda_ms(lambda: M.reference_ln_mlp_bwd(*args, None, dy, 1e-5), iters=5)
            nbytes = 2 * (3 * r * c + 4 * c * f) + 4 * 2 * (4 * c + f)
            # without a layer-scale: the u recompute, dgl, dh, dw1 and dw0, 2*R*C*F
            # each (recomputing y serves only dgamma)
            b, by = bound_ms(nbytes, 10 * r * c * f, "bf16")
            log(f"   bf16 times: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b:.4f} ms ({by})")
            rows.append(dict(stage=stage, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by))
    return rows, worst


def per_forward(rows, key):
    """One bucket-64 forward's (or batch-64 train step's) time: each stage's
    launches times its time."""
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


def ln_mlp_blocks(dtype):
    """The swin_tiny blocks whose MLP takes the LN-MLP kernels in ``dtype``
    (with the NKBX_FUSED_* switches unset)."""
    return sum(d for d, c in zip(DEPTHS, (96, 192, 384, 768))
               if M.fused_mlp_mode(None, torch.empty(1, c, dtype=dtype, device=DEV), 4 * c))


def serve_all(serving, requests):
    outs = [serving(r) for r in requests]
    torch.cuda.synchronize()
    return outs


def profile_forward(serving, x, step_ms):
    """Device time by kernel over 3 forwards at bucket 64 (torch.profiler) of
    the batch ``x`` already on the card: the work that ``compute_p50_ms``
    times. The idle share is against ``step_ms``, that p50 measured without
    the profiler; a negative share would mean the two measure different
    work."""
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
        f"{step_ms:.3f} ms compute_p50 unprofiled (idle share {1 - total / step_ms:.3f})")
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
    stages_on = ln_mlp_blocks(torch.bfloat16)
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
        profile_forward(serving, torch.as_tensor(requests[2], device=DEV),
                        bench["kernels"][-1]["compute_p50_ms"])
    except Exception as e:  # noqa: BLE001
        log(f"profile: not measured ({type(e).__name__}: {e})")
    return la, lm, bench


# --- phase 5: the training path --------------------------------------------------

COUNTED = {"window_attention": (A, "fused_attention_qkv"), "ln_mlp": (M, "fused_ln_mlp"),
           "window_attention_bwd": (A, "fused_attention_qkv_bwd"),
           "ln_mlp_bwd": (M, "fused_ln_mlp_bwd")}


def zero_counts():
    for mod, fn in COUNTED.values():
        getattr(mod, fn).launches = 0


def read_counts():
    return {name: getattr(mod, fn).launches for name, (mod, fn) in COUNTED.items()}


def expected_launches(dtype):
    """Each kernel's launches in one swin_tiny forward and backward."""
    n = ln_mlp_blocks(dtype)
    return {"window_attention": 12, "ln_mlp": n, "window_attention_bwd": 12, "ln_mlp_bwd": n}


def check_grads(model, init, criterion, pipe, images, labels, mask):
    """Every tensor's grads of one backward of the batch from the weights
    ``init``: bf16 and f32 (TF32 off), each through the kernels and through
    the plain versions, with the launch counts of each.

    f32: kernels against plain within 1e-3 of each tensor's largest value.
    bf16: the two paths round to bf16 at the same points but in a different
    order of sums, so their grads differ by bf16 noise, which is largest
    (a few 1e-2 of the tensor's largest value) in the relative-position-bias
    tables, sums of dS over every window. The yardstick is the plain bf16
    path's own distance from the f32 grads: through the kernels each tensor
    must lie within twice that distance (plus 1e-3) of the f32 grads. A wrong
    bf16 backward, off by O(1), fails."""
    def grads(module, x, plain):
        set_plain(plain)
        module.zero_grad(set_to_none=True)
        zero_counts()
        criterion(module(x), labels, mask=mask).backward()
        torch.cuda.synchronize()
        out = {n: p.grad.clone() for n, p in module.named_parameters()}
        set_plain(False)
        return out, read_counts()

    def rel(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    m32 = get_model({"model": "swin_tiny_patch4_window7_224"}, model.classes, seed=0,
                    dtype=torch.float32)
    g = {}
    for dtype, module in ((torch.float32, m32.module), (torch.bfloat16, model.module)):
        module.load_state_dict(init)
        module.train()
        x = pipe.device_apply(images, out_dtype=dtype)
        want = expected_launches(dtype)
        for plain in (False, True):
            g[dtype, plain], counts = grads(module, x, plain)
            ok = counts == (dict.fromkeys(want, 0) if plain else want)
            log(f"grads {DTYPE_NAME[dtype]} {'plain' if plain else 'kernels'}: launches {counts} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok or want["ln_mlp_bwd"] == 0:
                fail("the gradient check did not compare the kernels with the plain path")
    del m32
    g32 = g[torch.float32, True]
    worst = max((rel(g[torch.float32, False][n], g32[n]), n) for n in g32)
    log(f"grads f32: max |kernels - plain| / max|plain| per tensor = {worst[0]:.3e} "
        f"({worst[1]}; tol 1.0e-03)")
    if worst[0] > 1e-3:
        fail("f32 grads through the kernels disagree with the plain path")
    gk, gp = g[torch.bfloat16, False], g[torch.bfloat16, True]
    rows = [(rel(gk[n], g32[n]), rel(gp[n], g32[n]), rel(gk[n], gp[n]), n) for n in g32]
    bad = [r for r in rows if not r[0] <= 2 * r[1] + 1e-3]
    ratio = max(rows, key=lambda r: r[0] / max(r[1], 1e-30))
    log(f"grads bf16: per tensor, distance from the f32 grads through the kernels / through "
        f"plain at most {ratio[0] / max(ratio[1], 1e-30):.3f} ({ratio[3]}: {ratio[0]:.3e} / "
        f"{ratio[1]:.3e}; tol 2 x plain + 1e-3); largest distance from f32 (/ its max) "
        f"kernels {max(r[0] for r in rows):.3e}, plain {max(r[1] for r in rows):.3e}; "
        f"{len(bad)} tensors off")
    rows.sort(key=lambda r: -r[2])
    for r in rows[:4]:
        log(f"  {r[3]}: kernels - plain {r[2]:.3e}, kernels - f32 {r[0]:.3e}, "
            f"plain - f32 {r[1]:.3e}")
    if bad:
        fail(f"bf16 grads through the kernels are farther from f32 than plain bf16: {bad[:5]}")


def profile_step(step_fn, step_ms):
    """Device time by kernel over one train step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        log("profile: no device time recorded (not measured)")
        return
    total = sum(dev_us(e) for e in events) / 1e3
    log(f"profile: device busy {total:.3f} ms in one batch-64 train step, against "
        f"{step_ms:.3f} ms unprofiled (idle share {1 - total / step_ms:.3f})")
    events.sort(key=lambda e: -dev_us(e))
    lines = [f"{dev_us(e) / 1e3:10.4f} ms  {e.count:5d}x  {e.key[:90]}" for e in events]
    for line in lines[:12]:
        log("  " + line)
    with open(os.path.join(OUT_DIR, "profile_train_step.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def check_train():
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize, VerticalFlip

    classes = [f"class{i}" for i in range(10)]
    model = get_model({"model": "swin_tiny_patch4_window7_224"}, classes, seed=0,
                      dtype=torch.bfloat16)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    pipe = Compose([HorizontalFlip(), VerticalFlip(), Normalize()])
    criterion = get_loss({"type": "CrossEntropyLoss"})
    # without warmup, NAdam's first steps move every weight by about lr: at a
    # backbone lr of 1e-4 the loss of a random-weight swin_tiny rises on the
    # CPU as on the card, so the check takes a fine-tuning recipe's lrs
    bundle = get_optimizer({"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4,
                            "weight_decay": 0.05})
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8),
                             device=DEV)
    labels = torch.as_tensor(rng.integers(0, 10, BUCKET), device=DEV)
    mask = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    mask[-6:] = False

    def fresh(plain):
        set_plain(plain)
        model.module.load_state_dict(init)
        state = TrainState.create(model, seed=0)
        step = build_train_step(model, criterion, bundle, augment_fn=pipe.device_apply)
        return state, lambda st: step(st, images, labels, mask, 1.0, 1.0)

    def five_steps(plain):
        state, step = fresh(plain)
        losses, counts = [], []
        for _ in range(5):
            zero_counts()
            state, metrics = step(state)
            torch.cuda.synchronize()
            counts.append(read_counts())
            losses.append(float(metrics["loss"]))
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.module.parameters())
        return losses, counts, finite

    set_plain(False)
    want = expected_launches(torch.bfloat16)
    losses, counts, finite = five_steps(False)
    log(f"train: kernels, 5 steps, losses {[round(x, 5) for x in losses]}, launches per step "
        f"{counts[0]} (expect {want})")
    if any(c != want for c in counts) or want["ln_mlp_bwd"] == 0:
        fail(f"the train step did not go through the kernels as expected: {counts}")
    if not finite or not all(np.isfinite(losses)):
        fail("non-finite loss or gradient through the kernels")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the repeated batch: {losses}")
    launches = {k: sum(c[k] for c in counts) for k in want}
    plain_losses, plain_counts, _ = five_steps(True)
    if any(sum(c.values()) for c in plain_counts):
        fail(f"the plain path launched kernels: {plain_counts}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    log(f"train: plain, 5 steps, losses {[round(x, 5) for x in plain_losses]}; max |kernels - "
        f"plain| / |plain| = {rel:.3e} (tol 5.0e-03)")
    if rel > 5e-3:
        fail("bf16 losses through the kernels disagree with the plain path")
    set_plain(False)
    check_grads(model, init, criterion, Compose([Normalize()]), images, labels, mask)

    bench = {}
    for label, plain_on in (("kernels", False), ("plain", True), ("kernels", False)):
        state, step = fresh(plain_on)
        state, _ = step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            state, _ = step(state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        r = {"step_ms": ms, "images_per_sec": BUCKET / ms * 1e3,
             "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        bench.setdefault(label, []).append(r)
        log(f"train step (batch {BUCKET}) {label}: {json.dumps(r)}")
    set_plain(False)
    try:  # a measurement only: the checks above decide the run
        state, step = fresh(False)
        state, _ = step(state)
        profile_step(lambda: step(state), bench["kernels"][-1]["step_ms"])
    except Exception as e:  # noqa: BLE001
        log(f"profile: not measured ({type(e).__name__}: {e})")
    return launches, bench


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
    attn_bwd_rows, attn_bwd_err = check_attention_bwd()
    mlp_bwd_rows, mlp_bwd_err = check_mlp_bwd()
    la, lm, _ = check_path()
    train_launches, _ = check_train()

    fwd, step = "one bucket-64 swin_tiny forward, bf16", "one batch-64 swin_tiny train step, bf16"
    kernels = []
    for name, src, replaces, rows, err, launches, per in (
            ("window_attention", "nkbx_torch/ops/csrc/window_attention.cu",
             "nkbx/ops/attention.py:302", attn_rows[:4], attn_err, la, fwd),
            ("ln_mlp", "nkbx_torch/ops/csrc/ln_mlp.cu", "nkbx/ops/mlp.py:504",
             mlp_rows[:4], mlp_err, lm, fwd),
            ("window_attention_bwd", "nkbx_torch/ops/csrc/window_attention_bwd.cu",
             "nkbx/ops/attention.py:313", attn_bwd_rows[:4], attn_bwd_err,
             train_launches["window_attention_bwd"], step),
            ("ln_mlp_bwd", "nkbx_torch/ops/csrc/ln_mlp_bwd.cu", "nkbx/ops/mlp.py:520",
             mlp_bwd_rows[:4], mlp_bwd_err, train_launches["ln_mlp_bwd"], step)):
        bound = per_forward(rows, "bound_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err["bf16"], "max_abs_err_f32": err["f32"],
            "ms": per_forward(rows, "ms"), "plain_ms": per_forward(rows, "plain_ms"),
            "bound_ms": bound,
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": per_forward(rows, "library_ms") if "library_ms" in rows[0] else None,
            "per": per,
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
