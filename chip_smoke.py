#!/usr/bin/env python3
"""Smoke run of the nkbx_torch port on one CUDA card (an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Builds every kernel in nkbx_torch/ops/csrc with nvcc (all at once) and
   prints the build time and ptxas's register/shared-memory report.
2. Holds each forward kernel against its plain PyTorch version on the card,
   in bf16 and in f32 with TF32 off; prints the errors against the stated
   tolerances and the times of the kernel, the plain version and, for
   attention, scaled_dot_product_attention on the same inputs. Window
   attention (K1) at the shapes the Swin-T serving path gives it at bucket
   64 with the shifted-window masks and at window 12, bf16 on its
   tensor-core design and f32 on its first design (the route checked by its
   count), also at N = 16, 17, 48, 63, 64 and 65 with a shared and a
   per-head bias and a G its windows-per-block count does not divide,
   within 2 bf16 ulps of the largest output (f32 1e-4), a second launch
   bit-identical; at the stages and window 12 timed with a cold L2 against
   its first design (through its C entry), plain and SDPA, with the SDPA
   backend and the share of the bound. LN -> MLP (K5) at the shapes the
   Swin-T serving path gives it at bucket 64, ConvNeXt-T's with its
   layer-scale and ViT-B's (C = 768, B*197 rows at buckets 64 and 8), a
   ragged tile and a width off the tensor-core grid: bf16 on its GEMM route
   and f32 on its first design (the route checked by count), 4 bf16 ulps of
   the largest value (f32 5e-4), a second launch bit-identical; timed with a
   cold L2 against its first design (through its C entry), plain and its
   two products alone through torch.matmul (not one call), each with its
   share of the bound; full-sequence attention (K3) at ViT-B's 12 heads of width
   64 at bucket 64 for N = 50, 197 (the main shape) and 577, a small
   case with a learned (H, N, N) bias and a mask of M = 2, and small cases
   at N = 1, 17, 63, 64 and 65 with None for the bias and mask or a
   learned bias and a mask, two launches bit-identical; at ViT-B's three
   sequences timed with a cold L2 twice, with the zero tensors against
   SDPA's float mask and with None (the ViT's path) against SDPA
   unmasked, with each time's share of the bytes bound; the MLP alone
   (K7) at the four stage shapes of ConvNeXt-T at bucket 64 (the R and C of
   K5's Swin-T cases) and ViT-B's (C = 768 at buckets 64 and 8), bucket 1's
   ragged 49 rows at C = 768 and a width off the tensor-core grid: bf16 on
   its GEMM route and f32 on its first design (the route checked by count),
   4 bf16 ulps of the largest value (f32 5e-4), a second launch
   bit-identical; timed as K5. The fused bottleneck chain (K9) at
   ResNet-50's stage shapes at batch 64 with ghost_bn = 2, in each dtype at
   the stages and bands that nkbx's rule (stat_band) gives (bf16 stages
   1-3, th = 8/7/2; f32 stages 1-2, th = 4/4), a small single-band case
   (th = H) and, in bf16, bands of 5 and 2 rows of a 10-row image and a
   single band at C = 96: the output and the six per-tile statistics
   against the plain chain on the same bands, bf16 on its tensor-core route
   and f32 on its first design (the route checked by count), a second
   launch bit-identical; at the bf16 stages the first design (through the
   launch helpers) held against plain on the same operands too, then both
   designs and plain timed with a cold L2, each with its share of the
   bound (the route slower than the first design fails). The
   ResNet-family probes: X1, the matmul with the BatchNorm-apply + relu
   epilogue and the output's statistics, in bf16 on its route on wgmma +
   TMA (the route checked by its count) at the probe's three shapes,
   ResNet's 256->64 and 64->256 at 50,176 rows and a ragged N, its first
   design (through its C entry) at the probe's shapes and in f32 at the
   probe's test shape: y within one bf16 ulp (f32 2e-5), sums 1e-4, a second
   launch bit-identical; timed with a cold L2 in turns, route, first design,
   torch.matmul with the eager epilogue and plain, each design's share of
   the bytes bound (over 100% fails; so does a route not faster than the
   first design); X2, the 3x3
   grouped convolution, at resnext50_32x4d's four stages (bf16; f32 at
   stages 1-2) and the probe's check shapes, two launches bit-identical,
   timed with a cold L2 against cuDNN's grouped convolution and its bytes
   bound. X3-X7, the Swin layout probes (copy, transpose of a
   G-minor tensor, window gather and scatter, merge, split, pad8), at the
   probes' shapes in bf16 and each function's last shape in f32: equal bit
   for bit to their plain versions and to a second launch; timed with the
   L2 flushed before every launch, in turns with the library's one call
   (library, kernel, plain, then kernel and library twice), against their
   bytes bound (a share over 100% fails), the kernel's margin over the
   library logged against the spread of the turns; ``python3 chip_smoke.py
   --layout`` runs that phase alone, also from a copy of this file in
   another checkout.
3. The same for the backward kernels: K2 and K6 at the shapes of a batch-64
   Swin-T train step (and window 12 for K2; K6 at K5's shapes, its route by
   count, each gradient within 2e-2 of its largest (f32 5e-4), timed as K5
   with its products alone through torch.matmul); K2 in bf16 on its
   tensor-core design and in f32 on its first design (the route checked by
   its count), also at N = 16, 17, 48, 63, 64 and 65 with a shared and a
   per-head bias and a G its windows-per-block count does not divide, dqkv
   within 4 * 2^-8 of its largest value, dbias 1e-4 of its largest, a
   second launch bit-identical; at the stages and window 12 timed with a
   cold L2 against plain and SDPA's backward, with the SDPA backend and
   the share of the bound; K4 at K3's shapes (dbias
   checked in the small case) and at N = 1, 17, 63, 64 and 65 with None or
   a learned bias and mask with dbias, in bf16 and f32, 4 bf16 ulps of the
   largest gradient, a second launch bit-identical; at ViT-B's three
   sequences timed with a cold L2 with None (the ViT's path, the
   tensor-core pair) against SDPA's unmasked backward, with the zeros and
   with a learned bias and mask (no dbias) against SDPA given their float
   mask, each first held against plain, with its share of the bound; K8 at
   K7's shapes, held and timed as K6 (its five products alone through
   torch.matmul); K10 at K9's (all ten gradients). The library time of a
   backward is the backward alone of scaled_dot_product_attention, with the
   SDPA backend that ran; no PyTorch call computes K5-K10. K10 as K9 (all
   ten gradients by their relative L2, both designs, route by count, a
   second launch bit-identical, cold L2).
4. Drives the serving path of swin_tiny_patch4_window7_224, of
   vit_base_patch16_224 and unicom ViT-B/16 (fused_attention and fused_mlp
   on; unicom: N = 196 tokens, no class token, LayerNorm eps 1e-5, the
   flattened-token head with its BatchNorm1d pair) and of convnext_tiny,
   twice (through K5 and, under NKBX_FUSED_LN_MLP=0, through K7), bf16, random weights from a seed (ConvNeXt's layer-scales drawn from
   U[0.1, 1]: at flax's 1e-6 every MLP gradient would sit under the
   gradient check's floor): a ServingModule with buckets (1, 8, 64) answers
   requests of 1, 5, 64 and 70 seeded uint8 224x224 images. Checks each
   kernel's launch count, finite logits of the right shapes, and agreement
   with the same model run through the plain versions in bf16 and f32; then
   times benchmark(64) through the kernels and through the plain versions,
   the peak memory, and a profile of where the device time goes, with the
   attention kernel's and K5's (or K7's) device time in it (Swin-T's bf16
   K1 launches all on its tensor-core design, every bf16 K5 and K7 launch on
   its GEMM route).
5. Drives the training path of every model of phase 4 at full width and
   depth (bf16, 10 classes), and of resnet50 with ghost_bn = 2 and the fused
   chain (nkbx's ghost2_fused recipe; the chain runs in training only, so
   this path has no serving phase), nadam with two groups, cross-entropy,
   flips + Normalize, a seeded uint8 batch of 64 with the last 6 rows masked
   out (every row valid for ResNet: ghost BN is the recipe with
   drop_last=True; unicom's masked rows leave its head's BatchNorm1d
   statistics). 5 steps through the kernels (launch counts per step,
   finite grads, falling loss) and the same 5 steps from the same weights
   through the plain versions (NKBX_FUSED_CHAIN=0 runs the plain chain on
   the same bands; losses agree). For ResNet also the BatchNorm running
   statistics after the 5 steps, the same 5 steps in f32 through the
   kernels and the plain chain (losses and running statistics held
   tightly: bf16 rounding noise grows along a trajectory of 50 layers of
   ghost-BN statistics; the later bf16 losses keep only a loose 3e-2). Every
   tensor's grads of one backward of that batch, in bf16 and in f32 (TF32
   off), through the kernels and through the plain versions (launch counts
   checked): in f32 the kernels agree with plain, and in bf16 they are no
   farther from the f32 grads than plain bf16 is (within 2x). For ResNet
   the f32 grads are held against the plain path's own sensitivity to a
   1-ulp perturbation of its input (check_gated_grads), and in bf16 each of
   the step's chain blocks: K9/K10 on the inputs and upstream gradient
   recorded from one train step, against the plain chain at check_chain's
   tolerances (check_chain_blocks). Then step time, img/s and peak memory
   of both paths (for ResNet also of the unfused ghost-BN resnet50 from the
   same weights, the model a user would run without the chain), and a
   profile of one step through the kernels and one through the plain
   versions (for ResNet its bf16 K9 and K10 launches all on their
   tensor-core route, f32's on the first design; then check_resnet_step:
   the step's device time, idle share, peak memory and K9's and K10's
   device ms a step, K9's from a profiled train-mode forward, K10's the
   step's chain kernels less K9's; ``python3 chip_smoke.py --resnet-step``
   runs that phase alone, also from a copy of this file in another
   checkout, to measure that checkout's kernels the same way), with the attention and MLP kernels' device time in it (K1 and
   K2 for Swin-T, K2 with its dbias reduction, K3 and K4 for ViT-B, K5 and
   K6 (K7 and K8 under the switch) for the three transformers-and-ConvNeXt;
   Swin-T's bf16 K1 and K2 launches all on their tensor-core designs, every
   bf16 K5-K8 launch on its GEMM route; a profile that records no device
   time fails the run).
   Then resnet50 with exact
   BatchNorm, which runs no kernel of ours (its launch counts are read and
   must stay 0):
   RESNET_EXACT, bench.py's program (224 px, 1000 classes, batch 128, bf16,
   flips + Normalize, sgd at lr 0.1): step 0's loss against f32, finite
   losses and grads, 2 warm-up and 5 timed steps (step ms, img/s, peak
   memory) and a profile of one step by kind of kernel; RESNET_MASKED,
   masked_bn=True on the batch of 64 with 6 padded rows: in f32 one step
   equals the exact step on the 58 valid rows (loss, running statistics,
   grads by check_gated_grads), then the bf16 step timed against the exact
   step at batch 64. BENCH (check_bench): ``python -m nkbx_torch.bench`` in
   a subprocess (RESNET_EXACT's program, K = 10 steps a call): one line, a
   finite value between 0.85 times RESNET_EXACT's host img/s and 1.05
   times its device-bound img/s, the card's name. DROPOUT (check_dropout;
   ``python3 chip_smoke.py --bench`` runs RESNET_EXACT, BENCH and DROPOUT
   alone): vit_base_patch16_224 with classifier and backbone dropout at
   0.1, bf16: two 3-step runs from one seed bit-equal, a run resumed from
   a checkpoint after step 2 bit-equal to them; the cost of a mask at
   ViT-B's mid-MLP shape drawn for worlds of 1-8 ranks.
6. The trainer path (check_trainer): a seeded ImageFolder of BMP files and
   a config in nkbx's form (swin_tiny, batch 64, 2 epochs) under
   build/trainer_smoke/; ``python -m nkbx_torch.train -cfg`` in a
   subprocess; no nkbx module after loading the config; ``train``'s
   per-step losses equal to the bare step's, with each step's launches;
   SIGTERM in epoch 2 and a resumed run equal to the uninterrupted one;
   the loader's, the trainer's and the bare step's img/s and the idle
   share of an epoch.
7. The probe path: the command-line probes of X1-X7 (``python -m
   nkbx_torch.ops.matmul_bn``, ``python -m nkbx_torch.ops.grouped_conv
   --wide`` and ``python -m nkbx_torch.ops.layout``), their launch counts
   set to 0 before and read after, every X1 launch on its route.
8. The shipped-config path (SHIPPED, check_shipped), the user's workflow
   on the repo's own configs, which runs no kernel of ours (the counts stay
   0): (a) ``python -m nkbx_torch.train`` on configs/singletask_config.py
   with only the data paths, run directory, n_epochs (2) and num_workers
   changed and its Comet section set as its comment shows (resnet14t at 128
   px, pretrained without a file: the warning must appear; no ``comet_ml``
   on the card's machine: nkbx's warning must appear and metrics.csv carry
   the columns of local logging alone; weighted sampling; flips,
   brightness/contrast, HSV, coarse dropout and Normalize on the card;
   nadam, cosine, the freeze policy; batch 64) over a seeded annotated CSV
   of 200 + 70 BMP images under build/shipped_smoke/; then EXPORT (5)'s
   two longest subprocesses start and run beside what follows; (b) ``python
   -m nkbx_torch.eval`` on the run's weights/best.pt: balanced accuracy and
   loss within 1e-6 relative of metrics.csv's best epoch; (c) ``python -m
   nkbx_torch.inference`` on a flat folder of the val images (at once with
   (b)): a row per image, labels in classes.json and equal to argmax of
   build_predict_fn; (d) the singletask device stage
   on a batch of 64 at 128 px with fixed draws against the CPU (1e-3 on the
   0-255 scale, 1e-5 after Normalize) and its ms a batch; (e)
   configs/multitask_config.py (efficientnet_b0, 224 px) and
   configs/yolo_crops_config.py (mobilenetv3_large_100, 128 px, FocalLoss)
   at batch 64: bf16 logits within 5% of the largest f32 logit, 5
   build_train_step steps on their pipelines with finite losses, a
   bucket-64 ServingModule forward, step and serving img/s and peak memory;
   mobilenetv3_small_100 and efficientnetv2_s one forward each, bf16
   against f32 (the yolo_crops train CLI runs from (a) on, for EXPORT).
9. The rest of the zoo (ZOO, check_zoo): densenet121 at 224 px, batch 64:
   bf16 against f32, 1 + 5 train steps with finite and falling losses, step
   img/s, peak memory and a profile, a bucket-64 ServingModule forward and
   its img/s (no kernel of ours runs: the counts stay 0); densenet169,
   densenet201 and unicom ViT-B/32 one forward each, bf16 against f32;
   unicom ViT-L/14 with the fused flags: the MLP lowering the shared-memory
   gate takes at C = 1024, one forward in f32 and in bf16 with K3's (N =
   256, 16 heads) and the MLP kernel's launches counted, bf16 against f32
   and against the plain versions.
10. pos_embed resampled on load (RESAMPLE, check_resample): a seeded
   timm-layout vit_base_patch16_224 file through ``python -m
   nkbx_torch.models.convert`` into a temporary $NKBX_PRETRAINED_DIR as
   vit_base_patch16_384.msgpack; vit_base_patch16_384 at 384 px with
   ``pretrained`` and fused_attention: its pos_embed resampled 197 -> 577
   equal to the same resample on the CPU; a bucket-64 forward through K3 at
   N = 577 (12 launches) against the plain versions, and its img/s.
11. configs/modern_recipe_config.py in the port (MODERN, check_modern):
   (a) its device stage, RandAugment (num_ops 2, magnitude 9, 4 affine
   grids) + Normalize, and TrivialAugmentWide, on a CUDA batch of 32 at 224
   px (every op drawn) against the CPU with the same draws, round by round,
   and their ms a batch of 128; (b) its bare step (resnet50, batch 128,
   bf16, exact BN, CutMix, label smoothing, sgd lr 0.5, EMA 0.9998) as one
   call of 20 steps: finite losses, stacked metrics, the EMA shadow; img/s
   of the call against 20 single calls, idle shares (the call's against a
   profiled single step's device ms), peak memory, the device stage, mixup
   and EMA alone; in f32 3 steps in one call against 3 single calls; (c)
   ``python
   -m nkbx_torch.train`` on the config with only its data roots, run
   directory, n_epochs (2) and num_workers changed, over a seeded ImageFolder
   of BMP files (a call of 20 steps and one of 5 an epoch), with the
   pretrained and ``mixup_alpha`` warnings; (d) ``python -m nkbx_torch.eval``
   on its best.pt, equal to metrics.csv's best epoch, best.pt the EMA
   shadow; none of (a)-(d) runs a kernel of ours (the counts stay 0); (e),
   beside (c)'s CLI: swin_tiny at batch 64 with grad_accum_steps=2, EMA,
   mixup and log_gradients: K1, K2, K5 and K6 launch twice a step
   (counted), 3 steps agree with the plain versions, the gradient norms
   carry nkbx's keys.
12. Export (EXPORT, check_export; ``python3 chip_smoke.py --export`` runs
   it alone after SHIPPED (a)-(c)), bf16, seed 0, 10 classes, full width:
   (1) swin_tiny's best.pt through ``python -m nkbx_torch.export`` in
   subprocesses, a portable bundle (dynamic batch, max 64) and a fused one
   (``--fused-attention``, static batch 64), each reloaded in a
   ServingModule and serving requests of 1, 5, 64 and 70 images of one
   normalised batch: the fused bundle launches K1 and K5 12 times a forward
   (counted) and agrees with the eager model through the kernels within 2
   bf16 ulps of the largest logit, the portable one launches none and
   agrees with the eager plain model as closely, both within 5% of the
   plain f32 model's largest logit; (2) vit_base_patch16_224 with the fused
   flags (K3 and K5, 12 each) and (3) convnext_tiny under
   NKBX_FUSED_LN_MLP=0 (K7, 18), fused bundles exported in this process,
   the same checks; (4) ``python -m nkbx_torch.export.serving --sweep`` on
   the portable bundle (beside the rest of the phase), then, alone on the
   card, one turn of benchmark(64) of swin's fused bundle, its portable
   bundle and the eager model-backed ServingModule; (5) the
   shipped configs as shipped: SHIPPED (a)'s run exported with ``python -m
   nkbx_torch.export -cfg`` its config, configs/eval_config.py and
   configs/inference_config.py with ``scripted: True`` through the eval and
   inference CLIs against SHIPPED (b)-(c)'s rebuilt model (1e-3 relative;
   labels but for top-two ties within 2 bf16 ulps),
   configs/yolo_crops_config.py through the train CLI (2 epochs over a
   seeded YOLO-layout set; export_serving leaves best.nkbx and last.nkbx),
   and ``python -m nkbx_torch.det_cls_val`` on its best.nkbx with a
   detections CSV (the train and the singletask export started in SHIPPED;
   eval, inference and det_cls_val start with the phase, beside (1)-(3));
   (6) swin_tiny's ``--to torchscript`` file reloaded with torch.jit.load
   against the eager plain model (2 bf16 ulps). The phase's seconds; the
   CLIs' logs go to OUT_DIR as export_*.log.
13. nkbx's max-throughput opt-ins and the one-card tools (OPTINS,
   check_optins; ``python3 chip_smoke.py --optins`` runs it alone): (a)
   ``remat_stages=(0, 1, 2, 3)`` on convnext_tiny (K5/K6) and on the
   resnet50 ghost2_fused step (K9/K10), bf16, batch 64: one step each with
   and without remat under deterministic algorithms, gradients, weights
   and running statistics bit-equal, K5 (or K9) launched twice a step under
   remat and each recomputed launch bit-identical to its forward launch;
   step ms and peak memory of both; (b) ``input_norm`` on resnet50 exact BN
   at batch 128 (bench.py's program) against the unfolded model with
   Normalize, eval-mode logits within 5% of the largest in bf16 and 1e-3 in
   f32, both bf16 steps timed; (c) ``bf16_master_weights``: 5 steps with
   bf16 masters beside 5 with f32 masters, each loss within 10% of the f32
   run's and falling, step ms and peak memory;
   (d) the tools in subprocesses: ``--to-torch`` on the trainer path's
   swin_tiny best.pt, converted back and loaded, logits bit-equal (K1, K5;
   the forwards under ``profile_trace``, whose trace's K1/K5 ms equal
   ``key_averages``', and ``python -m nkbx_torch.core.profiling`` on it),
   ``save_augs`` N = 16 over the trainer path's images against the device
   stage on the same draws, ``migrate --check`` on a reference-format
   config. The Swin-T train step's profile (phase 5) is also aggregated
   from its chrome trace: K1, K2, K5 and K6 with key_averages' ms.
14. Data parallelism over ranks (DIST, check_dist; ``python3 chip_smoke.py
   --dist`` runs it alone), ranks as subprocesses: (a) 2 gloo ranks on the
   card against one process (resnet50 exact and ghost2_fused, swin_tiny with
   CutMix, bf16; resnet50 f32 with classifier dropout); (b) the trainer CLI
   under torchrun against
   one process; (c) FSDP: vit_base with the fused flags, its state
   scattered over 2 gloo ranks (``fsdp``), 3 bf16 nadam steps with EMA
   against the replicated ranks on the same inputs (parameters, moments,
   EMA and losses bit for bit, or within one bf16 ulp of each tensor's
   largest value), against one process (a)'s rule, K3-K6 12 a step on each
   rank, the state at rest at most 0.502 of the replicated rank's, the
   peak memory of each step; the trainer CLI with ``fsdp = True`` against
   (b)'s 2 ranks; (d) a NCCL group of one rank against no group (beside
   (a)-(c)).
15. Prints the kernels' JSON line (all 17 kernels), the card's name and
   power limit, and last {"ok": true, "device": {...}}. Each phase prints
   its seconds and the whole run's so far as it ends.

Exits non-zero, before printing any result, without a CUDA device, outside
a checkout of the repository, or when any check fails.
"""

import contextlib
import json
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import textwrap
import time
from collections import defaultdict

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense bf16 tensor core / f32 without
DEPTHS = (2, 2, 6, 2)  # swin_tiny blocks per stage
CONVNEXT_DEPTHS = (3, 3, 9, 3)  # convnext_tiny blocks per stage
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
    from nkbx_torch.ops import bottleneck as BN
    from nkbx_torch.core.profiling import aggregate_trace, device_events, kernel_kinds, kernel_ms
    from nkbx_torch.core.runtime import cold_ms
    from nkbx_torch.ops import grouped_conv as GC
    from nkbx_torch.ops import layout as L
    from nkbx_torch.ops import matmul_bn as MB
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


# Swin-T's four stages at bucket 64, shifted blocks for stages 0-2 (the mask with
# M windows), none at stage 3; then window 12: (stage, G, heads, M, grid, window)
SWIN_ATTN_CASES = [(s, BUCKET * (8 >> s) ** 2, 3 << s, (8 >> s) ** 2 if s < 3 else 1, 56 >> s, 7)
                   for s in range(4)] + [("w12", 256, 4, 64, 96, 12)]
# K1 and K2 alone at windows around their 16-row slabs, with a shared and a per-head
# bias: (label, heads, N, bias heads); G is ragged_windows' (one mask, M = 1)
ATTN_RAGGED = [(f"N={n} Hb={bh}", 2, n, bh) for n in (16, 17, 48, 63, 64, 65) for bh in (1, 2)]
ATTN_ITERS = 20  # cold-L2 launches timed a case (K1, K2)


def attn_fwd_bound(g, n, heads, m):
    """K1's least time: qkv read and the output written once, the bias and
    mask read once; 4 N^2 D operations per (window, head), its two
    products."""
    nbytes = 2 * g * n * 4 * heads * 32 + 4 * (heads + m) * n * n
    return bound_ms(nbytes, 4 * g * heads * n * n * 32, "bf16")


def ragged_windows(heads, n, blocks_per_sm, windows_per_block):
    """A G that a tensor-core design's windows-per-block count does not
    divide on this card: two runs of a head's blocks and one more window,
    one more where that count divides it."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    g = 2 * max(1, sms * blocks_per_sm(n) // heads) + 1
    return g + (g % windows_per_block(g, heads, n, sms) == 0)


def hold_attention(what, qkv, bias, mask, scale, heads, dtype, worst):
    """K1 twice against its plain version on these operands: within 1e-4
    (f32) or 2 bf16 ulps of the largest output (bf16: P and the output round
    to bf16, so a last-bit difference flips a rounding); the second launch
    bit-identical; the design the wrapper's route names (the tensor cores for
    bf16 at D = 32, N <= 144) launched. Fails otherwise."""
    n, d = qkv.shape[1], qkv.shape[2] // 3 // heads
    tc = A.takes_tc(n, d, qkv.dtype)
    before = A.fused_attention_qkv.tc_launches
    got = A.fused_attention_qkv(qkv, bias, mask, scale, heads)
    again = A.fused_attention_qkv(qkv, bias, mask, scale, heads)
    torch.cuda.synchronize()
    routed = A.fused_attention_qkv.tc_launches - before == (2 if tc else 0)
    ref = attn_plain(qkv, bias, mask, scale, heads)
    err = max_err(got, ref)
    lim = 1e-4 if dtype == "f32" else 2 * bf16_ulp(float(ref.float().abs().max()))
    same = torch.equal(got, again)
    worst[dtype] = max(worst[dtype], err)
    ok = err <= lim and same and routed
    log(f"K1 {what} {dtype} ({'tensor cores' if tc else 'first design'}): max|err| {err:.3e} "
        f"(tol {lim:.3e}), a second launch equal {same}, routed {routed} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"window attention disagrees with its plain version at {what} {dtype}")


def first_design(qkv, bias, mask, scale, heads):
    """K1's first design (window_attention_kernel) on bf16 operands that the
    wrapper sends to the tensor cores, launched through its C entry: a
    yardstick timed beside the new design, held against plain first, and
    launched by no path. Returns the launch."""
    g, n, c3 = qkv.shape
    out = torch.empty(g, n, c3 // 3, dtype=qkv.dtype, device=DEV)
    lib = _build.load("window_attention", A._SIGNATURES)

    def launch():
        _build.check(lib.nkbx_window_attention(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), g, n, heads,
            c3 // 3 // heads, bias.shape[0], mask.shape[0], float(scale), 1,
            torch.cuda.current_stream().cuda_stream), "window_attention launch")

    launch()
    torch.cuda.synchronize()
    ref = attn_plain(qkv, bias, mask, scale, heads)
    err, lim = max_err(out, ref), 2 * bf16_ulp(float(ref.float().abs().max()))
    if err > lim:
        fail(f"K1's first design disagrees with plain: {err:.3e} (tol {lim:.3e})")
    return launch


def check_attention():
    """K1 against its plain version (hold_attention) at SWIN_ATTN_CASES (bf16:
    the tensor-core design; f32: the first design), and at the ragged
    ATTN_RAGGED at a G that the windows-per-block count does not divide
    (bf16, f32). At the stages and window 12 (bf16) the kernel, its first
    design (first_design), the plain version and SDPA are timed with a cold
    L2 (cold_ms), after each set was held against plain; each row logs the
    SDPA backend and its share of the bytes bound, and a share over 100%
    fails."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    for stage, g, heads, m, grid, window in SWIN_ATTN_CASES:
        n = window * window
        for dtype in ("bf16", "f32"):
            qkv, bias, mask, scale = attn_case(g, heads, m, grid, window, dtype, gen)
            hold_attention(f"stage {stage} G={g} H={heads} N={n} M={m}", qkv, bias, mask,
                           scale, heads, dtype, worst)
            if dtype != "bf16":
                continue
            first = cold_ms(first_design(qkv, bias, mask, scale, heads), ATTN_ITERS)
            ms = cold_ms(lambda: A.fused_attention_qkv(qkv, bias, mask, scale, heads),
                         ATTN_ITERS)
            plain = cold_ms(lambda: attn_plain(qkv, bias, mask, scale, heads), ATTN_ITERS)
            q, k, v, am = attn_sdpa_inputs(qkv, bias, mask, heads)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)

            lib, backend = cold_ms(sdpa, ATTN_ITERS), sdpa_backend(sdpa)
            b, by = attn_fwd_bound(g, n, heads, m)
            log(f"   bf16 times (cold L2): kernel {ms:.4f} ms, first design {first:.4f} ms, "
                f"plain {plain:.4f} ms, sdpa {lib:.4f} ms ({backend}), bound {b:.4f} ms "
                f"({by}), kernel at {100 * b / ms:.1f}% of the bound")
            if b > ms:
                fail(f"K1 stage {stage} timed under its bound: the timing is wrong")
            rows.append(dict(stage=stage, ms=ms, first_ms=first, plain_ms=plain, library_ms=lib,
                             bound_ms=b, bound_by=by, bound_share=b / ms, backend=backend))
            del q, k, v, am
    for label, heads, n, bh in ATTN_RAGGED:
        g = ragged_windows(heads, n, A.fwd_tc_blocks_per_sm, A.fwd_tc_windows_per_block)
        for dtype in ("bf16", "f32"):
            qkv = torch.randn(g, n, 3 * heads * 32, generator=gen, device=DEV).to(DT[dtype])
            bias = (0.5 * torch.randn(bh, n, n, generator=gen, device=DEV)).contiguous()
            mask = torch.where(torch.rand(1, n, n, generator=gen, device=DEV) < 0.2, -100.0, 0.0)
            hold_attention(f"{label} G={g} H={heads} M=1", qkv, bias, mask, 32 ** -0.5, heads,
                           dtype, worst)
    return rows, worst


# --- phase 2: LN -> MLP (K5) --------------------------------------------------

# The timed LN -> MLP shapes, bf16: Swin-T's four stages at bucket/batch 64 (R =
# 64 * 56^2 ... 64 * 7^2, C = 96 ... 768, F = 4C), ConvNeXt-T's four stages (the
# same R and C) with its layer-scale, ViT-B's MLP (C = 768) at buckets 64 and 8
# (B*197 rows, a ragged last tile): (label, R, C, layer-scale)
MLP_TIMED = ([(f"s{s}", BUCKET * (56 >> s) ** 2, 96 << s, False) for s in range(4)]
             + [(f"cnx-s{s}", BUCKET * (56 >> s) ** 2, 96 << s, True) for s in range(4)]
             + [("vit-b64", BUCKET * 197, 768, False), ("vit-b8", 8 * 197, 768, False)])
# held only: a ragged tile with a layer-scale, and a width off the tensor-core grid
# (F = 160: the float-FMA kernel in bf16 too)
MLP_HELD = [("ragged+gamma", 1000, 96, True), ("fma-width", 1000, 40, True)]
MLP_ITERS = 10  # cold-L2 launches timed a case (K5, K6)


def mlp_case(r, c, dtype, gen, gamma=False):
    f = 4 * c
    dt = DT[dtype]

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=DEV)

    x, sc = rn(r, c).to(dt), rn(r, c).to(dt)
    args = (x, 1 + rn(c, s=0.1), rn(c, s=0.1), rn(c, f, s=c ** -0.5).to(dt), rn(f, s=0.1),
            rn(f, c, s=f ** -0.5).to(dt), rn(c, s=0.1), sc)
    return args, (1 + rn(c, s=0.1) if gamma else None)


def mlp_vecs(args, gamma):
    """The f32 vectors of the C entries: ln_scale, ln_bias, b0, b1, gamma."""
    c = args[0].shape[-1]
    g = torch.ones(c, device=DEV) if gamma is None else gamma
    return [t.float().contiguous() for t in (args[1], args[2], args[4], args[6], g)]


def mlp_first_design(args, gamma):
    """K5's first design (the row-tile kernel, ln_mlp_tc_kernel) on bf16
    operands that the wrapper sends to the GEMM route, launched through its C
    entry: a yardstick timed beside the new design, held against plain first
    and launched by no path. Returns the launch."""
    x, w0, w1, sc = args[0], args[3], args[5], args[7]
    out = torch.empty_like(x)
    vecs = mlp_vecs(args, gamma)

    def launch():
        M._launch_fwd_rows(x, vecs, w0, w1, sc, out, True, 1e-5)

    launch()
    torch.cuda.synchronize()
    ref = M.reference_ln_mlp(*args, gamma=gamma, eps=1e-5)
    err, lim = max_err(out, ref), 4 * bf16_ulp(float(ref.float().abs().max()))
    if err > lim:
        fail(f"K5's first design disagrees with plain: {err:.3e} (tol {lim:.3e})")
    return launch


def mlp_matmuls(a, w0, w1):
    """The forward's two products alone through torch.matmul on operands of
    the same shapes (a = h = LN(x) rounded for K5, x for K7; the hidden
    rounded): a reference for the GEMM mainloop, two cuBLAS calls, not one
    call of the same function."""
    g = torch.empty(a.shape[0], w0.shape[1], dtype=a.dtype, device=DEV)

    def run():
        torch.matmul(a, w0, out=g)
        return torch.matmul(g, w1)

    return run


def layer_norm_rows(x):
    """h = LN(x) rounded to x's dtype: K5's and K6's first product's A."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(x.dtype)


def mlp_bound(r, c):
    """K5's least time: x, sc and out, the weights and vectors moved once;
    4 R C F operations (its two products)."""
    f = 4 * c
    return bound_ms(2 * (3 * r * c + 2 * c * f) + 4 * (4 * c + f), 4 * r * c * f, "bf16")


def time_shares(label, times, b, by, what):
    """Log each time's share of the bound; a share over 100% fails."""
    log(f"   {what} {label} bf16 times (cold L2): " + ", ".join(
        f"{k} {v:.4f} ms ({100 * b / v:.1f}%)" for k, v in times.items())
        + f"; bound {b:.4f} ms ({by})")
    if any(b > v for v in times.values()):
        fail(f"{what} {label} timed under its bound: the timing is wrong")


def check_mlp():
    """K5 against its plain version at MLP_TIMED and MLP_HELD, bf16 and f32
    (5e-4; bf16 4 ulps of the largest value), a second launch bit-identical,
    and its route by count: bf16 at the tensor-core widths on the GEMM route
    (fused_ln_mlp.gemm_launches), f32 and C = 40 on the first design. At
    MLP_TIMED (bf16) the new design, the first design (through its C entry),
    the plain version and the two products alone through torch.matmul are
    timed with a cold L2, each with its share of the bound."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    tol = {"f32": lambda ref: 5e-4, "bf16": lambda ref: 4 * bf16_ulp(ref)}
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for label, r, c, use_gamma in MLP_TIMED + MLP_HELD:
        for dtype in ("bf16", "f32"):
            args, gamma = mlp_case(r, c, dtype, gen, use_gamma)
            gemm = M.tensor_cores(DT[dtype], c, 4 * c)
            g0 = M.fused_ln_mlp.gemm_launches
            got = M.fused_ln_mlp(*args, gamma=gamma, eps=1e-5)
            again = M.fused_ln_mlp(*args, gamma=gamma, eps=1e-5)
            torch.cuda.synchronize()
            routed = M.fused_ln_mlp.gemm_launches - g0 == (2 if gemm else 0)
            ref = M.reference_ln_mlp(*args, gamma=gamma, eps=1e-5)
            err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
            same = torch.equal(got, again)
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim and same and routed
            log(f"K5 {label} R={r} C={c} F={4 * c} gamma={use_gamma} {dtype} "
                f"({'GEMM route' if gemm else 'first design'}): max|err| {err:.3e} (tol "
                f"{lim:.3e}), a second launch equal {same}, routed {routed} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"LN-MLP disagrees with its plain version at {label} {dtype}")
            if dtype != "bf16" or not gemm or (label, r, c, use_gamma) in MLP_HELD:
                continue
            times = {"kernel": cold_ms(lambda: M.fused_ln_mlp(*args, gamma=gamma, eps=1e-5),
                                       MLP_ITERS),
                     "first design": cold_ms(mlp_first_design(args, gamma), MLP_ITERS),
                     "plain": cold_ms(lambda: M.reference_ln_mlp(*args, gamma=gamma, eps=1e-5),
                                      MLP_ITERS),
                     "matmuls": cold_ms(mlp_matmuls(layer_norm_rows(args[0]), args[3], args[5]),
                                        MLP_ITERS)}
            b, by = mlp_bound(r, c)
            time_shares(label, times, b, by, "K5")
            rows[label] = dict(ms=times["kernel"], first_ms=times["first design"],
                               plain_ms=times["plain"], matmul_ms=times["matmuls"], bound_ms=b,
                               bound_by=by, bound_share=b / times["kernel"])
            del args, got, again, ref
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


def attn_bwd_bound(g, n, heads, m):
    """K2's least time: qkv and go read and dqkv written once, the bias and
    mask read and dbias written once; 10 N^2 D operations per (window,
    head), its five products."""
    nbytes = 2 * g * n * 7 * heads * 32 + 4 * (2 * heads + m) * n * n
    return bound_ms(nbytes, 10 * g * heads * n * n * 32, "bf16")


def hold_attention_bwd(what, qkv, bias, mask, go, scale, heads, dtype, worst):
    """K2 twice against its plain version on these operands: dqkv within
    1e-4 (f32) or 4 * 2^-8 (bf16: P, dS*scale and the outputs round to
    bf16, so a last-bit difference flips a rounding) of its largest value,
    dbias within 1e-4 of its largest; the second launch bit-identical; the
    design the wrapper's route names (the tensor cores for bf16 at D = 32, N
    <= 144) launched. Fails otherwise."""
    n, d = qkv.shape[1], qkv.shape[2] // 3 // heads
    tc = A.takes_tc(n, d, qkv.dtype)
    before = A.fused_attention_qkv_bwd.tc_launches
    dqkv, dbias = A.fused_attention_qkv_bwd(qkv, bias, mask, go, scale, heads)
    dqkv2, dbias2 = A.fused_attention_qkv_bwd(qkv, bias, mask, go, scale, heads)
    torch.cuda.synchronize()
    routed = A.fused_attention_qkv_bwd.tc_launches - before == (2 if tc else 0)
    rq, rb = A.reference_attention_bwd(qkv, bias, mask, go, scale, heads)
    err, err_b = max_err(dqkv, rq), max_err(dbias, rb)
    lim = (1e-4 if dtype == "f32" else 4 * 2.0 ** -8) * float(rq.float().abs().max())
    lim_b = 1e-4 * float(rb.abs().max())
    same = torch.equal(dqkv, dqkv2) and torch.equal(dbias, dbias2)
    worst[dtype] = max(worst[dtype], err)
    ok = err <= lim and err_b <= lim_b and same and routed
    log(f"K2 {what} {dtype} ({'tensor cores' if tc else 'first design'}): max|err| dqkv "
        f"{err:.3e} (tol {lim:.3e}), dbias {err_b:.3e} (tol {lim_b:.3e}), a second launch equal "
        f"{same}, routed {routed} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"window attention backward disagrees with its plain version at {what} {dtype}")


def check_attention_bwd():
    """K2 against its plain version (hold_attention_bwd) at SWIN_ATTN_CASES
    (bf16: the tensor-core design; f32: the first design), and at the ragged
    ATTN_RAGGED (bf16, f32). At the stages and window 12 (bf16) the kernel,
    the plain version and SDPA's backward are timed with a cold L2
    (cold_ms), after each set was held against plain; each row logs the SDPA
    backend and its share of the bytes bound, and a share over 100% fails."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    for stage, g, heads, m, grid, window in SWIN_ATTN_CASES:
        for dtype in ("bf16", "f32"):
            qkv, bias, mask, scale = attn_case(g, heads, m, grid, window, dtype, gen)
            n, c = window * window, heads * 32
            go = torch.randn(g, n, c, generator=gen, device=DEV).to(DT[dtype])
            hold_attention_bwd(f"stage {stage} G={g} H={heads} N={n} M={m}", qkv, bias, mask, go,
                               scale, heads, dtype, worst)
            if dtype != "bf16":
                continue
            ms = cold_ms(lambda: A.fused_attention_qkv_bwd(qkv, bias, mask, go, scale, heads),
                         ATTN_ITERS)
            plain = cold_ms(lambda: A.reference_attention_bwd(qkv, bias, mask, go, scale, heads),
                            ATTN_ITERS)
            lib, backend = None, "not measured"
            try:  # a yardstick only: the port never calls SDPA
                q, k, v, am = (t.detach().requires_grad_() for t in
                               attn_sdpa_inputs(qkv, bias, mask, heads))
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
                gout = go.view(g // m, m, n, heads, 32).permute(0, 1, 3, 2, 4).reshape(out.shape)

                def sdpa_bwd():
                    return torch.autograd.grad(out, (q, k, v, am), gout, retain_graph=True)

                lib = cold_ms(sdpa_bwd, ATTN_ITERS)
                backend = sdpa_backend(sdpa_bwd)
                del q, k, v, am, out, gout
            except RuntimeError as e:
                log(f"   sdpa backward: not measured ({e})")
            b, by = attn_bwd_bound(g, n, heads, m)
            log(f"   bf16 times (cold L2): kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa backward "
                f"{'not measured' if lib is None else f'{lib:.4f} ms'} ({backend}), bound "
                f"{b:.4f} ms ({by}), kernel at {100 * b / ms:.1f}% of the bound")
            if b > ms:
                fail(f"K2 stage {stage} timed under its bound: the timing is wrong")
            rows.append(dict(stage=stage, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by, bound_share=b / ms, backend=backend))
    for label, heads, n, bh in ATTN_RAGGED:
        g, m = ragged_windows(heads, n, A.bwd_tc_blocks_per_sm, A.bwd_tc_windows_per_block), 1
        for dtype in ("bf16", "f32"):
            qkv = torch.randn(g, n, 3 * heads * 32, generator=gen, device=DEV).to(DT[dtype])
            go = torch.randn(g, n, heads * 32, generator=gen, device=DEV).to(DT[dtype])
            bias = (0.5 * torch.randn(bh, n, n, generator=gen, device=DEV)).contiguous()
            mask = torch.where(torch.rand(m, n, n, generator=gen, device=DEV) < 0.2, -100.0, 0.0)
            hold_attention_bwd(f"{label} G={g} H={heads} M={m}", qkv, bias, mask, go, 32 ** -0.5,
                               heads, dtype, worst)
    return rows, worst


def mlp_bwd_first_design(args, gamma, dy):
    """K6's first design (the row-tile kernel and its reductions) through its
    C entry on bf16 operands that the wrapper sends to the GEMM route, as
    mlp_first_design; held against plain first (2e-2 of each gradient's
    largest value). Returns the launch."""
    x, w0, w1 = args[0], args[3], args[5]
    c, f = x.shape[-1], w0.shape[1]
    f32 = dict(dtype=torch.float32, device=DEV)
    dx, dw0, dw1 = torch.empty_like(x), torch.empty_like(w0), torch.empty_like(w1)
    dvec_c, db0 = torch.empty((4, c), **f32), torch.empty(f, **f32)
    vecs = mlp_vecs(args, gamma)

    def launch():
        M._launch_bwd(x, vecs, w0, w1, dy, dx, dw0, dw1, dvec_c, db0, c, f, True,
                      gamma is not None, 1e-5)

    launch()
    torch.cuda.synchronize()
    want = M.reference_ln_mlp_bwd(*args[:7], gamma, dy, 1e-5)
    got = (dx, dvec_c[0], dvec_c[1], dw0, db0, dw1, dvec_c[2], dvec_c[3])
    bad = max(max_err(g, w) / max(float(w.float().abs().max()), 1e-30)
              for g, w in zip(got, want) if w is not None)
    if bad > 2e-2:
        fail(f"K6's first design disagrees with plain: {bad:.3e} (tol 2e-2)")
    return launch


def mlp_bwd_matmuls(h, w0, w1, dy, gamma=None):
    """The backward's products alone through torch.matmul on bf16 operands
    of the right shapes (u and dgl, dh or dx, dw1 and dw0, and g w1 with a
    layer-scale; h = LN(x) rounded for K6, x for K8): a reference for the
    GEMM mainloop, five or six cuBLAS calls, not one call of the same
    function."""
    g = torch.matmul(h, w0)
    du = torch.matmul(dy, w1.t())

    def run():
        torch.matmul(h, w0, out=g)
        torch.matmul(dy, w1.t(), out=du)
        if gamma is not None:
            torch.matmul(g, w1)
        torch.matmul(du, w0.t())
        torch.matmul(g.t(), dy)
        return torch.matmul(h.t(), du)

    return run


def check_mlp_bwd():
    """K6 against its plain version at MLP_TIMED and MLP_HELD, bf16 and f32,
    each gradient within 2e-2 (bf16; h, g, du and dx round to bf16, and a
    last-bit difference in f32 flips a rounding) or 5e-4 (f32) of its
    largest value, a second launch bit-identical, and its route by count
    (fused_ln_mlp_bwd.gemm_launches). At MLP_TIMED (bf16) the new design,
    the first design, plain and the products alone through torch.matmul,
    timed with a cold L2 with their shares of the bound: 10 R C F
    operations, 12 with a layer-scale (y is recomputed for dgamma)."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    tol = {"f32": 5e-4, "bf16": 2e-2}
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    names = ("dx", "ds", "db", "dw0", "db0", "dw1", "db1", "dgamma")
    for label, r, c, use_gamma in MLP_TIMED + MLP_HELD:
        for dtype in ("bf16", "f32"):
            args, gamma = mlp_case(r, c, dtype, gen, use_gamma)
            args = args[:7]
            dy = torch.randn(r, c, generator=gen, device=DEV).to(DT[dtype])
            gemm = M.tensor_cores(DT[dtype], c, 4 * c)
            g0 = M.fused_ln_mlp_bwd.gemm_launches
            got = M.fused_ln_mlp_bwd(*args, gamma, dy, 1e-5)
            again = M.fused_ln_mlp_bwd(*args, gamma, dy, 1e-5)
            torch.cuda.synchronize()
            routed = M.fused_ln_mlp_bwd.gemm_launches - g0 == (2 if gemm else 0)
            want = M.reference_ln_mlp_bwd(*args, gamma, dy, 1e-5)
            rel = {}
            for name, gv, wv in zip(names, got, want):
                if (gv is None) != (wv is None):
                    fail(f"LN-MLP backward: {name} is None on one side only")
                if gv is not None:
                    rel[name] = max_err(gv, wv) / max(float(wv.float().abs().max()), 1e-30)
                    worst[dtype] = max(worst[dtype], max_err(gv, wv))
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
            bad = max(rel.values())
            ok = bad <= tol[dtype] and same and routed
            log(f"K6 {label} R={r} C={c} F={4 * c} gamma={use_gamma} {dtype} "
                f"({'GEMM route' if gemm else 'first design'}): max rel err {bad:.3e} "
                f"({max(rel, key=rel.get)}; tol {tol[dtype]:.1e}), a second launch equal "
                f"{same}, routed {routed} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"LN-MLP backward disagrees with its plain version at {label} {dtype}")
            if dtype != "bf16" or not gemm or (label, r, c, use_gamma) in MLP_HELD:
                continue
            del got, again, want
            times = {"kernel": cold_ms(lambda: M.fused_ln_mlp_bwd(*args, gamma, dy, 1e-5),
                                       MLP_ITERS),
                     "first design": cold_ms(mlp_bwd_first_design(args, gamma, dy), MLP_ITERS),
                     "plain": cold_ms(lambda: M.reference_ln_mlp_bwd(*args, gamma, dy, 1e-5),
                                      MLP_ITERS),
                     "matmuls": cold_ms(mlp_bwd_matmuls(layer_norm_rows(args[0]), args[3],
                                                        args[5], dy, gamma), MLP_ITERS)}
            f = 4 * c
            # x, dy in, dx out; w0, w1 in, dw0, dw1 out; the f32 vectors and theirs
            nbytes = 2 * (3 * r * c + 4 * c * f) + 4 * 2 * (4 * c + f)
            b, by = bound_ms(nbytes, (12 if use_gamma else 10) * r * c * f, "bf16")
            time_shares(label, times, b, by, "K6")
            rows[label] = dict(ms=times["kernel"], first_ms=times["first design"],
                               plain_ms=times["plain"], matmul_ms=times["matmuls"], bound_ms=b,
                               bound_by=by, bound_share=b / times["kernel"])
            del args, dy
    return rows, worst


# --- phases 2-3: the MLP alone (K7, K8) -------------------------------------------

# The timed shapes, bf16: ConvNeXt-T at bucket/batch 64, stages 0-3 (R = 64 *
# 56^2 ... 64 * 7^2, C = 96 ... 768, F = 4C), and ViT-B's MLP (C = 768) at
# buckets 64 and 8 (B*197 rows, a ragged last tile): (label, R, C)
MLP_ONLY_TIMED = ([(f"s{s}", BUCKET * (56 >> s) ** 2, 96 << s) for s in range(4)]
                  + [("vit-b64", BUCKET * 197, 768), ("vit-b8", 8 * 197, 768)])
# held only: bucket 1's stage 3 (49 rows, one ragged tile, F split into
# slabs) and a width off the tensor-core grid (the first design in bf16 too)
MLP_ONLY_HELD = [("b1-s3", 49, 768), ("fma-width", 1000, 40)]


def mlp_only_case(r, c, dtype, gen):
    """x, w0, b0, w1, b1 and dy of the MLP alone."""
    args, _ = mlp_case(r, c, dtype, gen)
    dy = torch.randn(r, c, generator=gen, device=DEV).to(DT[dtype])
    return (args[0], args[3], args[4], args[5], args[6]), dy


def mlp_only_first_design(args):
    """K7's first design (the row-tile kernel, ln_mlp_tc_kernel<false, ..>)
    on bf16 operands that the wrapper sends to the GEMM route, launched
    through its C entry, as mlp_first_design; held against plain first (4
    bf16 ulps of the largest value). Returns the launch."""
    x, w0, b0, w1, b1 = args
    out = torch.empty_like(x)
    b0c, b1c = b0.float().contiguous(), b1.float().contiguous()

    def launch():
        M._launch_mlp_rows(x, w0, b0c, w1, b1c, out, True)

    launch()
    torch.cuda.synchronize()
    ref = M.reference_mlp(*args)
    err, lim = max_err(out, ref), 4 * bf16_ulp(float(ref.float().abs().max()))
    if err > lim:
        fail(f"K7's first design disagrees with plain: {err:.3e} (tol {lim:.3e})")
    return launch


def max_rel_err(got, want):
    """Each gradient's largest difference over its largest value: {name: err}."""
    names = ("dx", "dw0", "db0", "dw1", "db1")
    return {n: max_err(g, w) / max(float(w.float().abs().max()), 1e-30)
            for n, g, w in zip(names, got, want, strict=True)}


def mlp_only_bwd_first_design(args, dy):
    """K8's first design (the row-tile kernel ln_mlp_bwd_row_kernel<.., LN =
    false>, wgrad_tc_kernel and the sums) through its C entry on bf16
    operands that the wrapper sends to the GEMM route; held against plain
    first (2e-2 of each gradient's largest value). Returns the launch."""
    x, w0, b0, w1, b1 = args
    c, f = x.shape[-1], w0.shape[1]
    dx, dw0, dw1 = torch.empty_like(x), torch.empty_like(w0), torch.empty_like(w1)
    db1, db0 = torch.empty(c, device=DEV), torch.empty(f, device=DEV)
    b0c, b1c = b0.float().contiguous(), b1.float().contiguous()

    def launch():
        M._launch_mlp_bwd(x, w0, b0c, w1, b1c, dy, dx, dw0, dw1, db1, db0, True)

    launch()
    torch.cuda.synchronize()
    bad = max(max_rel_err((dx, dw0, db0, dw1, db1), M.reference_mlp_bwd(*args, dy)).values())
    if bad > 2e-2:
        fail(f"K8's first design disagrees with plain: {bad:.3e} (tol 2e-2)")
    return launch


def mlp_only_bound(r, c, backward):
    """K7's least time: x and out, the weights and the f32 biases moved once,
    4 R C F operations (its two products); K8's: x, dy in and dx out, w0, w1
    in and dw0, dw1 out, the biases and theirs, 10 R C F operations (the u
    recompute, dgl, dx, dw1, dw0)."""
    f = 4 * c
    if backward:
        return bound_ms(2 * (3 * r * c + 4 * c * f) + 4 * 2 * (c + f), 10 * r * c * f, "bf16")
    return bound_ms(2 * (2 * r * c + 2 * c * f) + 4 * (c + f), 4 * r * c * f, "bf16")


def check_mlp_only():
    """K7 against its plain version at MLP_ONLY_TIMED and MLP_ONLY_HELD, bf16
    and f32 (5e-4, as K5; bf16 4 ulps of the largest value: the plain version
    rounds u to bf16 before the GELU and adds b1 to a rounded product), a
    second launch bit-identical, and its route by count: bf16 at the
    tensor-core widths on the GEMM route (fused_mlp.gemm_launches), f32 and
    C = 40 on the first design. At MLP_ONLY_TIMED (bf16) the new design, the
    first design (through its C entry), the plain version and the two
    products alone through torch.matmul, timed with a cold L2, each with its
    share of the bound."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    tol = {"f32": lambda ref: 5e-4, "bf16": lambda ref: 4 * bf16_ulp(ref)}
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for label, r, c in MLP_ONLY_TIMED + MLP_ONLY_HELD:
        for dtype in ("bf16", "f32"):
            args, _ = mlp_only_case(r, c, dtype, gen)
            gemm = M.tensor_cores(DT[dtype], c, 4 * c)
            g0 = M.fused_mlp.gemm_launches
            got = M.fused_mlp(*args)
            again = M.fused_mlp(*args)
            torch.cuda.synchronize()
            routed = M.fused_mlp.gemm_launches - g0 == (2 if gemm else 0)
            ref = M.reference_mlp(*args)
            err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
            same = torch.equal(got, again)
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim and same and routed
            log(f"K7 {label} R={r} C={c} F={4 * c} {dtype} "
                f"({'GEMM route' if gemm else 'first design'}): max|err| {err:.3e} (tol "
                f"{lim:.3e}), a second launch equal {same}, routed {routed} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the MLP kernel disagrees with its plain version at {label} {dtype}")
            if dtype != "bf16" or not gemm or (label, r, c) in MLP_ONLY_HELD:
                continue
            times = {"kernel": cold_ms(lambda: M.fused_mlp(*args), MLP_ITERS),
                     "first design": cold_ms(mlp_only_first_design(args), MLP_ITERS),
                     "plain": cold_ms(lambda: M.reference_mlp(*args), MLP_ITERS),
                     "matmuls": cold_ms(mlp_matmuls(args[0], args[1], args[3]), MLP_ITERS)}
            b, by = mlp_only_bound(r, c, False)
            time_shares(label, times, b, by, "K7")
            rows[label] = dict(ms=times["kernel"], first_ms=times["first design"],
                               plain_ms=times["plain"], matmul_ms=times["matmuls"], bound_ms=b,
                               bound_by=by, bound_share=b / times["kernel"])
            del args, got, again, ref
    return rows, worst


def check_mlp_only_bwd():
    """K8 against its plain version at K7's shapes, bf16 and f32, each
    gradient within 2e-2 (bf16; g, du and dx round to bf16, and a last-bit
    difference in f32 flips a rounding) or 5e-4 (f32) of its largest value,
    in plain's dtype and shape, a second launch bit-identical, and its route
    by count (fused_mlp_bwd.gemm_launches). At MLP_ONLY_TIMED (bf16) the new
    design, the first design, plain and the five products alone through
    torch.matmul, timed with a cold L2 with their shares of the bound."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    tol = {"f32": 5e-4, "bf16": 2e-2}
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for label, r, c in MLP_ONLY_TIMED + MLP_ONLY_HELD:
        for dtype in ("bf16", "f32"):
            args, dy = mlp_only_case(r, c, dtype, gen)
            gemm = M.tensor_cores(DT[dtype], c, 4 * c)
            g0 = M.fused_mlp_bwd.gemm_launches
            got = M.fused_mlp_bwd(*args, dy)
            again = M.fused_mlp_bwd(*args, dy)
            torch.cuda.synchronize()
            routed = M.fused_mlp_bwd.gemm_launches - g0 == (2 if gemm else 0)
            want = M.reference_mlp_bwd(*args, dy)
            for gv, wv in zip(got, want):
                if gv.dtype != wv.dtype or gv.shape != wv.shape:
                    fail(f"MLP backward: {gv.dtype} {tuple(gv.shape)} where plain gives "
                         f"{wv.dtype} {tuple(wv.shape)}")
                worst[dtype] = max(worst[dtype], max_err(gv, wv))
            rel = max_rel_err(got, want)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            bad = max(rel.values())
            ok = bad <= tol[dtype] and same and routed
            log(f"K8 {label} R={r} C={c} F={4 * c} {dtype} "
                f"({'GEMM route' if gemm else 'first design'}): max rel err {bad:.3e} "
                f"({max(rel, key=rel.get)}; tol {tol[dtype]:.1e}), a second launch equal "
                f"{same}, routed {routed} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the MLP backward disagrees with its plain version at {label} {dtype}")
            if dtype != "bf16" or not gemm or (label, r, c) in MLP_ONLY_HELD:
                continue
            del got, again, want
            times = {"kernel": cold_ms(lambda: M.fused_mlp_bwd(*args, dy), MLP_ITERS),
                     "first design": cold_ms(mlp_only_bwd_first_design(args, dy), MLP_ITERS),
                     "plain": cold_ms(lambda: M.reference_mlp_bwd(*args, dy), MLP_ITERS),
                     "matmuls": cold_ms(mlp_bwd_matmuls(args[0], args[1], args[3], dy),
                                        MLP_ITERS)}
            b, by = mlp_only_bound(r, c, True)
            time_shares(label, times, b, by, "K8")
            rows[label] = dict(ms=times["kernel"], first_ms=times["first design"],
                               plain_ms=times["plain"], matmul_ms=times["matmuls"], bound_ms=b,
                               bound_by=by, bound_share=b / times["kernel"])
            del args, dy
    return rows, worst


# --- phases 2-3: full-sequence attention (K3, K4) --------------------------------

VIT_HEADS, VIT_D = 12, 64  # ViT-B: 12 heads of width 64


def sep_case(g, n, heads, m, bh, dtype, gen):
    """q, k, v (G, N, H*64) and go in ``dtype``; a bias of ``bh`` heads (zeros
    when shared, as ViT's) and a mask of M groups (zeros when M = 1)."""
    c = heads * VIT_D
    q, k, v, go = (torch.randn(g, n, c, generator=gen, device=DEV).to(DT[dtype])
                   for _ in range(4))
    if bh == 1:
        bias = torch.zeros(1, n, n, device=DEV)
    else:
        bias = (0.5 * torch.randn(bh, n, n, generator=gen, device=DEV)).contiguous()
    if m > 1:
        mask = torch.where(torch.rand(m, n, n, generator=gen, device=DEV) < 0.2, -100.0, 0.0)
    else:
        mask = torch.zeros(1, n, n, device=DEV)
    return q, k, v, bias, mask, go


def sep_sdpa_inputs(q, k, v, bias, mask, heads):
    """q, k, v as (G/M, M*H, N, D) and bias + mask as (1, M*H, N, N), so one
    scaled_dot_product_attention call computes the same function."""
    g, n, c = q.shape
    m, d = mask.shape[0], c // heads
    qs, ks, vs = (t.view(g // m, m, n, heads, d).permute(0, 1, 3, 2, 4)
                  .reshape(g // m, m * heads, n, d).contiguous() for t in (q, k, v))
    am = (bias.expand(heads, n, n)[None] + mask[:, None]).reshape(1, m * heads, n, n)
    return qs, ks, vs, am.to(q.dtype).contiguous()


# (label, G, heads, M, bias heads): ViT-B at bucket 64 for patch 32 at 224 px,
# patch 16 at 224 px (the main shape) and patch 16 at 384 px; then a small
# case with a learned (H, N, N) bias and a mask of M = 2, which checks dbias
SEP_CASES = [("N=50", BUCKET, 50, VIT_HEADS, 1, 1), ("N=197", BUCKET, 197, VIT_HEADS, 1, 1),
             ("N=577", BUCKET, 577, VIT_HEADS, 1, 1), ("dbias", 8, 197, 4, 2, 4)]


# K3 alone at key counts around its 64-key tile: (label, G, N, heads, M, bias heads);
# M or bias heads None pass None for an absent mask or bias
SEP_RAGGED = [(f"N={n} {kind}", 2, n, 2, m, bh) for n in (1, 17, 63, 64, 65)
              for kind, m, bh in (("none", None, None), ("learned", 2, 2))]
SEP_ITERS = 20  # cold-L2 launches timed a case


def sep_bound(g, n, heads, bh, m):
    """K3's least time: q, k, v read and o written once, and the bias and
    mask when given; 4 N^2 D operations per (group, head)."""
    nbytes = 2 * g * n * 4 * heads * VIT_D + 4 * ((bh or 0) + (m or 0)) * n * n
    return bound_ms(nbytes, 4 * g * heads * n * n * VIT_D, "bf16")


def check_sep_attention():
    """K3 against its plain version at SEP_CASES (bf16 and f32) and at the
    ragged SEP_RAGGED (bf16, f32), with None for an absent bias or mask, a
    second launch bit-identical. At ViT-B's three sequences (bf16) each of
    the kernel, the plain version and SDPA is timed with a cold L2 (at N =
    50 the inputs fit the 50 MB L2) three times: with the (1, N, N) zeros,
    like for like with SDPA's float mask; with a learned (H, N, N) bias and
    a (1, N, N) mask, against SDPA given their sum; and with None, the ViT's
    path, against SDPA without a mask. Each is first held against plain at
    that shape (2 ulps, a second launch bit-identical); each row logs its
    share of the bytes bound, and a share over 100% fails."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    tol = {"f32": lambda ref: 1e-4, "bf16": lambda ref: 2 * bf16_ulp(ref)}
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for label, g, n, heads, m, bh in SEP_CASES + SEP_RAGGED:
        for dtype in ("bf16", "f32"):
            q, k, v, bias, mask, _ = sep_case(g, n, heads, m or 1, bh or 1, dtype, gen)
            bias, mask = (bias if bh else None), (mask if m else None)
            scale = VIT_D ** -0.5
            got = A.fused_attention(q, k, v, bias, mask, scale, heads)
            again = A.fused_attention(q, k, v, bias, mask, scale, heads)
            torch.cuda.synchronize()
            ref = A.reference_attention(q, k, v, bias, mask, scale, heads)
            err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
            worst[dtype] = max(worst[dtype], err)
            ok = err <= lim and torch.equal(got, again)
            log(f"K3 {label} G={g} H={heads} N={n} M={m} bias heads {bh} {dtype}: "
                f"max|err| {err:.3e} (tol {lim:.3e}), a second launch equal "
                f"{torch.equal(got, again)} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"attention disagrees with its plain version at {label} {dtype}")
            if dtype != "bf16" or label not in ("N=50", "N=197", "N=577"):
                continue
            t = {}
            # a learned (H, N, N) bias and a mask of -100s: the bias/mask path on its own planes
            lb = (0.5 * torch.randn(heads, n, n, generator=gen, device=DEV)).contiguous()
            lm = torch.where(torch.rand(1, n, n, generator=gen, device=DEV) < 0.2, -100.0, 0.0)
            for how, b_, m_ in (("zeros", bias, mask), ("learned", lb, lm), ("none", None, None)):
                # the operands timed below, each held against plain at this shape
                got = A.fused_attention(q, k, v, b_, m_, scale, heads)
                again = A.fused_attention(q, k, v, b_, m_, scale, heads)
                torch.cuda.synchronize()
                ref = A.reference_attention(q, k, v, b_, m_, scale, heads)
                err, lim = max_err(got, ref), tol[dtype](float(ref.float().abs().max()))
                worst[dtype] = max(worst[dtype], err)
                ok = err <= lim and torch.equal(got, again)
                log(f"K3 {label} with {how} {dtype}: max|err| {err:.3e} (tol {lim:.3e}), a second "
                    f"launch equal {torch.equal(got, again)} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"attention with {how} disagrees with its plain version at {label}")
                del got, again, ref
                b_ms, by = sep_bound(g, n, heads, None if b_ is None else b_.shape[0],
                                     None if m_ is None else m_.shape[0])
                ms = cold_ms(lambda: A.fused_attention(q, k, v, b_, m_, scale, heads), SEP_ITERS)
                plain = cold_ms(lambda: A.reference_attention(q, k, v, b_, m_, scale, heads),
                                SEP_ITERS)
                qs, ks, vs, am = sep_sdpa_inputs(q, k, v, b_ if b_ is not None else bias,
                                                 m_ if m_ is not None else mask, heads)
                am = am if b_ is not None else None
                lib = cold_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                                                      scale=scale), SEP_ITERS)
                sdpa = "with its float mask" if am is not None else "unmasked"
                log(f"   bf16 times (cold L2) with {how}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, sdpa {sdpa} {lib:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                    f"kernel at {100 * b_ms / ms:.1f}% of the bound, sdpa at "
                    f"{100 * b_ms / lib:.1f}%")
                t[how] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                              bound_share=b_ms / ms)
                del qs, ks, vs, am
                if b_ms > ms:
                    fail(f"K3 {label} with {how} timed under its bound: the timing is wrong")
            # the ViT's path passes None: the row's numbers; the others' beside them
            rows[label] = dict(t["none"], **{f"{k_}_{how}": v_ for how in ("zeros", "learned")
                                             for k_, v_ in t[how].items()})
    return rows, worst


# K4 alone at query and key counts around its 64-row tiles: (label, G, N, heads, M,
# bias heads); None passes None, the learned operands ask for dbias
SEP_BWD_RAGGED = [(f"N={n} {kind}", 2, n, 2, m, bh) for n in (1, 17, 63, 64, 65)
                  for kind, m, bh in (("none", None, None), ("learned", 2, 2))]


def sep_bwd_bound(g, n, heads, bh, m):
    """K4's least time: q, k, v and go read and dq, dk, dv written once, and
    the bias and mask when given; 10 N^2 D operations per (group, head), its
    five products."""
    nbytes = 2 * g * n * 7 * heads * VIT_D + 4 * ((bh or 0) + (m or 0)) * n * n
    return bound_ms(nbytes, 10 * g * heads * n * n * VIT_D, "bf16")


def hold_sep_bwd(what, q, k, v, bias, mask, go, heads, dtype, need_dbias, worst):
    """K4 twice against its plain version on these operands: dq, dk, dv within
    1e-4 (f32) or 4 bf16 ulps (bf16, P, dS*scale and the outputs round) of
    the largest value, dbias within 1e-4 of its largest, the second launch
    bit-identical; fails otherwise."""
    scale = VIT_D ** -0.5
    got = A.fused_attention_bwd(q, k, v, bias, mask, go, scale, heads, need_dbias=need_dbias)
    again = A.fused_attention_bwd(q, k, v, bias, mask, go, scale, heads, need_dbias=need_dbias)
    torch.cuda.synchronize()
    want = A.reference_attention_sep_bwd(q, k, v, bias, mask, go, scale, heads)
    big = max(float(w.float().abs().max()) for w in want[:3])
    lim = 1e-4 * big if dtype == "f32" else 4 * bf16_ulp(big)
    err = max(max_err(a, b) for a, b in zip(got[:3], want[:3]))
    same = all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    ok, msg = err <= lim and same, ""
    if need_dbias:
        err_b, lim_b = max_err(got[3], want[3]), 1e-4 * float(want[3].abs().max())
        same = same and torch.equal(got[3], again[3])
        ok = ok and err_b <= lim_b and same
        msg = f", dbias {err_b:.3e} (tol {lim_b:.3e})"
    worst[dtype] = max(worst[dtype], err)
    log(f"K4 {what} {dtype}: max|err| dq/dk/dv {err:.3e} (tol {lim:.3e}){msg}, a second "
        f"launch equal {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"attention backward disagrees with its plain version at {what} {dtype}")


def sdpa_bwd_fn(q, k, v, bias, mask, go, heads, scale, masked):
    """A closure of SDPA's backward alone on the same function (a float mask
    of bias + mask when ``masked``, else none), and its backend."""
    qs, ks, vs, am = sep_sdpa_inputs(q, k, v, bias, mask, heads)
    qs, ks, vs = (t.requires_grad_() for t in (qs, ks, vs))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am if masked else None,
                                         scale=scale)
    gout = sep_sdpa_inputs(go, go, go, bias, mask, heads)[0]

    def sdpa_bwd():
        return torch.autograd.grad(out, (qs, ks, vs), gout, retain_graph=True)

    return sdpa_bwd, sdpa_backend(sdpa_bwd)


def check_sep_attention_bwd():
    """K4 against its plain version (hold_sep_bwd) at SEP_CASES (bf16 and f32;
    dbias in the small case) and at the ragged SEP_BWD_RAGGED (bf16, f32;
    None, or a learned bias and mask with dbias). At ViT-B's three sequences
    (bf16) each of the kernel, the plain version and SDPA's backward is timed
    with a cold L2 three times: with None, the ViT's path, against SDPA's
    unmasked backward; with the (1, N, N) zeros, like for like with SDPA's
    float mask; with a learned (H, N, N) bias and a (1, N, N) mask, without
    dbias, against SDPA given their sum. Each set is first held against plain
    at that shape; each row logs the SDPA backend and its share of the bound,
    and a share over 100% fails."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for label, g, n, heads, m, bh in SEP_CASES + SEP_BWD_RAGGED:
        learned = bool(bh) and bh > 1  # a learned bias needs dbias; the constant zeros do not
        for dtype in ("bf16", "f32"):
            q, k, v, bias, mask, go = sep_case(g, n, heads, m or 1, bh or 1, dtype, gen)
            bias, mask = (bias if bh else None), (mask if m else None)
            hold_sep_bwd(f"{label} G={g} H={heads} N={n} M={m} bias heads {bh}", q, k, v, bias,
                         mask, go, heads, dtype, learned, worst)
            if dtype != "bf16" or label not in ("N=50", "N=197", "N=577"):
                continue
            t = {}
            scale = VIT_D ** -0.5
            lb = (0.5 * torch.randn(heads, n, n, generator=gen, device=DEV)).contiguous()
            lm = torch.where(torch.rand(1, n, n, generator=gen, device=DEV) < 0.2, -100.0, 0.0)
            for how, b_, m_ in (("none", None, None), ("zeros", bias, mask), ("learned", lb, lm)):
                hold_sep_bwd(f"{label} with {how}", q, k, v, b_, m_, go, heads, dtype, False,
                             worst)
                b_ms, by = sep_bwd_bound(g, n, heads, None if b_ is None else b_.shape[0],
                                         None if m_ is None else m_.shape[0])
                ms = cold_ms(lambda: A.fused_attention_bwd(q, k, v, b_, m_, go, scale, heads,
                                                           need_dbias=False), SEP_ITERS)
                plain = cold_ms(lambda: A.reference_attention_sep_bwd(q, k, v, b_, m_, go, scale,
                                                                      heads), SEP_ITERS)
                lib, backend = None, "not measured"
                try:  # a yardstick only: the port never calls SDPA
                    fn, backend = sdpa_bwd_fn(q, k, v, bias if b_ is None else b_,
                                              mask if m_ is None else m_, go, heads, scale,
                                              masked=b_ is not None)
                    lib = cold_ms(fn, SEP_ITERS)
                    del fn
                except RuntimeError as e:
                    log(f"   sdpa backward: not measured ({e})")
                sdpa = "with its float mask" if b_ is not None else "unmasked"
                log(f"   bf16 times (cold L2) with {how}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, sdpa backward {sdpa} "
                    f"{'not measured' if lib is None else f'{lib:.4f} ms'} ({backend}), bound "
                    f"{b_ms:.4f} ms ({by}), kernel at {100 * b_ms / ms:.1f}% of the bound")
                t[how] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                              bound_share=b_ms / ms, backend=backend)
                if b_ms > ms:
                    fail(f"K4 {label} with {how} timed under its bound: the timing is wrong")
            # the ViT's path passes None: the row's numbers; the others' beside them
            rows[label] = dict(t["none"], **{f"{k_}_{how}": v_ for how in ("zeros", "learned")
                                             for k_, v_ in t[how].items()})
    return rows, worst


# --- phases 2-3: the fused bottleneck chain (K9, K10) ------------------------------

# ResNet-50 at batch 64, 224 px, ghost_bn = 2: its identity blocks per stage
# (2, 3, 5, 2), each stage's (H = W, C, M); stat_band gives bf16 bands 8/7/2/None
# and f32 bands 4/4/None/None
RESNET_STAGES = [(2, 56, 256, 64), (3, 28, 512, 128), (5, 14, 1024, 256), (2, 7, 2048, 512)]
GHOST = 2
CHAIN_GRADS = ("dx", "dw1", "dw2", "dw3", "ds1", "db1", "ds2", "db2", "ds3", "db3")


def chain_cases():
    """(label, B, H, C, M, dtype, th): the stages whose band stat_band gives in
    each dtype (bf16: stages 1-3; f32: 1-2), and a small single-band case."""
    cases = []
    for dtype, itemsize in (("bf16", 2), ("f32", 4)):
        for s, (_, h, c, m) in enumerate(RESNET_STAGES, 1):
            th = BN.stat_band(BUCKET, h, h, c, m, GHOST, itemsize)
            if th is not None:
                cases.append((f"stage {s}", BUCKET, h, c, m, dtype, th))
        cases.append(("single-band", 8, 14, 128, 32, dtype, 14))
    return cases


def chain_case(b, h, c, m, dtype, gen):
    dt = DT[dtype]

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=DEV)

    def uni(n):
        return 0.8 + 0.4 * torch.rand(n, generator=gen, device=DEV)

    x = rn(b, h, h, c).to(dt)
    args = (x, rn(c, m, s=c ** -0.5).to(dt), rn(3, 3, m, m, s=(9 * m) ** -0.5).to(dt),
            rn(m, c, s=m ** -0.5).to(dt), uni(m), rn(m, s=0.1), uni(m), rn(m, s=0.1), uni(c),
            rn(c, s=0.1))
    return args, rn(b, h, h, c).to(dt)


def chain_work(b, h, c, m, th, itemsize):
    """Bytes and operations of one K9 and one K10 call: each input read once,
    each output written once; conv1 once per image row, the 3x3 conv over the
    core rows, conv3; the backward adds the recompute's three products, dw3
    and da2, dw2 over the core rows, da1 and dw1 over the ext rows (each
    tile's th + 2 rows) and dx's core rows."""
    rows = b * h * h
    ext = rows // th * (th + 2)
    nt = b // GHOST * h // th
    wbytes = itemsize * (2 * c * m + 9 * m * m)
    vec = 4 * (4 * m + 2 * c)
    c1, c2, c3 = 2 * rows * c * m, 2 * rows * 9 * m * m, 2 * rows * m * c
    fwd_bytes = 2 * itemsize * rows * c + wbytes + vec + 4 * nt * (4 * m + 2 * c)
    bwd_bytes = 3 * itemsize * rows * c + wbytes + 4 * (2 * c * m + 9 * m * m) + 3 * vec
    bwd_ops = (c1 + c2 + c3) + 2 * c3 + c2 + 2 * ext * 9 * m * m + 2 * ext * c * m + c1
    return fwd_bytes, c1 + c2 + c3, bwd_bytes, bwd_ops


CHAIN_TOL = {"bf16": (2e-2, 2e-2), "f32": (5e-4, 3e-3)}  # statistics, gradients
# bf16 shapes off ResNet-50's (B, H = W, C, M, th): bands of 5 and 2 rows of a
# 10-row image (tiles that 128-row block tiles straddle) and a single band at
# C = 96, M = 64 (column tiles past C and M)
CHAIN_RAGGED = [("ragged th=5", 4, 10, 64, 32, 5), ("ragged th=2", 4, 10, 64, 32, 2),
                ("single-band C=96", 2, 10, 96, 64, 10)]
CHAIN_ITERS = 10  # cold-L2 launches timed a case (K9, K10; plain 3)


def chain_launch(args, dout, th, tc=None):
    """One K9 and one K10 launch, ``(out, stats, grads)``: through the wrappers
    (the route their predicate picks, counted) when ``tc`` is None, else
    through the launch helpers on the tensor-core route (True) or the first
    design (False), not counted."""
    kw = dict(g=GHOST, th=th)
    if tc is None:
        out, stats = BN.fused_chain_fwd(*args, **kw)
        grads = BN.fused_chain_bwd(*args, dout, **kw)
    else:
        out, stats = BN._forward(*args, **kw, eps=1e-5, tc=tc)
        grads = BN._backward(*args, dout, **kw, eps=1e-5, tc=tc)
    torch.cuda.synchronize()
    return out, stats, grads


def compare_chain(label, args, dout, th, tc=None):
    """K9 and K10 (chain_launch's route ``tc``) against the plain chain on the
    same inputs and band, at check_chain's tolerances. Logs the output's
    error, its flipped gates, and each statistic's and gradient's error;
    returns (ok, output max|err|, the gradients' largest max|err|, each
    gradient's relative L2, K9's and K10's outputs)."""
    dtype = DTYPE_NAME[args[0].dtype]
    b, h, _, c = args[0].shape
    m = args[1].shape[1]
    kw = dict(g=GHOST, th=th)
    out, stats, grads = chain_launch(args, dout, th, tc)
    pout, pstats = BN.reference_chain(*args, **kw)
    pgrads = BN.reference_chain_bwd(*args, dout, **kw)
    err = max_err(out, pout)
    lim = 4 * bf16_ulp(float(pout.float().abs().max())) if dtype == "bf16" else 5e-4
    flips = int(((out.float() > 0) != (pout.float() > 0)).sum())
    tol_stat, tol_grad = CHAIN_TOL[dtype]
    stat_err, grad_l2 = {}, {}
    for i, (name, got, want) in enumerate(zip(("m1", "v1", "m2", "v2", "m3", "v3")
                                              + CHAIN_GRADS, stats + tuple(grads),
                                              pstats + tuple(pgrads))):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"chain {label} {dtype}: {name} is {got.dtype} {tuple(got.shape)}, plain "
                 f"{want.dtype} {tuple(want.shape)}")
        d, w = got.float() - want.float(), want.float()
        if i < 6:
            stat_err[name] = float(d.abs().max()) / max(float(w.abs().max()), 1e-30)
        else:
            grad_l2[name] = float(d.norm()) / max(float(w.norm()), 1e-30)
    grad_err = max(max_err(a, b_) for a, b_ in zip(grads, pgrads))
    ok = err <= lim and max(stat_err.values()) <= tol_stat and max(grad_l2.values()) <= tol_grad
    route = {None: "", True: " tensor-core route", False: " first design"}[tc]
    log(f"K9/K10{route} {label} B={b} H=W={h} C={c} M={m} th={th} {dtype}: out max|err| {err:.3e} "
        f"(tol {lim:.3e}), {flips} output gates flipped; statistics max|err| / max|plain| "
        f"at most {max(stat_err.values()):.3e} ({max(stat_err, key=stat_err.get)}; tol "
        f"{tol_stat:.0e}); gradients |kernel - plain| / |plain| (L2) "
        f"{' '.join(f'{n} {v:.2e}' for n, v in grad_l2.items())} (tol {tol_grad:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, err, grad_err, grad_l2, (out, stats, grads)


def chain_tc_counts():
    return BN.fused_chain.tc_launches, BN.fused_chain_bwd.tc_launches


def check_chain():
    """K9 and K10 against the plain chain on the same inputs and bands. The
    output within 4 bf16 ulps of its largest value (a1, a2, y3 and the residual
    sum round to bf16, so a last-bit difference in f32 flips a rounding) and
    5e-4 in f32; each of the six statistics within 2e-2 (bf16) / 5e-4 (f32)
    of its largest value. Each of the ten gradients by its relative L2 error,
    |kernel - plain| / |plain|: bf16 2e-2, f32 3e-3. Not elementwise: a relu
    gate (z1, z2 or the output's) whose input lies within rounding noise of 0
    falls on different sides in the two programs (the output's flips are
    counted: at stage 1, a few in f32 and hundreds in bf16 among 51M), and
    each flip moves the gradient elements behind it by their whole size.
    Every case also: its route by the tensor-core counts (bf16 at C and M
    multiples of 32 on the route, the rest on the first design), and a
    second launch bit-identical. At the bf16 stages the first design, held
    against plain on the same operands first, and both designs and plain
    timed with a cold L2, with each one's share of the bound."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    rows = {}
    worst = {"fwd": {"bf16": 0.0, "f32": 0.0}, "bwd": {"bf16": 0.0, "f32": 0.0},
             "bwd_l2": {"bf16": 0.0, "f32": 0.0}}
    cases = chain_cases() + [(*r[:5], "bf16", r[5]) for r in CHAIN_RAGGED]
    for label, b, h, c, m, dtype, th in cases:
        args, dout = chain_case(b, h, c, m, dtype, gen)
        tc = BN.takes_tc(DT[dtype], c, m)
        n0 = chain_tc_counts()
        ok, err, grad_err, grad_l2, first = compare_chain(label, args, dout, th)
        routed = chain_tc_counts() == (n0[0] + tc, n0[1] + tc)
        again = chain_launch(args, dout, th)
        same = all(torch.equal(x, y) for x, y in zip((first[0], *first[1], *first[2]),
                                                      (again[0], *again[1], *again[2])))
        log(f"   {label} {dtype}: {'tensor-core route' if tc else 'first design'} by count "
            f"{'ok' if routed else 'FAIL'}; a second launch bit-identical: {same}")
        if not ok or not routed or not same:
            fail(f"the bottleneck chain kernels disagree with the plain chain, take the wrong "
                 f"route or differ across launches at {label} {dtype}")
        worst["fwd"][dtype] = max(worst["fwd"][dtype], err)
        worst["bwd"][dtype] = max(worst["bwd"][dtype], grad_err)
        worst["bwd_l2"][dtype] = max(worst["bwd_l2"][dtype], *grad_l2.values())
        del first, again
        if dtype != "bf16" or not label.startswith("stage"):
            del args, dout
            continue
        # the first design on the same operands, held before it is timed
        ok1, err1, _, l2_1, _ = compare_chain(label, args, dout, th, tc=False)
        if not ok1:
            fail(f"the chain's first design disagrees with the plain chain at {label} bf16")
        worst["fwd"]["bf16_first"] = max(worst["fwd"].get("bf16_first", 0.0), err1)
        worst["bwd_l2"]["bf16_first"] = max(worst["bwd_l2"].get("bf16_first", 0.0),
                                            *l2_1.values())
        kw = dict(g=GHOST, th=th)
        fb, fo, bb, bo = chain_work(b, h, c, m, th, 2)
        t = dict(ms=cold_ms(lambda: BN._forward(*args, **kw, eps=1e-5, tc=True), CHAIN_ITERS),
                 first_ms=cold_ms(lambda: BN._forward(*args, **kw, eps=1e-5, tc=False),
                                  CHAIN_ITERS),
                 plain_ms=cold_ms(lambda: BN.reference_chain(*args, **kw), 3),
                 bwd_ms=cold_ms(lambda: BN._backward(*args, dout, **kw, eps=1e-5, tc=True),
                                CHAIN_ITERS),
                 bwd_first_ms=cold_ms(lambda: BN._backward(*args, dout, **kw, eps=1e-5,
                                                           tc=False), CHAIN_ITERS),
                 bwd_plain_ms=cold_ms(lambda: BN.reference_chain_bwd(*args, dout, **kw), 3))
        t["bound_ms"], t["bound_by"] = bound_ms(fb, fo, "bf16")
        t["bwd_bound_ms"], t["bwd_bound_by"] = bound_ms(bb, bo, "bf16")
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["bwd_bound_share"] = t["bwd_bound_ms"] / t["bwd_ms"]
        log(f"   bf16 times a launch, cold L2: K9 {t['ms']:.4f} ms ({100 * t['bound_share']:.1f}% "
            f"of the bound), first design {t['first_ms']:.4f}, plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); K10 {t['bwd_ms']:.4f} ms "
            f"({100 * t['bwd_bound_share']:.1f}%), first design {t['bwd_first_ms']:.4f}, plain "
            f"{t['bwd_plain_ms']:.4f} ms, bound {t['bwd_bound_ms']:.4f} ms ({t['bwd_bound_by']})")
        if t["ms"] >= t["first_ms"] or t["bwd_ms"] >= t["bwd_first_ms"]:
            fail(f"the chain's tensor-core route is not faster than its first design at {label}")
        rows[label] = t
        del args, dout
    log(f"K9/K10 worst: out max|err| bf16 {worst['fwd']['bf16']:.3e}, f32 "
        f"{worst['fwd']['f32']:.3e}; gradients relative L2 bf16 {worst['bwd_l2']['bf16']:.3e}, "
        f"f32 {worst['bwd_l2']['f32']:.3e}")
    return rows, worst


# --- phase 2: the ResNet-family probes (X1, X2) -----------------------------------

MB_F32_CASE = (2048, 128, 256)  # the probe's test shape (tests/test_experiments_pallas.py)


def mb_library(x, w, scale, bias):
    """The library's version of X1's function: torch.matmul (cuBLAS, the
    product rounded to x's dtype) and the eager epilogue and sums. A
    yardstick, timed here only."""
    y = torch.relu(torch.matmul(x, w).float() * scale + bias)
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


def ulp_err(got, want):
    """The largest |got - want| in units of one bf16 ulp of each value of
    want plus 2^-16 of the largest |want|: near 0 a bf16 ulp is finer than
    the rounding noise of the f32 sums that both sides round from (a value
    that one side's sums put a hair below a relu's 0 and the other's a hair
    above), so each value's own ulp alone would fail on noise."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - w).abs() / (ulp + 2.0 ** -16 * w.abs().max())).max())


# the route's held cases beyond the probe's shapes: ResNet's 1x1 widths with
# Cin != Cout at its stage-1 rows (batch 64), and a ragged N (not a multiple of
# the route's 128-row tile)
MB_HELD = [(50_176, 256, 64), (50_176, 64, 256), (100_003, 128, 128)]
MB_ITERS = 10  # cold-L2 launches timed a shape (X1's route, its first design, the library)


def hold_matmul_bn(label, fn, args, dtype, worst):
    """One X1 design against its plain version: y within one bf16 ulp of each
    value (ulp_err) or 2e-5 of its largest value in f32, the sums within 1e-4
    of their largest, a second launch bit-identical; fails otherwise."""
    n, cin, cout = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    y, s, q = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    py, ps, pq = MB.reference_matmul_bn_relu_stats(*args)
    err = max_err(y, py)
    worst[dtype] = max(worst[dtype], err)
    if dtype == "bf16":
        y_ok, y_msg = ulp_err(y, py) <= 1, f"{ulp_err(y, py):.2f} ulps (tol 1)"
    else:
        lim = 2e-5 * float(py.abs().max())
        y_ok, y_msg = err <= lim, f"{err:.3e} (tol {lim:.3e})"
    sums = max(max_err(a, b) / float(b.abs().max()) for a, b in ((s, ps), (q, pq)))
    same = all(torch.equal(a, b) for a, b in zip((y, s, q), again))
    ok = y_ok and sums <= 1e-4 and same
    log(f"X1 {label} N={n} Cin={cin} Cout={cout} {dtype}: y max|err| {y_msg}, sums max|err| / "
        f"max|plain| {sums:.3e} (tol 1e-4), a second launch bit-identical: {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"matmul_bn ({label}) disagrees with its plain version at N={n} {cin}->{cout} "
             f"{dtype}")
    return py


def check_matmul_bn():
    """X1 against its plain version (f32 product, TF32 off): bf16 on the route
    on wgmma + TMA at the probe's three shapes, ResNet's 256->64 and 64->256
    at 50,176 rows and a ragged N (MB_HELD), the route taken by its count;
    the first design (through its C entry) at the probe's shapes; f32 at the
    probe's test shape (the first design). Held by hold_matmul_bn. Times at
    the probe's shapes with a cold L2, in turns (route, first design,
    library, plain, library, first design, route): the route, the first
    design, the plain version and torch.matmul with the eager epilogue
    (mb_library), each share of the bytes bound (over 100% fails: the timing
    would be wrong)."""
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    cases = [(n, c, c, "bf16") for n, c in MB.SHAPES] + [(*c, "bf16") for c in MB_HELD]
    cases += [(*MB_F32_CASE, "f32")]
    fn = MB.fused_matmul_bn_relu_stats
    for i, (n, cin, cout, dtype) in enumerate(cases):
        args = MB.inputs(n, cin, cout, DT[dtype], DEV, seed=10 + i)
        route = MB.takes_wgmma(n, cin, cout, DT[dtype])
        before = fn.wgmma_launches
        py = hold_matmul_bn("route" if route else "first design",
                            lambda *a: fn(*a, tile_rows=1), args, dtype, worst)
        if fn.wgmma_launches - before != (2 if route else 0) or route != (dtype == "bf16"):
            fail(f"X1 at N={n} {cin}->{cout} {dtype}: the route was not taken as expected")
        if (n, cin) not in MB.SHAPES or dtype != "bf16":
            continue
        hold_matmul_bn("first design", MB.first_design, args, dtype, worst)
        lib_y = mb_library(*args)[0]
        b, by = bound_ms(*MB.work(n, cin, cout, 2), "bf16")
        timed = {"ms": lambda: fn(*args), "first_ms": lambda: MB.first_design(*args),
                 "library_ms": lambda: mb_library(*args),
                 "plain_ms": lambda: MB.reference_matmul_bn_relu_stats(*args)}
        got = defaultdict(list)
        for key in ("ms", "first_ms", "library_ms", "plain_ms", "library_ms", "first_ms", "ms"):
            got[key].append(cold_ms(timed[key], 3 if key == "plain_ms" else MB_ITERS))
        t = {k: sum(v) / len(v) for k, v in got.items()}
        t.update(shape=f"N={n} C={cin}", bound_ms=b, bound_by=by, bound_share=b / t["ms"],
                 turns={k: v for k, v in got.items() if len(v) > 1})
        log(f"   bf16 times (cold L2, in turns): route {t['ms']:.4f} ms "
            f"({' / '.join(f'{v:.4f}' for v in got['ms'])}), first design {t['first_ms']:.4f} "
            f"({' / '.join(f'{v:.4f}' for v in got['first_ms'])}), plain {t['plain_ms']:.4f}, "
            f"matmul + eager epilogue {t['library_ms']:.4f} (its y {ulp_err(lib_y, py):.2f} ulps "
            f"from plain), bound {b:.4f} ms ({by}), route at {100 * t['bound_share']:.1f}% of "
            f"the bound, first design at {100 * b / t['first_ms']:.1f}%")
        if t["bound_share"] > 1.0 or b / t["first_ms"] > 1.0:
            fail(f"X1 N={n} C={cin}: a design times under its bytes bound; the timing is wrong")
        if t["ms"] >= t["first_ms"]:
            fail(f"X1 N={n} C={cin}: the route is not faster than the first design")
        rows.append(t)
        del args, py, lib_y
    return rows, worst


GC_ITERS = 20  # cold-L2 launches timed a stage


def check_grouped_conv():
    """X2 against its plain version (the probe's rotations x taps of f32
    FMAs) at resnext50_32x4d's four stages in bf16, stages 1-2 in f32 (TF32
    off), and the probe's check shapes (gw = 4 and 8, C = 8 gw, x (2, 8, 8,
    C)) in both: bf16 within one ulp of each value (ulp_err), f32 1e-5 of
    the largest value, a second launch bit-identical. Logged beside it:
    max|d| against cuDNN's grouped convolution (F.conv2d(groups=C/gw)).
    Times (bf16, the stages) with a cold L2 (stages 2-4 fit the 50 MB L2) of
    the kernel, the plain version and cuDNN, and the kernel's share of its
    bytes bound (a share over 1 fails: the timing would be wrong)."""
    rows, worst = [], {"bf16": 0.0, "f32": 0.0}
    cases = [(name, b, h, c, gw, dtype) for dtype in ("bf16", "f32")
             for name, b, h, c, gw in GC.STAGES if dtype == "bf16" or gw <= 8]
    cases += [("check", 2, 8, 8 * gw, gw, dtype) for gw in (4, 8) for dtype in ("bf16", "f32")]
    for i, (name, b, h, c, gw, dtype) in enumerate(cases):
        x, w = GC.inputs(b, h, c, gw, DT[dtype], DEV, seed=20 + i)
        wvec = GC.build_wvec(w, gw)
        got, again = GC.gconv(x, wvec, gw), GC.gconv(x, wvec, gw)
        torch.cuda.synchronize()
        want = GC.reference_gconv(x, wvec, gw)
        err = max_err(got, want)
        worst[dtype] = max(worst[dtype], err)
        if dtype == "bf16":
            ok, msg = ulp_err(got, want) <= 1, f"{ulp_err(got, want):.2f} ulps (tol 1)"
        else:
            lim = 1e-5 * float(want.abs().max())
            ok, msg = err <= lim, f"{err:.3e} (tol {lim:.3e})"
        ok = ok and torch.equal(got, again)
        lib_d = max_err(got, GC.conv2d_grouped(x, w, gw))
        log(f"X2 {name} B={b} H=W={h} C={c} gw={gw} {dtype}: max|err| {msg}; a second launch "
            f"equal {torch.equal(got, again)}; max|d| against cuDNN {lib_d:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"gconv disagrees with its plain version at {name} {dtype}")
        if dtype != "bf16" or name == "check":
            continue
        b_ms, by = bound_ms(*GC.work(b, h, c, gw, 2), "bf16")
        t = dict(stage=name, ms=cold_ms(lambda: GC.gconv(x, wvec, gw), GC_ITERS),
                 plain_ms=cold_ms(lambda: GC.reference_gconv(x, wvec, gw), 3),
                 library_ms=cold_ms(lambda: GC.conv2d_grouped(x, w, gw), GC_ITERS), bound_ms=b_ms,
                 bound_by=by)
        t["bound_share"] = b_ms / t["ms"]
        log(f"   bf16 times (cold L2): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"cuDNN {t['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
            f"{100 * t['bound_share']:.1f}% of the bound, cuDNN at "
            f"{100 * b_ms / t['library_ms']:.1f}%")
        if t["bound_share"] > 1.0:
            fail(f"X2 {name}: the kernel times under its bytes bound; the timing is wrong")
        rows.append(t)
        del x, w, wvec, got, again, want
    return rows, worst


# --- phase 2: the Swin layout probes (X3-X7) --------------------------------------

# each row of the kernels line: its name, the TPU kernel it replaces, and the
# wrappers whose launches it counts (X7: the merge, split and pad8 of probe2)
LAYOUT_ROWS = {
    "X3": ("layout_stream", "experiments/r3_layout_tax.py:52", ("layout_stream",)),
    "X4": ("layout_transpose", "experiments/r3_layout_tax.py:56", ("layout_transpose",)),
    "X5": ("window_gather", "experiments/r3_map_attention_probe.py:44", ("window_gather",)),
    "X6": ("window_scatter", "experiments/r3_map_attention_probe.py:52", ("window_scatter",)),
    "X7": ("window_merge_split_pad8", "experiments/r3_map_attention_probe2.py:64",
           ("window_merge", "window_split", "window_pad8")),
}
LAYOUT_ITERS = 20  # cold-L2 launches timed a case


def check_layout():
    """X3-X7 against their plain versions (the kernels' index arithmetic as
    one PyTorch gather) at every probe shape in bf16 and, for each function,
    at its last shape in f32: equal bit for bit (they move bits), and a
    second launch equal to the first. Times (bf16) with a cold L2, flushed
    before every launch (at X3/X4's stages 3-4 and at X7 input and output fit
    the H100's 50 MB L2, and back-to-back launches would read them from
    there), in turns: the library's one call (clone, permute().contiguous(),
    F.pad), the kernel, the plain version, then the kernel and the library
    call twice more; the bytes bound and the kernel's share of it. A share
    over 1 fails: the timing would be wrong, not the kernel. Logged beside
    each: the kernel's mean less the library's against the spread of the
    turns (the larger range of the kernel's and the library's three
    readings)."""
    rows, worst = defaultdict(list), {"bf16": 0.0, "f32": 0.0}
    cases = L.probe_cases()
    last = {fn: i for i, (_, _, fn, *_) in enumerate(cases)}
    for i, (row, name, fn, plain, library, shape) in enumerate(cases):
        for dtype in ("bf16", "f32") if last[fn] == i else ("bf16",):
            x = L.inputs(shape, DT[dtype], DEV, seed=30 + i)
            got, again = fn(x), fn(x)
            torch.cuda.synchronize()
            want = plain(x)
            err = max_err(got, want)
            worst[dtype] = max(worst[dtype], err)
            ok = (torch.equal(got, want) and torch.equal(got, again)
                  and got.data_ptr() != x.data_ptr())
            log(f"{row} {name} {dtype}: equal to its plain version and to a second launch: "
                f"{ok} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{fn.__name__} disagrees with its plain version at {name} {dtype}")
            if dtype != "bf16":
                continue
            b, by = bound_ms(L.work(shape, want.numel(), 2), 0, "bf16")
            timed = {"ms": lambda: fn(x), "plain_ms": lambda: plain(x),
                     "library_ms": lambda: library(x)}
            got_ms = defaultdict(list)
            for key in ("library_ms", "ms", "plain_ms", "ms", "library_ms", "ms", "library_ms"):
                got_ms[key].append(cold_ms(timed[key], LAYOUT_ITERS))
            t = {k: sum(v) / len(v) for k, v in got_ms.items()}
            spread = max(max(v) - min(v) for v in got_ms.values() if len(v) > 1)
            t.update(case=name, bound_ms=b, bound_by=by, bound_share=b / t["ms"],
                     over_library_ms=t["ms"] - t["library_ms"], spread_ms=spread,
                     turns={k: v for k, v in got_ms.items() if len(v) > 1})
            log(f"   bf16 times (cold L2, in turns): kernel {t['ms']:.4f} ms "
                f"({' / '.join(f'{v:.4f}' for v in got_ms['ms'])}), plain {t['plain_ms']:.4f} "
                f"ms, library {t['library_ms']:.4f} ms "
                f"({' / '.join(f'{v:.4f}' for v in got_ms['library_ms'])}), bound {b:.4f} ms "
                f"({by}), kernel at {100 * t['bound_share']:.1f}% of the bound, library at "
                f"{100 * b / t['library_ms']:.1f}%; kernel - library "
                f"{t['over_library_ms']:+.4f} ms against a spread of {spread:.4f}")
            if t["bound_share"] > 1.0:
                fail(f"{row} {name}: the kernel times under its bytes bound; the timing is wrong")
            rows[row].append(t)
        del x, got, again, want
    return rows, worst


# --- phases 4-5: the serving and training paths ---------------------------------

COUNTED = {"window_attention": (A, "fused_attention_qkv"), "ln_mlp": (M, "fused_ln_mlp"),
           "window_attention_bwd": (A, "fused_attention_qkv_bwd"),
           "ln_mlp_bwd": (M, "fused_ln_mlp_bwd"), "attention": (A, "fused_attention"),
           "attention_bwd": (A, "fused_attention_bwd"), "mlp": (M, "fused_mlp"),
           "mlp_bwd": (M, "fused_mlp_bwd"), "bottleneck": (BN, "fused_chain"),
           "bottleneck_bwd": (BN, "fused_chain_bwd"),
           "matmul_bn": (MB, "fused_matmul_bn_relu_stats"), "grouped_conv": (GC, "gconv"),
           "layout_stream": (L, "stream"), "layout_transpose": (L, "transpose_in_kernel"),
           "window_gather": (L, "gather_windows"), "window_scatter": (L, "scatter_windows"),
           "window_merge": (L, "merge_windows"), "window_split": (L, "split_windows"),
           "window_pad8": (L, "pad8")}


# the kernels with a GEMM route (bf16 at the tensor-core widths), counted by
# their gemm_launches: K5 and K7, K6 and K8
GEMM_FWD = (("ln_mlp", M.fused_ln_mlp), ("mlp", M.fused_mlp))
GEMM_BWD = (("ln_mlp_bwd", M.fused_ln_mlp_bwd), ("mlp_bwd", M.fused_mlp_bwd))


def zero_counts():
    for mod, fn in COUNTED.values():
        getattr(mod, fn).launches = 0


def read_counts():
    return {name: getattr(mod, fn).launches for name, (mod, fn) in COUNTED.items()}


def set_plain(on):
    for k in ("NKBX_FUSED_ATTENTION", "NKBX_FUSED_MLP", "NKBX_FUSED_CHAIN"):
        if on:
            os.environ[k] = "0"
        else:
            os.environ.pop(k, None)


def block_counts(cfg, attention, widths):
    """A transformer's launches per forward (and backward): each block's MLP
    kernel from the gate's answer for its width (with the NKBX_FUSED_MLP
    switch unset), and its attention kernel (None for ConvNeXt)."""
    flag = (cfg.get("backbone_opts") or {}).get("fused_mlp")

    def counts(dtype, backward):
        modes = [M.fused_mlp_mode(flag, torch.empty(1, c, dtype=dtype, device=DEV), 4 * c,
                                  auto=flag is None) for c in widths]
        want = dict.fromkeys(COUNTED, 0)
        want["ln_mlp"], want["mlp"] = modes.count("ln"), modes.count("mlp")
        if attention:
            want[attention] = len(widths)
        if backward:
            want["ln_mlp_bwd"], want["mlp_bwd"] = want["ln_mlp"], want["mlp"]
            if attention:
                want[attention + "_bwd"] = len(widths)
        return want

    return counts


def chain_counts(dtype, backward):
    """ResNet-50 with the fused chain: one K9 (and K10) launch per identity
    block whose stage stat_band gives a band in ``dtype`` (bf16 2 + 3 + 5,
    f32 2 + 3)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    n = sum(k for k, h, c, m in RESNET_STAGES
            if BN.stat_band(BUCKET, h, h, c, m, GHOST, itemsize) is not None)
    want = dict.fromkeys(COUNTED, 0)
    want["bottleneck"] = n
    if backward:
        want["bottleneck_bwd"] = n
    return want


class Path:
    """One model of the smoke run: its config (full width and depth, random
    weights from seed 0, 10 classes); ``counts(dtype, backward)``, each
    kernel's launches in one forward (and backward); its attention kernel;
    the environment it runs under (``NKBX_FUSED_LN_MLP=0`` takes K7/K8);
    whether its layer-scales are drawn anew; whether it serves (the fused
    chain runs in training only); and whether it is a ReLU net with ghost
    BatchNorm: every row of its training batch valid (the recipe with
    drop_last=True), its running statistics and f32 trajectory checked, its
    f32 grads held by check_gated_grads and its bf16 chain blocks by
    check_chain_blocks; and ``yardstick``, the config of the model a user
    would run without the kernels (timed beside the step, not compared)."""

    def __init__(self, label, cfg, counts, attention=None, env=None, layer_scale=False,
                 serves=True, ghost_bn=False, yardstick=None):
        self.label, self.cfg, self.counts, self.attention = label, cfg, counts, attention
        self.env, self.layer_scale = env or {}, layer_scale
        self.serves, self.ghost_bn, self.yardstick = serves, ghost_bn, yardstick
        # {(kernel name, "serve" | "train"): device ms in the profiled bucket-64
        # forward or train step}
        self.profiled = {}
        # {(kernel name, "serve" | "train"): tensor-core launches of K1 and K2 (Swin)}
        self.tc_launches = {}
        # {(kernel name, "serve" | "train"): GEMM-route launches of K5 and K6}
        self.gemm_launches = {}

    def model(self, dtype, cfg=None):
        model = get_model(cfg or self.cfg, [f"class{i}" for i in range(10)], seed=0, dtype=dtype)
        if self.layer_scale:  # seeded U[0.1, 1], the same in every dtype
            gen = torch.Generator().manual_seed(1)
            for name, p in model.module.named_parameters():
                if name.endswith("layer_scale"):
                    p.data.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))
        return model

    @contextlib.contextmanager
    def environment(self):
        saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def kernels_ran(want, backward):
    """Whether a path's expected counts launch some kernel in that direction."""
    return any(v > 0 for k, v in want.items() if k.endswith("_bwd") == backward)


SWIN_WIDTHS = [c for d, c in zip(DEPTHS, (96, 192, 384, 768)) for _ in range(d)]
SWIN_CFG = {"model": "swin_tiny_patch4_window7_224"}
SWIN = Path("swin_tiny", SWIN_CFG, block_counts(SWIN_CFG, "window_attention", SWIN_WIDTHS),
            "window_attention")
VIT_CFG = {"model": "vit_base_patch16_224",
           "backbone_opts": {"fused_attention": True, "fused_mlp": True}}
VIT = Path("vit_base", VIT_CFG, block_counts(VIT_CFG, "attention", [768] * 12), "attention")
UNICOM_CFG = {"model": "unicom ViT-B/16",
              "backbone_opts": {"fused_attention": True, "fused_mlp": True}}
UNICOM = Path("unicom_b16", UNICOM_CFG, block_counts(UNICOM_CFG, "attention", [768] * 12),
              "attention")
CONVNEXT_WIDTHS = [c for d, c in zip(CONVNEXT_DEPTHS, (96, 192, 384, 768)) for _ in range(d)]
CONVNEXT_CFG = {"model": "convnext_tiny"}
CONVNEXT = Path("convnext_tiny", CONVNEXT_CFG, block_counts(CONVNEXT_CFG, None, CONVNEXT_WIDTHS),
                layer_scale=True)
CONVNEXT_MLP = Path("convnext_tiny_mlp", CONVNEXT_CFG,
                    block_counts(CONVNEXT_CFG, None, CONVNEXT_WIDTHS),
                    env={"NKBX_FUSED_LN_MLP": "0"}, layer_scale=True)
RESNET = Path("resnet50_ghost2_fused",
              {"model": "resnet50", "backbone_opts": {"ghost_bn": GHOST, "fused_bottleneck": True}},
              chain_counts, serves=False, ghost_bn=True,
              yardstick={"model": "resnet50", "backbone_opts": {"ghost_bn": GHOST}})
PATHS = (SWIN, VIT, UNICOM, CONVNEXT, CONVNEXT_MLP, RESNET)


def serve_all(serving, requests):
    outs = [serving(r) for r in requests]
    torch.cuda.synchronize()
    return outs


def report_profile(prof, reps, what, step_ms, fname):
    """Logs the device time, the idle share against ``step_ms`` and the
    largest kernels, and writes every kernel's line to ``fname``; returns
    the kernel events (an empty list when none was recorded)."""
    events = device_events(prof)
    if not events:
        log("profile: no device time recorded (not measured)")
        return events
    total = sum(us for us, _ in events) / 1e3 / reps
    log(f"profile: device busy {total:.3f} ms {what}, against {step_ms:.3f} ms unprofiled "
        f"(idle share {1 - total / step_ms:.3f})")
    lines = [f"{us / 1e3 / reps:10.4f} ms  {e.count // reps:5d}x  {e.key[:90]}"
             for us, e in events]
    for line in lines[:12]:
        log("  " + line)
    with open(os.path.join(OUT_DIR, fname), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return events


def device_ms(events, reps):
    """Device ms of all kernels in a profile, per repetition."""
    return sum(us for us, _ in events) / 1e3 / reps


def profile_forward(path, serving, x, step_ms):
    """Device time by kernel over 3 forwards at bucket 64 (torch.profiler) of
    the batch ``x`` already on the card: the work that ``compute_p50_ms``
    times. The idle share is against ``step_ms``, that p50 measured without
    the profiler; a negative share would mean the two measure different
    work. Records the attention kernel's ms a forward."""
    from torch.profiler import ProfilerActivity, profile

    serving(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            serving(x)
        torch.cuda.synchronize()
    events = report_profile(prof, 3, f"per bucket-64 {path.label} forward", step_ms,
                            f"profile_bucket64_{path.label}.txt")
    if not events:
        fail(f"the profile of the {path.label} forward recorded no device time")
    path.profiled[("device", "serve")] = device_ms(events, 3)
    want = path.counts(torch.bfloat16, False)
    for kernel in (path.attention, "ln_mlp", "mlp"):
        if kernel and want[kernel]:
            ms = path.profiled[(kernel, "serve")] = kernel_ms(events, kernel, 3, want)
            log(f"profile: {kernel} kernels {ms:.3f} ms a bucket-64 {path.label} forward")


def check_path(path):
    """Serving: a ServingModule with buckets (1, 8, 64) answers requests of 1,
    5, 64 and 70 images through the kernels (launch counts, finite logits),
    and agrees with the plain versions in bf16 and in f32."""
    model = path.model(torch.bfloat16)
    if path.layer_scale:
        scales = [p for n, p in model.module.named_parameters() if n.endswith("layer_scale")]
        log(f"path {path.label}: {len(scales)} layer_scale tensors drawn from U[0.1, 1] (seed "
            f"1), mean {float(torch.cat(scales).detach().mean()):.4f}; environment {path.env}")
    serving = ServingModule(model, buckets=(1, 8, BUCKET), warm_up_on_load=False)
    rng = np.random.default_rng(0)
    sizes = (1, 5, 64, 70)
    requests = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8) for n in sizes]
    forwards = 1 + 1 + 1 + 2  # 70 = a chunk of 64 and a bucket-8 chunk of 6

    set_plain(False)
    tc0 = A.fused_attention_qkv.tc_launches
    gemm0 = {name: fn.gemm_launches for name, fn in GEMM_FWD}
    zero_counts()
    outs = serve_all(serving, requests)
    counts = read_counts()
    for name, fn in GEMM_FWD:  # bf16 at every width of the zoo's transformers
        gemm = path.gemm_launches[(name, "serve")] = fn.gemm_launches - gemm0[name]
        log(f"path {path.label}: {name}'s GEMM route launched {gemm} times")
        if gemm != counts[name]:
            fail(f"{path.label}: {name} did not take its GEMM route in every bf16 launch")
    want = {k: v * forwards for k, v in path.counts(torch.bfloat16, False).items()}
    log(f"path {path.label}: {forwards} forwards; launches {counts} (expect {want})")
    if (counts != want or not kernels_ran(want, False)
            or (path.attention and not counts[path.attention])):
        fail(f"the {path.label} serving path did not go through the kernels as expected")
    if path.attention == "window_attention":  # bf16 Swin-T: K1 on its tensor-core design
        tc = path.tc_launches[("window_attention", "serve")] = (A.fused_attention_qkv.tc_launches
                                                                - tc0)
        log(f"path {path.label}: K1's tensor-core design launched {tc} times")
        if tc != counts["window_attention"]:
            fail(f"{path.label}: K1 did not take its tensor-core design in every bf16 launch")
    for n, o in zip(sizes, outs):
        if tuple(o.shape) != (n, 10) or o.dtype != torch.float32 or not torch.isfinite(o).all():
            fail(f"{path.label} logits of request {n}: shape {tuple(o.shape)}, dtype {o.dtype}")

    set_plain(True)
    plain = serve_all(serving, requests)
    set_plain(False)
    worst_rel = 0.0
    for n, o, p in zip(sizes, outs, plain):
        rel = max_err(o, p) / float(p.abs().max())
        worst_rel = max(worst_rel, rel)
        log(f"path {path.label} request {n}: max|kernel - plain| / max|plain| = {rel:.3e} "
            f"(tol 5.0e-02)")
    if worst_rel > 5e-2:
        fail(f"{path.label} bf16 logits through the kernels disagree with the plain versions")

    # the same check in f32 (TF32 off), where the kernels should agree closely
    s32 = ServingModule(path.model(torch.float32), buckets=(8,), warm_up_on_load=False)
    o32 = serve_all(s32, requests[1:2])[0]
    set_plain(True)
    p32 = serve_all(s32, requests[1:2])[0]
    set_plain(False)
    rel32 = max_err(o32, p32) / float(p32.abs().max())
    log(f"path {path.label} f32 request 5: max|kernel - plain| / max|plain| = {rel32:.3e} "
        f"(tol 1.0e-03)")
    if rel32 > 1e-3:
        fail(f"{path.label} f32 logits through the kernels disagree with the plain versions")
    del s32

    bench = {}
    for label, plain_on in (("kernels", False), ("plain", True), ("kernels", False)):
        set_plain(plain_on)
        torch.cuda.reset_peak_memory_stats()
        r = serving.benchmark(BUCKET, iters=20)
        r["max_memory_allocated_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        bench.setdefault(label, []).append(r)
        log(f"benchmark({BUCKET}) {path.label} {label}: {json.dumps(r)}")
    set_plain(False)
    profile_forward(path, serving, torch.as_tensor(requests[2], device=DEV),
                    bench["kernels"][-1]["compute_p50_ms"])
    return counts


def check_grads(path, model, init, criterion, pipe, images, labels, mask):
    """Every tensor's grads of one backward of the batch from the weights
    ``init``: bf16 and f32 (TF32 off), each through the kernels and through
    the plain versions, with the launch counts of each.

    Each difference is taken against the larger of the tensor's largest
    value and 1e-4 of the largest value of all grads: ViT's key biases get
    no gradient in exact arithmetic (a shift of a whole score row), only
    rounding noise, which the floor keeps from counting as a disagreement.
    f32: kernels against plain within 1e-3. Only where a tensor fails that
    and its plain f32 grads lie wholly under the floor is it held otherwise:
    such a tensor is rounding noise around an exact 0 (unicom's final
    LayerNorm bias and its first BatchNorm1d's bias: the next training-mode
    BatchNorm1d sends back a gradient that sums to 0 over the batch, and each
    bias takes only that sum), and two samples of rounding noise have no
    relative distance. There the yardstick is the plain path's own, its f32
    grads on the input perturbed by ~1 ulp (computed only then), and the
    kernels must lie within twice that distance plus 1e-3 of the floor (as
    check_gated_grads holds a ReLU net); both readings are logged. bf16: the two paths round to
    bf16 at the same points but in a different order of sums, so their grads
    differ by bf16 noise, which is largest (a few 1e-2 of the tensor's
    largest value) in Swin's relative-position-bias tables, sums of dS over
    every window. The yardstick is the plain bf16 path's own distance from
    the f32 grads: through the kernels each tensor must lie within twice
    that distance (plus 1e-3) of the f32 grads. A wrong bf16 backward, off by
    O(1), fails."""
    def grads(module, x, plain):
        set_plain(plain)
        module.zero_grad(set_to_none=True)
        zero_counts()
        criterion(module(x), labels, mask=mask).backward()
        torch.cuda.synchronize()
        out = {n: p.grad.clone() for n, p in module.named_parameters()}
        set_plain(False)
        return out, read_counts()

    def perturbed(module, x):  # plain on the input perturbed by ~1 ulp
        gen = torch.Generator(device=DEV).manual_seed(11)
        noise = torch.randn(x.shape, generator=gen, device=DEV)
        return grads(module, x * (1 + 2.0 ** -23 * noise), True)[0]

    m32 = path.model(torch.float32)
    g = {}
    for dtype, module in ((torch.float32, m32.module), (torch.bfloat16, model.module)):
        module.load_state_dict(init)
        module.train()
        x = pipe.device_apply(images, out_dtype=dtype)
        want = path.counts(dtype, True)
        for plain in (False, True):
            g[dtype, plain], counts = grads(module, x, plain)
            ok = counts == (dict.fromkeys(want, 0) if plain else want)
            log(f"grads {path.label} {DTYPE_NAME[dtype]} {'plain' if plain else 'kernels'}: "
                f"launches {counts} {'ok' if ok else 'FAIL'}")
            if not ok or not kernels_ran(want, True):
                fail("the gradient check did not compare the kernels with the plain path")
        if dtype == torch.float32:
            x32 = x
            if path.ghost_bn:
                g[dtype, "perturbed"] = perturbed(module, x)
    if path.ghost_bn:
        del m32, x32
        return check_gated_grads(path, g)
    g32 = g[torch.float32, True]
    floor = 1e-4 * max(float(t.abs().max()) for t in g32.values())

    def rel(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), floor)

    gk32 = g[torch.float32, False]
    rels = {n: rel(gk32[n], g32[n]) for n in g32}
    worst = max((r, n) for n, r in rels.items())
    off = sorted(n for n, r in rels.items() if r > 1e-3)
    noise = [n for n in off if float(g32[n].abs().max()) < floor]
    log(f"grads {path.label} f32: max |kernels - plain| / max|plain| per tensor = "
        f"{worst[0]:.3e} ({worst[1]}; tol 1.0e-03); {len(off)} tensors over it, "
        f"{len(noise)} of them rounding noise under the floor {floor:.3e}")
    if len(noise) < len(off):
        fail(f"{path.label} f32 grads through the kernels disagree with the plain path: "
             f"{[n for n in off if n not in noise][:5]}")
    gq32 = perturbed(m32.module, x32) if noise else {}
    del m32, x32
    for n in noise:
        d, dq = (float((t[n] - g32[n]).abs().max()) for t in (gk32, gq32))
        log(f"grads {path.label} f32: {n} fails the floor rule ({rels[n]:.3e} > 1e-3; max|plain| "
            f"{float(g32[n].abs().max()):.3e}): |kernels - plain| {d:.3e}, plain on a "
            f"1-ulp-perturbed input {dq:.3e} (tol 2x + {1e-3 * floor:.3e})")
        if d > 2 * dq + 1e-3 * floor:
            fail(f"{path.label} f32 grads of {n} through the kernels are farther from plain than "
                 "plain's own rounding")
    check_bf16_grads(f"grads {path.label}", g[torch.bfloat16, False], g[torch.bfloat16, True],
                     g32)


def check_bf16_grads(what, gk, gp, g32):
    """PERF.md §2's bf16 rule on dicts of tensors by name: the bf16 values
    through the kernels (``gk``) and through plain (``gp``) against the f32
    plain values (``g32``), each distance taken against the larger of the
    tensor's largest f32 value and 1e-4 of the largest of all; through the
    kernels each tensor must lie within twice plain's distance plus 1e-3.
    Fails the phase on a miss."""
    floor = 1e-4 * max(float(t.abs().max()) for t in g32.values())

    def rel(got, want):
        return float((got.float() - want).abs().max()) / max(float(want.abs().max()), floor)

    rows = [(rel(gk[n], g32[n]), rel(gp[n], g32[n]), rel(gk[n], gp[n]), n) for n in g32]
    bad = [r for r in rows if not r[0] <= 2 * r[1] + 1e-3]
    ratio = max(rows, key=lambda r: r[0] / max(r[1], 1e-30))
    log(f"{what} bf16: per tensor, distance from the f32 values through the kernels / through "
        f"plain at most {ratio[0] / max(ratio[1], 1e-30):.3f} ({ratio[3]}: {ratio[0]:.3e} / "
        f"{ratio[1]:.3e}; tol 2 x plain + 1e-3); largest distance from f32 (/ its max) kernels "
        f"{max(r[0] for r in rows):.3e}, plain {max(r[1] for r in rows):.3e}; {len(bad)} of "
        f"{len(rows)} off")
    rows.sort(key=lambda r: -r[2])
    for r in rows[:4]:
        log(f"  {r[3]}: kernels - plain {r[2]:.3e}, kernels - f32 {r[0]:.3e}, "
            f"plain - f32 {r[1]:.3e}")
    if bad:
        fail(f"{what}: bf16 values through the kernels are farther from f32 than plain bf16: "
             f"{bad[:5]}")


def check_running_stats(path, got, want, tol, what):
    """Every BatchNorm running statistic of ``got`` (after 5 steps through
    the kernels, say) against ``want``'s (the plain path's), each within
    ``tol`` of its largest value; ``what`` says which two. On a path without
    ghost BN (unicom's head) a running mean is held in units of its
    feature's running standard deviation instead, the scale at which the
    BatchNorm applies it: the second BatchNorm1d takes the first's
    zero-mean output through a bias-free Dense, so its mean is rounding noise
    in exact arithmetic and its largest value no scale at all."""
    def err(n):
        if not path.ghost_bn and n.endswith("running_mean"):
            std = want[n[:-len("mean")] + "var"].sqrt()
            return float(((got[n] - want[n]).abs() / std).max())
        return max_err(got[n], want[n]) / float(want[n].abs().max())

    worst = max((err(n), n) for n in got)
    scale = "max|want|" if path.ghost_bn else "max|want| (means: / running std)"
    log(f"train {path.label} {what}: {len(got)} BatchNorm running statistics, max "
        f"|got - want| / {scale} = {worst[0]:.3e} ({worst[1]}; tol {tol:.0e})")
    if worst[0] > tol:
        fail(f"{path.label} {what}: the running statistics disagree")


def check_gated_grads(path, g, what=("kernels", "plain")):
    """The f32 grad check of a ReLU network with ghost BN: the grads through
    the kernels against the plain path's, by relative L2 error, over all
    tensors together and per tensor. The yardstick is the plain path's own
    sensitivity to rounding: its grads on the input perturbed by ~1 f32 ulp.
    The kernels must lie from plain within twice that distance plus a floor
    (all tensors 1e-3, per tensor 1e-2). Rounding-level differences move relu
    gates that sit near 0 to the other side, and ghost BatchNorm over groups
    as small as 98 rows (stage 4) carries them through every later gradient,
    so neither a fixed elementwise tolerance nor the f32 grads of another
    dtype is the right ruler. bf16 has no model-level grad check: at random
    init a 1-ulp perturbation moves its grads by more than their own size, so
    such a ruler passes anything; check_chain_blocks holds K9/K10 on the bf16
    step's own block inputs instead. ``what`` names the two sides in the log
    (check_resnet_masked holds the masked step against the exact step on the
    valid rows with the same ruler)."""
    gk, gp, gq = g[torch.float32, False], g[torch.float32, True], g[torch.float32, "perturbed"]

    def l2(a, b, names):
        d = sum(float((a[n] - b[n]).float().norm()) ** 2 for n in names) ** 0.5
        return d / max(sum(float(b[n].float().norm()) ** 2 for n in names) ** 0.5, 1e-30)

    k_all, p_all = l2(gk, gp, gp), l2(gq, gp, gp)
    rows = [(l2(gk, gp, [n]), l2(gq, gp, [n]), n) for n in gp]
    bad = [r for r in rows if r[0] > 2 * r[1] + 1e-2]
    worst = max(rows, key=lambda r: r[0] / (2 * r[1] + 1e-2))
    a, b = what
    log(f"grads {path.label} f32: |{a} - {b}| / |{b}| (L2) over all tensors {k_all:.3e}, "
        f"{b} on a 1-ulp-perturbed input {p_all:.3e} (tol 2x + 1e-03); per tensor worst "
        f"{worst[2]}: {worst[0]:.3e} against {worst[1]:.3e} (tol 2x + 1e-02); "
        f"{len(bad)} tensors off")
    if k_all > 2 * p_all + 1e-3 or bad:
        fail(f"{path.label} f32 grads of {a} disagree with {b}: {bad[:5]}")


def check_chain_blocks(path, model, init, criterion, pipe, images, labels, mask):
    """K9 and K10 on the real inputs of one bf16 train step: one forward and
    backward through the kernels from the weights ``init`` records every
    fused_chain call's inputs, band and upstream gradient; then each block's
    K9 and K10 are held against the plain chain on those tensors at
    check_chain's tolerances. One call per chain block of the step."""
    from nkbx_torch.models import resnet as R

    calls, chain = [], R.fused_chain

    def recording(*args, g, th, eps):
        out, stats = chain(*args, g=g, th=th, eps=eps)
        rec = {"args": tuple(a.detach().clone() for a in args), "g": g, "th": th}
        out.register_hook(lambda d: rec.__setitem__("dout", d.detach().clone()))
        calls.append(rec)
        return out, stats

    module = model.module
    module.load_state_dict(init)
    module.train()
    module.zero_grad(set_to_none=True)
    set_plain(False)
    R.fused_chain = recording
    try:
        criterion(module(pipe.device_apply(images, out_dtype=torch.bfloat16)), labels,
                  mask=mask).backward()
        torch.cuda.synchronize()
    finally:
        R.fused_chain = chain
    want = path.counts(torch.bfloat16, True)["bottleneck"]
    if len(calls) != want or any("dout" not in r or r["g"] != GHOST for r in calls):
        fail(f"{path.label}: recorded {len(calls)} chain calls of one bf16 step, expected {want}")
    worst = 0.0
    for i, rec in enumerate(calls):
        n0 = chain_tc_counts()
        ok, _, _, grad_l2, _ = compare_chain(f"{path.label} block {i}", rec["args"], rec["dout"],
                                             rec["th"])
        if not ok:
            fail(f"{path.label}: K9/K10 disagree with the plain chain on block {i}'s inputs")
        if chain_tc_counts() != (n0[0] + 1, n0[1] + 1):
            fail(f"{path.label}: block {i}'s K9/K10 did not take the tensor-core route")
        worst = max(worst, *grad_l2.values())
    log(f"blocks {path.label} bf16: K9/K10 held against the plain chain on the {len(calls)} "
        f"chain blocks' inputs of one step; gradients' relative L2 at most {worst:.3e}")
    del calls


def check_train(path):
    """Training: 5 full-width steps on a seeded batch of 64 (the last 6 rows
    masked out, or every row valid for a ghost-BN path) through the kernels
    and through the plain versions from the same weights, and the BatchNorm
    running statistics after them; one backward's grads (check_grads); step
    time, img/s and peak memory of both paths; a profile of one step."""
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize, VerticalFlip

    model = path.model(torch.bfloat16)
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
    if not path.ghost_bn:
        mask[-6:] = False

    def fresh(plain, mdl=model):
        set_plain(plain)
        mdl.module.load_state_dict(init)
        state = TrainState.create(mdl, seed=0)
        step = build_train_step(mdl, criterion, bundle, augment_fn=pipe.device_apply)
        return state, lambda st: step(st, images, labels, mask, 1.0, 1.0)

    def five_steps(plain, mdl=model):
        state, step = fresh(plain, mdl)
        losses, counts = [], []
        for _ in range(5):
            zero_counts()
            state, metrics = step(state)
            torch.cuda.synchronize()
            counts.append(read_counts())
            losses.append(float(metrics["loss"]))
        finite = all(bool(torch.isfinite(p.grad).all()) for p in mdl.module.parameters())
        return losses, counts, finite, running_stats(mdl)

    def running_stats(mdl):
        return {n: b.clone() for n, b in mdl.module.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    set_plain(False)
    # the gates' answers with the switches unset (five_steps(True) sets them)
    want, want32 = path.counts(torch.bfloat16, True), path.counts(torch.float32, True)
    fns = (A.fused_attention_qkv, A.fused_attention_qkv_bwd)
    tc0 = [fn.tc_launches for fn in fns]
    mlp_fns = GEMM_FWD + GEMM_BWD
    gemm0 = [fn.gemm_launches for _, fn in mlp_fns]
    chain0 = chain_tc_counts()
    losses, counts, finite, stats = five_steps(False)
    if want["bottleneck"]:  # bf16 ResNet: every K9 and K10 launch on the tensor-core route
        tc = tuple(a - b for a, b in zip(chain_tc_counts(), chain0))
        n = tuple(sum(c[k] for c in counts) for k in ("bottleneck", "bottleneck_bwd"))
        path.tc_launches[("bottleneck", "train")], path.tc_launches[("bottleneck_bwd", "train")] = tc
        log(f"train {path.label}: K9/K10's tensor-core route launched {tc} times in 5 steps "
            f"(of {n})")
        if tc != n:
            fail(f"{path.label}: K9/K10 did not take the tensor-core route in every bf16 launch")
    for (name, fn), g0 in zip(mlp_fns, gemm0):  # bf16: K5-K8 on their GEMM route
        n = path.gemm_launches[(name, "train")] = fn.gemm_launches - g0
        log(f"train {path.label}: {name}'s GEMM route launched {n} times in 5 steps")
        if n != sum(c[name] for c in counts):
            fail(f"{path.label}: {name} did not take its GEMM route in every bf16 launch")
    if path.attention == "window_attention":  # bf16 Swin-T: K1 and K2 on the tensor cores
        for name, fn, t0 in zip(("window_attention", "window_attention_bwd"), fns, tc0):
            tc = path.tc_launches[(name, "train")] = fn.tc_launches - t0
            log(f"train {path.label}: {name}'s tensor-core design launched {tc} times in 5 "
                f"steps")
            if tc != sum(c[name] for c in counts):
                fail(f"{path.label}: {name} did not take its tensor-core design in every bf16 "
                     "launch")
    log(f"train {path.label}: kernels, 5 steps, losses {[round(x, 5) for x in losses]}, "
        f"launches per step {counts[0]} (expect {want})")
    if any(c != want for c in counts) or not kernels_ran(want, True):
        fail(f"the {path.label} train step did not go through the kernels as expected: {counts}")
    if not finite or not all(np.isfinite(losses)):
        fail(f"{path.label}: non-finite loss or gradient through the kernels")
    if not losses[-1] < losses[0]:
        fail(f"{path.label}: the loss did not fall on the repeated batch: {losses}")
    launches = {k: sum(c[k] for c in counts) for k in want}
    plain_losses, plain_counts, _, plain_stats = five_steps(True)
    if any(sum(c.values()) for c in plain_counts):
        fail(f"the plain path launched kernels: {plain_counts}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    # with ghost BatchNorm (resnet50: 50 layers of ghost-BN statistics, down to 56
    # rows a tile at stage 3) bf16 rounding noise grows along the trajectory: there
    # the first step's loss, a forward from the same weights, keeps 5e-3 and the later
    # steps a loose 3e-2 that catches only gross faults; the trajectory is held
    # tightly in f32 below, and the kernels on the bf16 step's own block inputs in
    # check_chain_blocks (unicom's head BatchNorm1d pair keeps 5e-3)
    tol = [5e-3] + [3e-2 if path.ghost_bn else 5e-3] * 4
    log(f"train {path.label}: plain, 5 steps, losses {[round(x, 5) for x in plain_losses]}; "
        f"per step |kernels - plain| / |plain| {[f'{r:.2e}' for r in rel]} (tol "
        f"{[f'{t:.0e}' for t in tol]})")
    if any(r > t for r, t in zip(rel, tol)):
        fail(f"{path.label} bf16 losses through the kernels disagree with the plain path")
    if stats:
        check_running_stats(path, stats, plain_stats, 5e-2,
                            "bf16, kernels against plain after 5 steps")
        m32 = path.model(torch.float32)
        chain32 = chain_tc_counts()
        k32, c32, finite32, s32 = five_steps(False, m32)
        if chain_tc_counts() != chain32:
            fail(f"{path.label}: an f32 K9/K10 launch took the tensor-core route")
        p32, _, _, ps32 = five_steps(True, m32)
        del m32
        rel32 = [abs(a - b) / abs(b) for a, b in zip(k32, p32)]
        log(f"train {path.label} f32: 5 steps, losses kernels {[round(x, 6) for x in k32]}, "
            f"plain {[round(x, 6) for x in p32]}; max |kernels - plain| / |plain| "
            f"{max(rel32):.3e} (tol 5.0e-03); launches per step {c32[0]} (expect {want32})")
        if any(c != want32 for c in c32) or not finite32 or max(rel32) > 5e-3:
            fail(f"{path.label} f32 train steps through the kernels disagree with the plain path")
        check_running_stats(path, s32, ps32, 1e-3, "f32, kernels against plain after 5 steps")
    set_plain(False)
    check_grads(path, model, init, criterion, Compose([Normalize()]), images, labels, mask)
    if path.ghost_bn:
        check_chain_blocks(path, model, init, criterion, Compose([Normalize()]), images, labels,
                           mask)

    # the yardstick: the same weights in the model a user would run without the
    # kernels (resnet50: the unfused ghost-BN blocks, cuDNN convolutions and the
    # eager BatchNorm), timed only: its statistics groups differ from the chain's
    runs = [("kernels", False, model), ("plain", True, model)]
    if path.yardstick:
        runs.append(("unfused", False, path.model(torch.bfloat16, path.yardstick)))
    bench = {}
    for label, plain_on, mdl in runs + [("kernels", False, model)]:
        state, step = fresh(plain_on, mdl)
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
        log(f"train step {path.label} (batch {BUCKET}) {label}: {json.dumps(r)}")
    from torch.profiler import ProfilerActivity, profile

    # one step of each run under the profiler (the plain step's device time is
    # the yardstick of the kernels' step); the kernels' of the attention and
    # MLP kernels by name
    for label, plain_on, mdl in runs:
        state, step = fresh(plain_on, mdl)
        state, _ = step(state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state)
            torch.cuda.synchronize()
        set_plain(False)
        name = path.label if label == "kernels" else f"{path.label}_{label}"
        events = report_profile(prof, 1, f"in one batch-64 {name} train step",
                                bench[label][-1]["step_ms"], f"profile_train_step_{name}.txt")
        if not events:
            fail(f"the profile of the {name} train step recorded no device time")
        path.profiled[("device", f"train_{label}")] = device_ms(events, 1)
        if label != "kernels":
            continue
        agg = None
        if path is SWIN:  # the same profile through its chrome trace (A15's aggregation)
            trace = os.path.join(OUT_DIR, f"trace_train_step_{name}.json.gz")
            prof.export_chrome_trace(trace)
            agg = aggregate_trace(trace)
            log(f"profile: {name} trace {os.path.basename(trace)}: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in agg["by_category"].items()))
        for kernel in (path.attention, path.attention and path.attention + "_bwd", "ln_mlp",
                       "ln_mlp_bwd", "mlp", "mlp_bwd"):
            if kernel and want[kernel]:
                ms = path.profiled[(kernel, "train")] = kernel_ms(events, kernel, 1, want)
                log(f"profile: {kernel} kernels {ms:.3f} ms in one batch-64 {name} train step")
                if agg is not None:
                    tms = path.profiled[(kernel, "train_trace")] = kernel_ms(agg["by_name"], kernel,
                                                                             1, want)
                    log(f"profile: {kernel} kernels {tms:.3f} ms in the trace's aggregation")
                    if not tms or abs(tms - ms) > 1e-3 * ms + 1e-3:
                        fail(f"{name}: the trace's {kernel} ms {tms} is not key_averages' {ms}")
    if "plain" in bench:
        k, p = path.profiled[("device", "train_kernels")], path.profiled[("device", "train_plain")]
        log(f"profile {path.label}: device ms a train step, kernels {k:.3f} against plain "
            f"{p:.3f}")
    return launches


# --- phase 5: the resnet50 ghost2_fused step, K9/K10 in its profile ---------------

# every kernel of the chain's sources: bottleneck.cuh's and bottleneck_tc.cuh's
# (namespace chain) and the first design's entries' own (bottleneck.cu,
# bottleneck_bwd.cu)
CHAIN_KERNEL = re.compile(r"\bchain::|\(anonymous namespace\)::"
                          r"(output_kernel|dy_kernel|bn_bwd_sums|bn_bwd_apply)\b")
STEP_REPS = 5  # timed steps


def check_resnet_step():
    """The resnet50 ghost2_fused train step (bf16, batch 64, the check_train
    recipe) through the kernels: 5 steps timed on the host's clock (step ms,
    img/s, peak memory, launches and tensor-core launches a step), then one
    step and one forward (train mode, no grad: K9's launches only) under the
    profiler: the step's device time and idle share, and the chain's kernels
    in each (their sources' names, CHAIN_KERNEL): K9 = the forward's, K10 =
    the step's less the forward's. It reads only what every commit of the
    port has (a counter it lacks reads None), so a copy of this script run
    from another checkout (``python3 chip_smoke.py --resnet-step``) measures
    that checkout's kernels the same way."""
    from torch.profiler import ProfilerActivity, profile

    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize, VerticalFlip

    path = RESNET
    set_plain(False)
    model = path.model(torch.bfloat16)
    pipe = Compose([HorizontalFlip(), VerticalFlip(), Normalize()])
    criterion = get_loss({"type": "CrossEntropyLoss"})
    bundle = get_optimizer({"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4,
                            "weight_decay": 0.05})
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8),
                             device=DEV)
    labels = torch.as_tensor(rng.integers(0, 10, BUCKET), device=DEV)
    mask = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    state = TrainState.create(model, seed=0)
    step = build_train_step(model, criterion, bundle, augment_fn=pipe.device_apply)
    state, _ = step(state, images, labels, mask, 1.0, 1.0)
    torch.cuda.synchronize()

    def tc():
        return tuple(getattr(f, "tc_launches", None) for f in (BN.fused_chain, BN.fused_chain_bwd))

    tc0 = tc()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        state, _ = step(state, images, labels, mask, 1.0, 1.0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEP_REPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    counts = read_counts()
    launches = {k: counts[k] / STEP_REPS for k in ("bottleneck", "bottleneck_bwd")}
    tc_launches = [None if a is None else (a - b) / STEP_REPS for a, b in zip(tc(), tc0)]

    def chain_ms(events, reps):
        return sum(us for us, e in events if CHAIN_KERNEL.search(e.key)) / 1e3 / reps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, images, labels, mask, 1.0, 1.0)
        torch.cuda.synchronize()
    events = report_profile(prof, 1, f"in one batch-64 {path.label} train step", step_ms,
                            f"profile_train_step_{path.label}_chain.txt")
    if not events:
        fail(f"the profile of the {path.label} train step recorded no device time")
    module = model.module
    module.train()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as fprof:
        module(pipe.device_apply(images, out_dtype=torch.bfloat16))
        torch.cuda.synchronize()
    k9 = chain_ms(device_events(fprof), 1)
    device = device_ms(events, 1)
    r = {"step_ms": step_ms, "images_per_sec": BUCKET / step_ms * 1e3,
         "max_memory_allocated_mb": peak, "device_ms": device, "idle_share": 1 - device / step_ms,
         "k9_ms": k9, "k10_ms": chain_ms(events, 1) - k9, "launches": launches,
         "tc_launches": tc_launches}
    log(f"resnet step {path.label}: {json.dumps(r)}")
    if launches["bottleneck"] != 10 or launches["bottleneck_bwd"] != 10:
        fail(f"{path.label}: {launches} K9/K10 launches a step, expected 10 each")
    return r


# --- phase 5: resnet50 with exact and masked BatchNorm -----------------------------

EXACT_BATCH = 128  # bench.py's batch
MASKED_VALID = BUCKET - 6  # the rows of the masked batch that count
RESNET_EXACT = Path("resnet50_exact", {"model": "resnet50"},
                    lambda dtype, backward: dict.fromkeys(COUNTED, 0), serves=False)
RESNET_MASKED = Path("resnet50_masked", {"model": "resnet50"}, RESNET_EXACT.counts,
                     serves=False)


def sgd_step(model, masked_bn, augment):
    """bench.py's optimizer, sgd at lr 0.1, and cross-entropy: (state, step)."""
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer

    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer({"type": "sgd", "lr": 0.1}), augment_fn=augment,
                            masked_bn=masked_bn)
    return TrainState.create(model, seed=0), step


def no_launches(path, counts):
    """These paths run no kernel of ours: every count must stay 0."""
    if any(counts.values()):
        fail(f"{path.label} launched port kernels it should not: {counts}")


def profile_step(step, state, label, batch, step_ms):
    """One train step under torch.profiler: device time, launches, idle
    share against ``step_ms`` and the time by kind of kernel (the eager
    BatchNorm is the reductions and most of the elementwise kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    events = report_profile(prof, 1, f"in one batch-{batch} {label} train step", step_ms,
                            f"profile_train_step_{label}.txt")
    if not events:
        fail(f"the profile of the {label} train step recorded no device time")
    device = sum(us for us, _ in events) / 1e3
    kinds = kernel_kinds(events, 1)
    out = {"device_ms": device, "launches": sum(e.count for _, e in events),
           "idle_share": 1 - device / step_ms, "by_kind_ms": kinds,
           "reductions_and_elementwise_share": (kinds["reductions"] + kinds["elementwise"])
           / device,
           "cudnn_share": kinds["cudnn convolution"] / device}
    log(f"profile {label}: {json.dumps(out)}")
    return out


def check_resnet_exact():
    """RESNET_EXACT: bench.py's program through the port, built by
    ``nkbx_torch.bench.build_program`` (the benchmark's own program, with
    one step a call): resnet50 at 224 px, 1000 classes, batch 128, bf16,
    exact BatchNorm, HorizontalFlip(p=0.5) + Normalize on the card,
    cross-entropy, sgd at lr 0.1, every row valid, random weights from seed
    0, bench.py's seeded inputs. No kernel of ours runs on it (the counts,
    read around the bf16 steps, stay 0); its numerics against nkbx are held
    on the CPU (tests/test_torch_resnet.py, tests/test_torch_bench.py).
    Checks: step 0's loss within 0.5% of the same step in f32 (TF32 off);
    finite losses and grads. Two warm-up steps, then 5 timed steps (host
    clock, synchronised): step ms, img/s and peak memory; then a profile of
    one step."""
    from nkbx_torch.bench import build_program

    def first_step(dtype):
        program = build_program(dtype=dtype, scan_steps=1, device=DEV)
        if program.batch_size != EXACT_BATCH:
            fail(f"{RESNET_EXACT.label}: the bench program's batch is {program.batch_size}")
        return program, float(program.call()["loss"])

    loss32 = first_step(torch.float32)[1]
    torch.cuda.empty_cache()
    zero_counts()
    program, loss0 = first_step(torch.bfloat16)
    model, step = program.model, program.step
    images, labels, mask = program.image, program.label, program.mask
    state, _ = step(program.state, images, labels, mask, 1.0, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        state, metrics = step(state, images, labels, mask, 1.0, 1.0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    counts = read_counts()
    r = {"step_ms": ms, "images_per_sec": EXACT_BATCH / ms * 1e3,
         "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    losses = [loss0] + [float(v) for v in losses]
    rel = abs(loss0 - loss32) / abs(loss32)
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model.module.parameters())
    log(f"train {RESNET_EXACT.label} (batch {EXACT_BATCH}, bf16): step 0 and the 5 timed "
        f"steps' losses {[round(x, 5) for x in losses]}; step 0 against f32 {loss32:.6f}: "
        f"|bf16 - f32| / |f32| {rel:.3e} (tol 5e-03); finite grads {finite}; launches {counts}")
    no_launches(RESNET_EXACT, counts)
    if rel > 5e-3 or not finite or not all(np.isfinite(losses)):
        fail(f"{RESNET_EXACT.label}: step 0's bf16 loss is off f32 or a loss or grad is not finite")
    log(f"train step {RESNET_EXACT.label} (batch {EXACT_BATCH}): {json.dumps(r)}")
    r["profile"] = profile_step(lambda st: step(st, images, labels, mask, 1.0, 1.0), state,
                                RESNET_EXACT.label, EXACT_BATCH, ms)
    return r


BENCH_BRACKET = (0.85, 1.05)  # of RESNET_EXACT's host img/s, of its device-bound img/s
BENCH_TIMEOUT_S = 420  # the CLI's own watchdog ends its child at 210 s


def check_bench(exact):
    """BENCH: ``python -m nkbx_torch.bench``, the port's benchmark CLI, in a
    subprocess (K = 10 steps a call by default, its own watchdog): its one
    line must hold a finite, positive ``value``, this card's name as
    ``device``, and a value between 0.85 times RESNET_EXACT's host-clock
    img/s and 1.05 times its device-bound img/s (128 over the profiled
    step's device ms), both from this run. Logs the line and the phase's
    seconds."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.bench"], capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    with open(os.path.join(OUT_DIR, "bench_cli.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"BENCH: the CLI printed {len(lines)} lines (rc {proc.returncode}): "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    line = json.loads(lines[0])
    host_ips = exact["images_per_sec"]
    device_ips = EXACT_BATCH / exact["profile"]["device_ms"] * 1e3
    lo, hi = BENCH_BRACKET[0] * host_ips, BENCH_BRACKET[1] * device_ips
    value = line.get("value")
    out = {"line": line, "rc": proc.returncode, "host_ips": host_ips,
           "device_bound_ips": device_ips, "bracket": [lo, hi],
           "seconds": time.perf_counter() - t0}
    log(f"BENCH: {json.dumps(out)}")
    if proc.returncode != 0 or value is None or not np.isfinite(value) or value <= 0:
        fail(f"BENCH: no measurement: {line}")
    if line.get("device") != torch.cuda.get_device_name():
        fail(f"BENCH: the line names {line.get('device')!r}, not this card")
    if not lo <= value <= hi:
        fail(f"BENCH: {value} img/s outside [{lo:.1f}, {hi:.1f}] around RESNET_EXACT's rates")
    return out


DROPOUT_DIR = os.path.join("build", "dropout_smoke")  # the checkpoint after step 2
DROPOUT_CFG = {"model": "vit_base_patch16_224", "classifier_dropout": 0.1,
               "backbone_dropout": 0.1}
DROPOUT_BATCH = 32
DROPOUT_STEPS = 3
DROPOUT_COST_ROWS = 64  # ViT-B's mid-MLP mask (rows, 197, 3072) a rank, bf16
DROPOUT_WORLDS = (1, 2, 4, 8)


def dropout_run(steps, resume=None, save_after=None):
    """vit_base_patch16_224 with every dropout at 0.1 (embedding, attention,
    mid-MLP, classifier; the kernels off, as nkbx turns them off), bf16,
    flips + Normalize, sgd, from seed 0: (each step's loss, the state dict
    on the host). ``save_after``: the train state checkpointed after that
    many steps; ``resume``: the run starts from such a checkpoint."""
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.train.checkpoint import restore_train_state, save_checkpoint
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    model = get_model(DROPOUT_CFG, [f"class{i}" for i in range(N_CLASSES)], seed=0,
                      dtype=torch.bfloat16, device=DEV)
    state = TrainState.create(model, seed=0)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer({"type": "sgd", "lr": 0.1}),
                            augment_fn=Compose([HorizontalFlip(), Normalize()]).device_apply)
    if resume is not None:
        restore_train_state(resume, state)
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (DROPOUT_STEPS, DROPOUT_BATCH, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, N_CLASSES, (DROPOUT_STEPS, DROPOUT_BATCH))
    mask = torch.ones(DROPOUT_BATCH, dtype=torch.bool, device=DEV)
    losses = []
    for i in range(state.step, steps):
        state, metrics = step(state, torch.from_numpy(images[i]).to(DEV),
                              torch.from_numpy(labels[i]).to(DEV), mask, 1.0, 1.0)
        losses.append(float(metrics["loss"]))
        if save_after == i + 1:
            save_checkpoint(DROPOUT_DIR, state, epoch=0)
    sd = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
    del model, state, step
    torch.cuda.empty_cache()
    return losses, sd


def dropout_cost():
    """What a mask costs on the card at ViT-B's mid-MLP shape: the port's
    draw from a generator over a world of N (a rank draws N times its rows
    and keeps its own), F.dropout's (torch's global generator), and the
    draw of the rank's rows alone, in ms (CUDA events)."""
    from nkbx_torch.models.common import dropout, dropout_source

    gen = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn(DROPOUT_COST_ROWS, 197, 3072, device=DEV, dtype=torch.bfloat16)
    out = {"shape": list(x.shape), "dtype": "bf16",
           "F.dropout_ms": cuda_ms(lambda: F.dropout(x, 0.1, training=True))}
    with dropout_source(gen):
        out["port_dropout_world1_ms"] = cuda_ms(lambda: dropout(x, 0.1))
    for n in DROPOUT_WORLDS:
        shape = (DROPOUT_COST_ROWS * n, 197, 3072)
        out[f"draw_world{n}_ms"] = cuda_ms(
            lambda: torch.rand(shape, generator=gen, device=DEV)[:DROPOUT_COST_ROWS] < 0.9)
    return out


def check_dropout():
    """DROPOUT: every mask drawn from the train state's generator, on the
    card. vit_base_patch16_224 with classifier and backbone dropout at 0.1
    (dropout_run), deterministic cuDNN: two 3-step runs from seed 0 are bit
    for bit equal (losses and every tensor of the state dict), and a run
    checkpointed after step 2 and resumed from the checkpoint in a fresh
    model equals them, bit for bit. Then dropout_cost."""
    t0 = time.perf_counter()
    shutil.rmtree(DROPOUT_DIR, ignore_errors=True)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = [dropout_run(DROPOUT_STEPS, save_after=2), dropout_run(DROPOUT_STEPS)]
        resumed = dropout_run(DROPOUT_STEPS, resume=DROPOUT_DIR)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    shutil.rmtree(DROPOUT_DIR, ignore_errors=True)

    def equal(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    out = {"losses": runs[0][0], "resumed_losses": resumed[0],
           "runs_bit_equal": runs[0][0] == runs[1][0] and equal(runs[0][1], runs[1][1]),
           "resumed_bit_equal": (resumed[0] == runs[0][0][2:]
                                 and equal(resumed[1], runs[0][1]))}
    out["cost"] = dropout_cost()
    out["seconds"] = time.perf_counter() - t0
    log(f"DROPOUT ({DROPOUT_CFG['model']}, batch {DROPOUT_BATCH}, bf16): {json.dumps(out)}")
    if not out["runs_bit_equal"] or not out["resumed_bit_equal"]:
        fail(f"DROPOUT: runs from one seed differ: {out}")
    if not all(np.isfinite(out["losses"])):
        fail("DROPOUT: a non-finite loss")
    return out


def check_resnet_masked():
    """RESNET_MASKED: resnet50 with exact BatchNorm and masked_bn=True
    (build_train_step's option; TorchBatchNorm's mask branch) on the batch of
    64 whose last 6 rows are padding (random pixels, which must not count).
    In f32 (TF32 off), Normalize only (flips draw per row), sgd at lr 0.1:
    one step equals the exact-BN step on the 58 valid rows alone from the
    same weights: loss within 1e-4 relative, every running statistic within
    1e-3 of its largest value, the grads by check_gated_grads (relu gates
    flip under rounding noise; the yardstick is the exact step's change on
    its input perturbed by ~1 f32 ulp). Then, in bf16 with flips +
    Normalize, the masked step against the exact-BN step at batch 64 (every
    row valid), in turns (exact, masked, masked, exact), each a warm-up and
    5 timed steps. No kernel of ours runs on either (the counts stay 0)."""
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    classes = [f"class{i}" for i in range(10)]
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8),
                             device=DEV)
    labels = torch.as_tensor(rng.integers(0, 10, BUCKET), device=DEV)
    mask = torch.arange(BUCKET, device=DEV) < MASKED_VALID
    valid = torch.ones(MASKED_VALID, dtype=torch.bool, device=DEV)
    norm = Compose([Normalize()]).device_apply
    noise = torch.randn(MASKED_VALID, 224, 224, 3, device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(11))

    def perturbed(image, out_dtype=torch.float32, generator=None):
        return norm(image, out_dtype=out_dtype) * (1 + 2.0 ** -23 * noise)

    model = get_model(RESNET_MASKED.cfg, classes, seed=0, dtype=torch.float32)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}

    def one_step(masked_bn, n, augment):
        model.module.load_state_dict(init)
        state, step = sgd_step(model, masked_bn, augment)
        zero_counts()
        _, metrics = step(state, images[:n], labels[:n], mask[:n] if masked_bn else valid,
                          1.0, 1.0)
        torch.cuda.synchronize()
        no_launches(RESNET_MASKED, read_counts())
        return (float(metrics["loss"]), {k: p.grad.clone() for k, p in
                                         model.module.named_parameters()},
                {k: b.clone() for k, b in model.module.named_buffers()
                 if k.endswith(("running_mean", "running_var"))})

    loss_m, grads_m, stats_m = one_step(True, BUCKET, norm)
    loss_e, grads_e, stats_e = one_step(False, MASKED_VALID, norm)
    _, grads_q, _ = one_step(False, MASKED_VALID, perturbed)
    rel = abs(loss_m - loss_e) / abs(loss_e)
    log(f"train {RESNET_MASKED.label} f32: loss of the masked batch {loss_m:.7f}, of its "
        f"{MASKED_VALID} valid rows alone {loss_e:.7f}: relative {rel:.3e} (tol 1e-04)")
    if rel > 1e-4:
        fail(f"{RESNET_MASKED.label}: the masked step's loss is not the valid rows' loss")
    check_running_stats(RESNET_MASKED, stats_m, stats_e, 1e-3,
                        "f32 masked step against the exact step on the valid rows")
    check_gated_grads(RESNET_MASKED, {(torch.float32, False): grads_m,
                                      (torch.float32, True): grads_e,
                                      (torch.float32, "perturbed"): grads_q},
                      what=("masked", "exact on the valid rows"))
    del model, init, grads_m, grads_e, grads_q, noise
    torch.cuda.empty_cache()

    model = get_model(RESNET_MASKED.cfg, classes, seed=0, dtype=torch.bfloat16)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    pipe = Compose([HorizontalFlip(p=0.5), Normalize()]).device_apply
    every = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    bench = {}
    for label, masked_bn in (("exact", False), ("masked", True), ("masked", True),
                             ("exact", False)):
        model.module.load_state_dict(init)
        state, step = sgd_step(model, masked_bn, pipe)
        batch_mask = mask if masked_bn else every
        zero_counts()
        state, _ = step(state, images, labels, batch_mask, 1.0, 1.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            state, metrics = step(state, images, labels, batch_mask, 1.0, 1.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        no_launches(RESNET_MASKED, read_counts())
        if not np.isfinite(float(metrics["loss"])):
            fail(f"{RESNET_MASKED.label}: a non-finite bf16 {label} loss")
        r = {"step_ms": ms, "images_per_sec": BUCKET / ms * 1e3,
             "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        bench.setdefault(label, []).append(r)
        log(f"train step {RESNET_MASKED.label} (batch {BUCKET}, bf16) {label}: {json.dumps(r)}")
    return bench


# --- phase 7: the trainer path, from a config file ---------------------------------

TRAINER_DIR = os.path.join("build", "trainer_smoke")  # data and runs: a run's checkpoints
# (~340 MB each) are too large to bring back under OUT_DIR
TRAINER_SPLITS = (("train", 150), ("val", 70))  # images of 10 classes, 160-320 px
N_CLASSES = 10


def write_bmp(path, img):
    """A uint8 (H, W, 3) RGB image as a 24-bit bottom-up BMP."""
    h, w = img.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0))
        f.write(rows.tobytes())


def write_image_folder(root, seed=0):
    """A seeded ImageFolder of uint8 BMP files, 160-320 px a side, whose
    classes differ in their mean colour."""
    rng = np.random.default_rng(seed)
    for split, n in TRAINER_SPLITS:
        for i in range(n):
            c = i % N_CLASSES
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            h, w = (int(v) for v in rng.integers(160, 321, 2))
            tint = np.array([(c * 37) % 96, (c * 59) % 96, (c * 83) % 96]) - 48
            img = np.clip(rng.integers(0, 256, (h, w, 3)) + tint, 0, 255).astype(np.uint8)
            write_bmp(os.path.join(d, f"{i}.bmp"), img)


def trainer_config(data, run):
    """The text of the smoke's config file. Its first line is the shipped
    configs' own import of the transforms (configs/singletask_config.py),
    which the port's load_config resolves to nkbx_torch.transforms."""
    with open(os.path.join("configs", "singletask_config.py")) as f:
        header = next(line for line in f if line.startswith("import"))
    return header + textwrap.dedent(f"""
        task = "single"
        n_epochs = 2
        seed = 0
        enable_mixed_precision = True
        train_data = {{"type": "ImageFolder", "root": "{data}/train", "batch_size": {BUCKET},
                      "shuffle": True, "num_workers": 8, "drop_last": False}}
        val_data = {{"type": "ImageFolder", "root": "{data}/val", "batch_size": {BUCKET},
                    "shuffle": False, "num_workers": 8}}
        train_pipeline = T.Compose([
            T.LongestMaxSize(224), T.PadIfNeeded(224, 224, border_mode=0, value=0),
            T.HorizontalFlip(p=0.5), T.Normalize(), T.ToTensorV2()])
        val_pipeline = T.Compose([
            T.LongestMaxSize(224), T.PadIfNeeded(224, 224, border_mode=0, value=0),
            T.Normalize(), T.ToTensorV2()])
        model = {{"task": "single", "model": "swin_tiny_patch4_window7_224", "pretrained": False}}
        optimizer = {{"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4,
                     "backbone_weight_decay": 0.05, "classifier_weight_decay": 0.05}}
        lr_policy = {{"type": "cosine", "n_epochs": 2}}
        backbone_state_policy = {{0: "freeze", 1: "unfreeze"}}
        criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
        experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
    """)


def nkbx_modules():
    return sorted(m for m in sys.modules if m == "nkbx" or m.startswith("nkbx."))


class StepRecorder:
    """Wraps ``build_train_step`` so that each step of a ``train`` run
    records its loss and its kernels' launches, and, at step ``kill_at``
    (1-based), sends this process a SIGTERM after the step."""

    def __init__(self, build, kill_at=None):
        self.build, self.kill_at, self.steps = build, kill_at, []

    def __call__(self, *args, **kwargs):
        step = self.build(*args, **kwargs)

        def recorded(state, image, label, mask, lr_factor, freeze_scale):
            before = read_counts()
            state, metrics = step(state, image, label, mask, lr_factor, freeze_scale)
            after = read_counts()
            self.steps.append((metrics["loss"].detach().float().clone(),
                               {k: after[k] - before[k] for k in after if after[k] != before[k]}))
            if self.kill_at == len(self.steps):
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        recorded.masked_bn, recorded.has_batchnorm = step.masked_bn, step.has_batchnorm
        return recorded


def read_metrics_csv(path):
    with open(path) as f:
        head, *rows = [line.rstrip("\n").split("\t") for line in f]
    return [dict(zip(head, r)) for r in rows]


def check_trainer():
    """The path users run: ``python -m nkbx_torch.train -cfg CONFIG`` on a
    seeded ImageFolder of BMP files (150 train and 70 val images of 10
    classes) with a config that imports the transforms as nkbx's configs do:
    swin_tiny_patch4_window7_224 at full width and depth, bf16, batch 64
    with the last batch padded and masked (drop_last False), LongestMaxSize +
    PadIfNeeded + HorizontalFlip + Normalize, nadam with backbone and head
    lrs, cosine, {0: freeze, 1: unfreeze}, 2 epochs. Checks:
    (a) the CLI in a subprocess exits 0 and leaves classes.json, a 2-row
        metrics.csv, weights/best and weights/last;
    (d) loading the config leaves no nkbx module in sys.modules;
    (b) in this process, epoch 1's per-step losses through ``train`` equal
        (bit for bit) those of ``build_train_step`` driven directly on the
        same loader's batches from the same weights and generator seed, and
        every step launches K1, K2, K5 and K6 12 times each;
    (c) a run sent SIGTERM during batch 0 of epoch 2 saves a cursor at batch
        1, and ``train(resume_from=...)`` then ends with the uninterrupted
        run's weights, bit for bit (cuDNN held to deterministic algorithms;
        every kernel of ours sums in a fixed order);
    (e) the decoder the loader took, the loader's img/s, the trainer's img/s
        against the bare step's on the same batches, and the idle share of
        one epoch (device busy time from torch.profiler against the
        unprofiled epoch).
    Returns the launch counts of the in-process uninterrupted run."""
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_local_experiment
    from nkbx_torch.train import (TrainState, backbone_state_factor, build_train_step, get_loss,
                                  get_optimizer, get_scheduler, preempt)
    from nkbx_torch.train import trainer as TR
    from nkbx_torch.train.engine import _put_batch, has_batchnorm, train_epoch
    from nkbx_torch.utils import load_config

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    data = os.path.join(TRAINER_DIR, "data")
    write_image_folder(data)
    cfg_path = os.path.join(TRAINER_DIR, "config.py")
    with open(cfg_path, "w") as f:
        f.write(trainer_config(data, os.path.join(TRAINER_DIR, "run_cli")))

    # (a) the CLI
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.train", "-cfg", cfg_path],
                          capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "trainer_cli.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    run = os.path.join(TRAINER_DIR, "run_cli")
    rows = read_metrics_csv(os.path.join(run, "metrics.csv")) if proc.returncode == 0 else []
    have = [n for n in ("classes.json", "metrics.csv", "weights/best", "weights/last")
            if os.path.exists(os.path.join(run, n))]
    log(f"trainer (a): python -m nkbx_torch.train exit {proc.returncode} in {cli_s:.1f} s; "
        f"{have}; metrics.csv rows {len(rows)}")
    if proc.returncode != 0 or len(have) != 4 or len(rows) != 2:
        fail(f"the train CLI failed (log in {OUT_DIR}/trainer_cli.log): {proc.stderr[-2000:]}")
    shutil.copy(os.path.join(run, "metrics.csv"), os.path.join(OUT_DIR, "trainer_metrics.csv"))
    for r in rows:
        log(f"   epoch {r['Epoch']}: train loss {float(r['train loss']):.4f}, val loss "
            f"{float(r['Val loss']):.4f}, val balanced accuracy "
            f"{float(r['Val balanced accuracy']):.4f}, train images/sec "
            f"{float(r['train images/sec/chip']):.1f}")
        if not all(np.isfinite(float(r[k])) for k in ("train loss", "Val loss")):
            fail("the CLI's losses are not finite")

    # (d) the config loads without nkbx
    before = nkbx_modules()
    cfg = load_config(cfg_path)
    log(f"trainer (d): nkbx modules before loading the config {before}, after {nkbx_modules()}")
    if before or nkbx_modules():
        fail("loading the config left nkbx modules in sys.modules")

    def setup(name):
        cfg.experiment = {"comet": None, "local": {"path": os.path.join(TRAINER_DIR, name)}}
        train_loader = get_dataset(cfg.train_data, cfg.train_pipeline)
        classes = train_loader.dataset.classes
        val_loader = get_dataset({**cfg.val_data, "classes": classes}, cfg.val_pipeline)
        model = get_model(cfg.model, classes, seed=cfg.seed, dtype=torch.bfloat16)
        return (model, train_loader, val_loader, get_loss(cfg.criterion),
                get_local_experiment(cfg.experiment["local"]))

    def run_train(name, kill_at=None, resume_from=None):
        model, train_loader, val_loader, criterion, exp = setup(name)
        recorder = StepRecorder(build_train_step, kill_at)
        TR.build_train_step = recorder
        try:
            state = TR.train(model, train_loader, val_loader, criterion, None, exp, cfg,
                             resume_from=resume_from)
        finally:
            TR.build_train_step = build_train_step
        return state, recorder.steps, exp.path

    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (b) train() against the bare step
        zero_counts()
        full, full_steps, _ = run_train("run_full")
        torch.cuda.synchronize()
        counts = read_counts()
        per_epoch = -(-TRAINER_SPLITS[0][1] // BUCKET)
        model, train_loader, _, criterion, _ = setup("run_bare")
        state = TrainState.create(model, seed=cfg.seed)
        step = build_train_step(model, criterion, get_optimizer(cfg.optimizer),
                                augment_fn=train_loader.pipeline.device_apply,
                                masked_bn=has_batchnorm(model.module))
        lr0 = get_scheduler(cfg.lr_policy)(0)
        fs0 = backbone_state_factor(cfg.backbone_state_policy, 0)
        t0 = time.perf_counter()
        batches = list(train_loader.epoch(0))
        loader_s = time.perf_counter() - t0
        bare = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            dev = _put_batch(b, DEV)
            state, m = step(state, dev["image"], dev["label"], dev["mask"], lr0, fs0)
            bare.append(m["loss"].float())
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        got = torch.stack([loss for loss, _ in full_steps[:per_epoch]])
        want = torch.stack(bare)
        per_step = SWIN.counts(torch.bfloat16, True)
        per_step = {k: v for k, v in per_step.items() if v}
        steps_ok = all(c == per_step for _, c in full_steps)
        log(f"trainer (b): epoch 1 losses through train() {got.tolist()}, bare steps "
            f"{want.tolist()}, equal: {torch.equal(got, want)}; launches per step "
            f"{full_steps[0][1]} (expect {per_step} every step: {steps_ok}); the run's "
            f"launches {counts}")
        if not torch.equal(got, want) or not steps_ok or len(full_steps) != 2 * per_epoch:
            fail("train() does not step as build_train_step does, or missed a kernel")

        # (e) rates and the idle share of one epoch
        n_valid = TRAINER_SPLITS[0][1]
        rows = read_metrics_csv(os.path.join(TRAINER_DIR, "run_full", "metrics.csv"))
        rates = {"decoder": train_loader.decoder, "loader_img_s": n_valid / loader_s,
                 "bare_step_img_s": n_valid / bare_s,
                 "trainer_img_s": [float(r["train images/sec/chip"]) for r in rows]}
        lr1, fs1 = get_scheduler(cfg.lr_policy)(1), backbone_state_factor(
            cfg.backbone_state_policy, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_epoch(state, train_loader, step, 1, lr1, fs1, progress=False)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        rates["epoch_ms"] = epoch_ms
        try:  # a measurement only: the checks decide the run
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = train_epoch(state, train_loader, step, 1, lr1, fs1, progress=False)
                torch.cuda.synchronize()
            events = report_profile(prof, 1, "in one train epoch (3 steps, loader included)",
                                    epoch_ms, "profile_trainer_epoch.txt")
            if events:
                rates["idle_share"] = 1 - sum(us for us, _ in events) / 1e3 / epoch_ms
        except Exception as e:  # noqa: BLE001
            log(f"profile: not measured ({type(e).__name__}: {e})")
        log(f"trainer (e): {json.dumps(rates)}")
        del model, state, step, batches

        # (c) SIGTERM during batch 0 of epoch 2, then resume
        handler = signal.getsignal(signal.SIGTERM)
        preempt.reset()
        preempt.install()
        try:
            run_train("run_cut", kill_at=per_epoch + 1)
        finally:
            signal.signal(signal.SIGTERM, handler)
            preempt.reset()
        last = os.path.join(TRAINER_DIR, "run_cut", "weights", "last")
        with open(last + ".cursor.json") as f:
            cursor = json.load(f)
        resumed, resumed_steps, _ = run_train("run_resumed", resume_from=last)
        want_sd, got_sd = full.module.state_dict(), resumed.module.state_dict()
        diff = max(max_err(got_sd[k], want_sd[k]) for k in want_sd)
        same = all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
        log(f"trainer (c): cursor {cursor}; the resumed run took {len(resumed_steps)} steps; "
            f"its weights equal the uninterrupted run's: {same} (max |d| {diff:.3e})")
        if cursor.get("epoch") != 1 or cursor.get("batch") != 1 or not same:
            fail("a preempted and resumed run does not end where the uninterrupted one does")
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic
    return counts


# --- phase 8: the shipped configs (SHIPPED) -----------------------------------------

SHIPPED_DIR = os.path.join("build", "shipped_smoke")  # data, configs and runs
SHIPPED_SPLITS = (("train", 200), ("val", 70))  # BMP images, 96-200 px a side
SHIPPED_CLASSES = ["first_class", "second_class"]  # configs/singletask_config.py's
SHIPPED_WORKERS = 6  # the card's machine has 8 cores
STAGE_ITERS = 20  # timed device-stage batches
SHIPPED_RUN = {}  # SHIPPED (a)-(c)'s run directory, configs' edits and results, for EXPORT


def write_annotated_csv(data, seed=0):
    """A seeded annotated CSV (path, fold, label) of BMP files under
    ``data/images``: 2 classes of different mean colour, two thirds of each
    fold in the first (so that the weighted sampler has work to do)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    rows = ["path,fold,label"]
    for fold, n in SHIPPED_SPLITS:
        for i in range(n):
            c = int(i % 3 == 2)
            h, w = (int(v) for v in rng.integers(96, 201, 2))
            tint = np.array([40, -20, -40]) * (1 if c else -1)
            img = np.clip(rng.integers(0, 256, (h, w, 3)) + tint, 0, 255).astype(np.uint8)
            name = f"{fold}_{i}.bmp"
            write_bmp(os.path.join(data, "images", name), img)
            rows.append(f"{name},{fold},{SHIPPED_CLASSES[c]}")
    with open(os.path.join(data, "annotations.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


NO_COMET = "comet_ml is not installed; continuing with local logging only"  # nkbx's warning


def shipped_local_header():
    """The metrics.csv columns that local logging writes for SHIPPED (a)'s
    task and classes without Comet: the trainer's local calls on made-up
    values, in a scratch run directory."""
    from nkbx_torch.logging.experiment import LocalExperiment, log_metrics

    path = os.path.join(SHIPPED_DIR, "local_header")
    os.makedirs(path, exist_ok=True)
    exp = LocalExperiment(path)
    metrics = {"epoch_acc": 0.5, "epoch_roc_auc": 0.5, "epoch_loss": 1.0, "loss": [1.0]}
    for fold in ("train", "Val"):
        log_metrics(exp, None, SHIPPED_CLASSES, 0, metrics, fold)
    exp.log_metric("train images/sec/chip", 1.0, epoch=0)
    with open(os.path.join(path, "metrics.csv")) as f:
        return f.readline().rstrip("\n").split("\t")


def shipped_config(name, edits, path):
    """configs/<name>.py with each (old, new, count) edit made exactly
    ``count`` times, written to ``path``."""
    with open(os.path.join("configs", f"{name}.py")) as f:
        text = f.read()
    for old, new, count in edits:
        if text.count(old) != count:
            fail(f"configs/{name}.py: {old!r} appears {text.count(old)} times, not {count}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def run_cli(module, cfg_path, log_name, env=None):
    """``python -m <module> -cfg <cfg_path>`` in a subprocess; its output
    goes to OUT_DIR/<log_name>; returns (process, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, "-cfg", cfg_path], capture_output=True,
                          text=True, timeout=900, env=env)
    secs = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write(proc.stdout + proc.stderr)
    return proc, secs


# the eval and inference configs' serving bundle (A11) becomes the model rebuilt
# from its name and the run's weights
REBUILT = ('model = {\n    "scripted": True,\n'
           '    "checkpoint": f"{train_run_path}/weights/best.nkbx",\n}',
           'model = {"task": task, "model": "resnet14t",\n'
           '         "checkpoint": f"{train_run_path}/weights/best.pt"}', 1)


def check_shipped_cli():
    """SHIPPED (a)-(c), the user's workflow on the shipped configs, each CLI
    in a subprocess:
    (a) ``python -m nkbx_torch.train`` on configs/singletask_config.py with
        only the data paths, the run directory, n_epochs (2) and num_workers
        changed (resnet14t at 128 px, pretrained, weighted sampling, flips +
        brightness/contrast + HSV + coarse dropout + Normalize, nadam,
        cosine, the freeze policy, batch 64) over a seeded annotated CSV of
        200 + 70 BMP images; NKBX_PRETRAINED_DIR unset, so the pretrained
        warning must appear; the config's Comet section set as its comment
        shows, with a side YAML: the card's machine has no ``comet_ml``, so
        nkbx's warning must appear and the run log locally only; exit 0, its
        files, a metrics.csv with the columns the local logger writes for
        this task without Comet (shipped_local_header), finite metrics;
    (b) ``python -m nkbx_torch.eval`` (configs/eval_config.py, the model
        rebuilt from resnet14t and the run's weights/best.pt): balanced
        accuracy and loss within 1e-6 relative of metrics.csv's row of the
        best epoch;
    (c) ``python -m nkbx_torch.inference`` (configs/inference_config.py, the
        same model) on a flat folder of the val images: a row per image, the
        labels in classes.json and equal to argmax of build_predict_fn over
        the same images in this process.
    Returns the numbers it logged."""
    from nkbx_torch.data import get_inference_dataset
    from nkbx_torch.train import build_predict_fn
    from nkbx_torch.utils import load_config

    shutil.rmtree(SHIPPED_DIR, ignore_errors=True)
    data = os.path.abspath(os.path.join(SHIPPED_DIR, "data"))
    run = os.path.abspath(os.path.join(SHIPPED_DIR, "run"))
    write_annotated_csv(data)
    workers = ('"num_workers": 8', f'"num_workers": {SHIPPED_WORKERS}')
    paths = [('annotations_path = "data/annotations.csv"',
              f'annotations_path = "{data}/annotations.csv"', 1),
             ('image_base_dir = "data/images"', f'image_base_dir = "{data}/images"', 1)]
    comet_yaml = os.path.abspath(os.path.join(SHIPPED_DIR, "comet_api_cfg.yml"))
    with open(comet_yaml, "w") as f:
        f.write("api_key: not-a-key\nworkspace: nkbx\nproject_name: chip-smoke\n")
    comet = ('"comet": {"comet_api_cfg_path": %r, "auto_metric_logging": False, '
             '"name": experiment_name},' % comet_yaml)
    train_cfg = shipped_config("singletask_config", paths + [
        ('"path": f"data/runs/{experiment_name}"', f'"path": "{run}"', 1),
        ('"comet": None,', comet, 1),
        ("n_epochs = 5", "n_epochs = 2", 1), (*workers, 2)],
        os.path.join(SHIPPED_DIR, "singletask.py"))
    env = {k: v for k, v in os.environ.items() if k != "NKBX_PRETRAINED_DIR"}
    out = {}

    # (a) train
    proc, out["train_cli_s"] = run_cli("nkbx_torch.train", train_cfg, "shipped_train.log", env)
    rows = read_metrics_csv(os.path.join(run, "metrics.csv")) if proc.returncode == 0 else []
    have = [n for n in ("classes.json", "metrics.csv", "weights/best.pt", "weights/last.pt",
                        "weights/last") if os.path.exists(os.path.join(run, n))]
    warned = "no converted checkpoint for 'resnet14t'" in proc.stderr
    no_comet = NO_COMET in proc.stderr
    header = list(rows[0]) if rows else []
    local = header == shipped_local_header()
    log(f"shipped (a): python -m nkbx_torch.train on configs/singletask_config.py exit "
        f"{proc.returncode} in {out['train_cli_s']:.1f} s; {have}; metrics.csv rows {len(rows)}; "
        f"the pretrained warning {'appeared' if warned else 'MISSING'}; with its Comet section, "
        f"nkbx's comet_ml warning {'appeared' if no_comet else 'MISSING'}, metrics.csv columns "
        f"{'those' if local else 'NOT those'} of local logging without Comet ({len(header)})")
    out["comet_warning"], out["metrics_columns_local"] = no_comet, local
    if (proc.returncode != 0 or len(have) != 5 or len(rows) != 2 or not warned
            or not no_comet or not local):
        fail(f"the shipped train run failed (log in {OUT_DIR}/shipped_train.log): "
             f"{proc.stderr[-2000:]}")
    shutil.copy(os.path.join(run, "metrics.csv"), os.path.join(OUT_DIR, "shipped_metrics.csv"))
    keys = ("train loss", "Val loss", "Val balanced accuracy", "train images/sec/chip")
    for r in rows:
        log(f"   epoch {r['Epoch']}: " + ", ".join(f"{k} {float(r[k]):.6f}" for k in keys))
        if not all(np.isfinite(float(r[k])) for k in keys):
            fail("the shipped run's metrics are not finite")
    out["train_img_s"] = [float(r["train images/sec/chip"]) for r in rows]
    best, best_acc = None, 0.0
    for r in rows:  # the trainer's rule: the first epoch that beats the best so far
        if float(r["Val balanced accuracy"]) > best_acc:
            best, best_acc = r, float(r["Val balanced accuracy"])
    # EXPORT (5)'s two longest subprocesses need only this run: they start now and
    # run beside the rest of the run until EXPORT collects them
    SHIPPED_RUN.update(run=run, paths=paths, workers=workers)
    SHIPPED_RUN["export_started"] = start_export_shipped()

    # (b) eval and (c) inference, their CLIs at once
    save = os.path.abspath(os.path.join(SHIPPED_DIR, "eval"))
    eval_cfg = shipped_config("eval_config", paths + [
        ('train_run_path = "data/runs/train_singletask_run_1"', f'train_run_path = "{run}"', 1),
        ('save_path = "data/runs/val_singletask_run_1"', f'save_path = "{save}"', 1),
        workers + (1,), REBUILT], os.path.join(SHIPPED_DIR, "eval.py"))
    folder = os.path.abspath(os.path.join(SHIPPED_DIR, "unknown"))
    os.makedirs(folder)
    for name in sorted(os.listdir(os.path.join(data, "images"))):
        if name.startswith("val_"):
            shutil.copy(os.path.join(data, "images", name), folder)
    infer_save = os.path.abspath(os.path.join(SHIPPED_DIR, "infer"))
    infer_cfg = shipped_config("inference_config", [
        ('save_path = "data/runs/infer_singletask_run_1"', f'save_path = "{infer_save}"', 1),
        ('train_run_path = "data/runs/train_singletask_run_1"', f'train_run_path = "{run}"', 1),
        ('"folder_path": "data/unknown_images"', f'"folder_path": "{folder}"', 1),
        workers + (1,), REBUILT], os.path.join(SHIPPED_DIR, "inference.py"))
    t0 = time.perf_counter()
    clis = {"eval": start_cli(["-m", "nkbx_torch.eval", "-cfg", eval_cfg], "shipped_eval.log"),
            "inference": start_cli(["-m", "nkbx_torch.inference", "-cfg", infer_cfg],
                                   "shipped_inference.log")}
    for name, handle in clis.items():
        finish_cli(handle, f"the shipped {name} CLI")
        out[f"{name}_cli_s"] = time.perf_counter() - t0  # from the common start
    with open(os.path.join(save, "metrics.json")) as f:
        metrics = json.load(f)
    d_acc = abs(metrics["epoch_acc"] - float(best["Val balanced accuracy"])) / max(best_acc, 1e-12)
    d_loss = (abs(float(np.mean(metrics["loss"])) - float(best["Val loss"]))
              / abs(float(best["Val loss"])))
    out.update(eval_acc=metrics["epoch_acc"], eval_loss=float(np.mean(metrics["loss"])),
               eval_rel_diff_acc=d_acc, eval_rel_diff_loss=d_loss)
    log(f"shipped (b): python -m nkbx_torch.eval exit 0 in {out['eval_cli_s']:.1f} s on "
        f"weights/best.pt (epoch {best['Epoch']}): balanced accuracy {metrics['epoch_acc']:.8f} "
        f"(metrics.csv {float(best['Val balanced accuracy']):.8f}, rel diff {d_acc:.3e}), loss "
        f"{out['eval_loss']:.8f} (metrics.csv {float(best['Val loss']):.8f}, rel diff "
        f"{d_loss:.3e}); tol 1e-6")
    if d_acc > 1e-6 or d_loss > 1e-6:
        fail("the eval CLI does not reproduce the trainer's validation of the best epoch")

    # (c) inference
    with open(os.path.join(infer_save, "inference_annotations.csv")) as f:
        head, *lines = [line.rstrip("\n").split(",") for line in f]
    with open(os.path.join(run, "classes.json")) as f:
        classes = json.load(f)
    cfg = load_config(infer_cfg)
    model = get_model(cfg.model, classes, input_size=(cfg.img_size, cfg.img_size),
                      dtype=torch.bfloat16)
    loader = get_inference_dataset(cfg.inference_data, cfg.inference_pipeline)
    predict = build_predict_fn(model, augment_fn=loader.pipeline.device_apply)
    want = {}
    for batch in loader.epoch(0):
        pred = predict(torch.from_numpy(batch["image"]).to(DEV)).argmax(-1).cpu().numpy()
        want.update({p: classes[int(i)] for p, i, v in zip(batch["path"], pred, batch["mask"])
                     if v})
    got = {p: label for label, p in lines}
    n_val = SHIPPED_SPLITS[1][1]
    ok = (head == ["label", "path"] and len(lines) == n_val and got == want
          and all(label in classes for label in got.values()))
    counts = {c: list(got.values()).count(c) for c in classes}
    out["inference_rows"], out["inference_labels"] = len(lines), counts
    log(f"shipped (c): python -m nkbx_torch.inference exit 0 in {out['inference_cli_s']:.1f} s: "
        f"{len(lines)} rows for {n_val} images, columns {head}, labels {counts}; equal to "
        f"argmax of build_predict_fn over the same images: {got == want}")
    if not ok:
        fail("the inference CLI's annotations do not match the model's predictions")
    SHIPPED_RUN.update(folder=folder, out=out, labels=got)
    return out


def check_device_stage():
    """SHIPPED (d): configs/singletask_config.py's device stage on a CUDA
    uint8 batch of 64 at 128 px with fixed draws (from a CPU generator),
    against the CPU with the same draws: the random ops alone within 1e-3 on
    the 0-255 scale, the whole stage (Normalize included) within 1e-5; then
    the stage's ms a batch in bf16 with its own draws from a CUDA generator
    (CUDA events), and a profile of one batch: device busy ms and launches
    (a measurement only)."""
    from nkbx_torch.transforms.device import build_device_fn
    from nkbx_torch.utils import load_config

    pipe = load_config(os.path.join("configs", "singletask_config.py")).train_pipeline
    stage = pipe.device_stage()
    ops = build_device_fn([t for t in pipe.device_transforms if type(t).__name__ != "Normalize"])
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (BUCKET, 128, 128, 3),
                                                           dtype=np.uint8))
    draws = stage.draw(tuple(x.shape), torch.Generator().manual_seed(3))
    on_card = [{k: v.to(DEV) for k, v in d.items()} for d in draws]
    xd = x.to(DEV)
    raw = max_err(ops(xd, draws=on_card).cpu(), ops(x, draws=draws))
    full = max_err(stage(xd, draws=on_card).cpu(), stage(x, draws=draws))
    gen = torch.Generator(device=DEV).manual_seed(0)
    ms = cuda_ms(lambda: stage(xd, torch.bfloat16, generator=gen), iters=STAGE_ITERS)
    out = {"max_abs_err_0_255": raw, "max_abs_err_normalized": full, "ms_per_batch": ms,
           "gates": [int(d["gate"].sum()) for d in draws]}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage(xd, torch.bfloat16, generator=gen)
        torch.cuda.synchronize()
    events = report_profile(prof, 1, f"in one device-stage batch of {BUCKET} at 128 px", ms,
                            "profile_device_stage.txt")
    out["device_busy_ms"] = sum(us for us, _ in events) / 1e3 if events else None
    out["launches"] = sum(e.count for _, e in events)
    log(f"shipped (d): the singletask device stage, batch {BUCKET} at 128 px, card against CPU "
        f"with the same draws: before Normalize max|d| {raw:.3e} (tol 1e-3), after {full:.3e} "
        f"(tol 1e-5); {ms:.4f} ms a batch in bf16 with its own draws; gates {out['gates']}")
    if not raw <= 1e-3 or not full <= 1e-5:
        fail("the device stage on the card disagrees with the CPU")
    return out


SHIPPED_STEPS = 5
ZOO_STEPS = 5  # timed densenet121 steps after one warm-up step


def shipped_model_check(name, cfg, classes, size):
    """SHIPPED (e) for one shipped config at its image size, batch 64: bf16
    against f32 logits (5% of the largest f32 logit), 5 steps of
    build_train_step with the config's pipeline, optimizer, lr policy,
    freeze policy and criterion (2 at epoch 0, 3 at the policy's first
    unfreeze), finite losses, step img/s and peak memory, a profile of one
    step (device time, idle share, time by kind of kernel); a bucket-64
    ServingModule forward and its img/s."""
    from nkbx_torch.export import ServingModule
    from nkbx_torch.train import (TrainState, backbone_state_factor, build_train_step, get_loss,
                                  get_optimizer, get_scheduler)

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8),
                        device=DEV)
    if isinstance(classes, dict):
        label = {t: torch.as_tensor(rng.integers(0, len(c), BUCKET), device=DEV)
                 for t, c in sorted(classes.items())}
    else:
        label = torch.as_tensor(rng.integers(0, len(classes), BUCKET), device=DEV)
    mask = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = get_model(cfg.model, classes, input_size=(size, size), seed=0, dtype=dtype)
        with torch.no_grad():
            out = model(cfg.val_pipeline.device_apply(x, out_dtype=dtype))
        logits[dtype] = out if isinstance(out, dict) else {"": out}
    rel = max(max_err(logits[torch.bfloat16][t], logits[torch.float32][t])
              / logits[torch.float32][t].abs().max().item() for t in logits[torch.float32])
    policy = cfg.backbone_state_policy
    unfreeze = min(e for e, s in policy.items() if s == "unfreeze")
    epochs = [0] * 2 + [unfreeze] * (SHIPPED_STEPS - 2)
    schedule = get_scheduler(cfg.lr_policy)
    state = TrainState.create(model, seed=0)
    step = build_train_step(model, get_loss(cfg.criterion), get_optimizer(cfg.optimizer),
                            augment_fn=cfg.train_pipeline.device_apply)
    state, _ = step(state, x, label, mask, schedule(0), backbone_state_factor(policy, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for e in epochs:
        state, metrics = step(state, x, label, mask, schedule(e), backbone_state_factor(policy, e))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SHIPPED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [float(v) for v in losses]
    lr, scale = schedule(unfreeze), backbone_state_factor(policy, unfreeze)
    profiled = profile_step(lambda st: step(st, x, label, mask, lr, scale), state,
                            f"shipped_{name}", BUCKET, step_ms)
    serving = ServingModule(model, buckets=(1, 8, BUCKET))
    served = serving.forward(x)
    served = served if isinstance(served, dict) else {"": served}
    shapes_ok = all(v.shape == (BUCKET, len(classes[t] if t else classes))
                    and torch.isfinite(v).all() for t, v in served.items())
    bench = serving.benchmark(BUCKET, iters=20)
    r = {"model": cfg.model["model"], "img_size": size, "losses": losses,
         "bf16_vs_f32": rel, "step_ms": step_ms, "step_img_s": BUCKET / step_ms * 1e3,
         "peak_mb": peak, "serve_pipelined_img_s": bench["pipelined_images_per_sec"],
         "serve_p50_ms": bench["p50_ms"], "profile": profiled}
    log(f"shipped (e) {name}: {json.dumps(r)}")
    if rel > 5e-2 or not all(np.isfinite(losses)) or not shapes_ok:
        fail(f"shipped {name}: bf16 logits off f32, a loss not finite or a bad serving output")
    return r


def check_shipped_models():
    """SHIPPED (e): configs/multitask_config.py (efficientnet_b0, 224 px, two
    targets, cross-entropy) and configs/yolo_crops_config.py
    (mobilenetv3_large_100, 128 px, FocalLoss) through
    shipped_model_check; mobilenetv3_small_100 and efficientnetv2_s one
    bf16 forward each against f32 (5% of the largest f32 logit). The
    yolo_crops train CLI runs from SHIPPED on (start_export_shipped)."""
    from nkbx_torch.utils import load_config

    out = {}
    multi = load_config(os.path.join("configs", "multitask_config.py"))
    out["multitask"] = shipped_model_check("multitask_config", multi, multi.classes,
                                           multi.img_size)
    yolo = load_config(os.path.join("configs", "yolo_crops_config.py"))
    out["yolo_crops"] = shipped_model_check("yolo_crops_config", yolo,
                                            ["cat", "dog", "<GENERATED>_background"],
                                            yolo.img_size)
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (8, 224, 224, 3),
                                                          dtype=np.uint8), device=DEV)
    for name in ("mobilenetv3_small_100", "efficientnetv2_s"):
        got = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = get_model({"model": name}, SHIPPED_CLASSES, seed=0, dtype=dtype)
            with torch.no_grad():
                got[dtype] = model(multi.val_pipeline.device_apply(x, out_dtype=dtype))
        rel = max_err(got[torch.bfloat16], got[torch.float32]) / got[torch.float32].abs().max()
        out[name] = float(rel)
        log(f"shipped (e) {name}: one forward of 8 at 224 px, bf16 against f32 "
            f"{float(rel):.3e} (tol 5e-2)")
        if not rel <= 5e-2:
            fail(f"{name}: bf16 logits off f32")
    return out


def check_shipped():
    """SHIPPED, the shipped configs' path: (a)-(c) check_shipped_cli, (d)
    check_device_stage, (e) check_shipped_models. No kernel of ours runs on
    it: the counts, zeroed before and read after the in-process phases,
    stay 0 (the CLIs' subprocesses have counts of their own)."""
    zero_counts()
    out = check_shipped_cli()
    out["device_stage"] = check_device_stage()
    out.update(check_shipped_models())
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        fail(f"the shipped path launched port kernels it should not: {counts}")
    log(f"shipped: {json.dumps(out)}")
    return counts


# --- phases 9-10: the rest of the zoo, and pos_embed resampled on load ----------------

ZOO_CLASSES = [f"class{i}" for i in range(10)]
ZOO_FORWARD = 8  # images of a one-forward check


def zoo_models(name, opts=None, size=224):
    """The model ``name`` in f32 and in bf16 (random weights from seed 0, 10
    classes): {dtype: ClassificationModel}."""
    cfg = {"model": name, "backbone_opts": opts or {}}
    return {dtype: get_model(cfg, ZOO_CLASSES, input_size=(size, size), seed=0, dtype=dtype)
            for dtype in (torch.float32, torch.bfloat16)}


def bf16_against_f32(models, x, pipe):
    """Logits of both dtypes on ``x``: (bf16 logits, max|bf16 - f32| / max|f32|)."""
    with torch.no_grad():
        got = {dt: m(pipe.device_apply(x, out_dtype=dt)) for dt, m in models.items()}
    lo, hi = got[torch.bfloat16], got[torch.float32]
    return lo, max_err(lo, hi) / float(hi.abs().max())


def check_zoo():
    """ZOO: densenet121 at 224 px, batch 64, bf16: logits against f32 (5% of
    the largest), 1 + 5 build_train_step steps on a repeated seeded batch
    (check_train's nadam recipe, Normalize) with finite and falling losses,
    step img/s and peak memory over the last 5, a profile of one step, a
    bucket-64 ServingModule forward and its img/s; densenet169, densenet201
    and unicom ViT-B/32 one forward of 8 each, bf16 against f32. No kernel of
    ours runs there: the counts, zeroed before, stay 0. Then unicom ViT-L/14
    with fused_attention and fused_mlp: the MLP lowering the shared-memory
    gate takes at C = 1024 in each dtype, one forward of 8 in f32 and in bf16
    (counts: K3 24 a forward, K5 or K7 24 as the gate says), bf16 against
    f32 and against the plain versions (5% of the largest)."""
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, Normalize

    pipe = Compose([Normalize()])
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8), device=DEV)
    labels = torch.as_tensor(rng.integers(0, 10, BUCKET), device=DEV)
    mask = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    set_plain(False)
    zero_counts()
    models = zoo_models("densenet121")
    _, rel = bf16_against_f32(models, x, pipe)
    model = models[torch.bfloat16]
    del models
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer({"type": "nadam", "backbone_lr": 1e-5,
                                           "classifier_lr": 1e-4, "weight_decay": 0.05}),
                            augment_fn=pipe.device_apply)
    state = TrainState.create(model, seed=0)

    def run(st):
        return step(st, x, labels, mask, 1.0, 1.0)

    state, metrics = run(state)
    losses = [metrics["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        state, metrics = run(state)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [float(v) for v in losses]
    profiled = profile_step(run, state, "zoo_densenet121", BUCKET, step_ms)
    serving = ServingModule(model, buckets=(1, 8, BUCKET))
    served = serving.forward(x)
    bench = serving.benchmark(BUCKET, iters=20)
    r = {"densenet121": {
        "img_size": 224, "losses": losses, "bf16_vs_f32": rel, "step_ms": step_ms,
        "step_img_s": BUCKET / step_ms * 1e3, "peak_mb": peak,
        "serve_pipelined_img_s": bench["pipelined_images_per_sec"],
        "serve_p50_ms": bench["p50_ms"], "profile": profiled}}
    log(f"zoo densenet121: {json.dumps(r['densenet121'])}")
    if (rel > 5e-2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or tuple(served.shape) != (BUCKET, 10) or not torch.isfinite(served).all()):
        fail("zoo densenet121: bf16 logits off f32, a loss not finite or not falling, or a bad "
             "serving output")
    del model, state, step, serving
    for name in ("densenet169", "densenet201", "unicom ViT-B/32"):
        _, rel = bf16_against_f32(zoo_models(name), x[:ZOO_FORWARD], pipe)
        r[name] = {"bf16_vs_f32": rel}
        log(f"zoo {name}: one forward of {ZOO_FORWARD} at 224 px, bf16 against f32 {rel:.3e} "
            "(tol 5e-2)")
        if not rel <= 5e-2:
            fail(f"zoo {name}: bf16 logits off f32")
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        fail(f"the zoo's densenets and unicom ViT-B/32 launched port kernels: {counts}")

    modes = {DTYPE_NAME[dt]: M.fused_mlp_mode(True, torch.empty(1, 1024, dtype=dt, device=DEV),
                                              4096, auto=False)
             for dt in (torch.float32, torch.bfloat16)}
    models = zoo_models("unicom ViT-L/14", {"fused_attention": True, "fused_mlp": True})
    zero_counts()
    got, rel = bf16_against_f32(models, x[:ZOO_FORWARD], pipe)
    torch.cuda.synchronize()
    counts = read_counts()
    set_plain(True)
    with torch.no_grad():
        plain = models[torch.bfloat16](pipe.device_apply(x[:ZOO_FORWARD],
                                                         out_dtype=torch.bfloat16))
    set_plain(False)
    rel_plain = max_err(got, plain) / float(plain.abs().max())
    want = dict.fromkeys(COUNTED, 0)
    want["attention"] = 2 * 24
    for mode in modes.values():
        if mode:
            want["ln_mlp" if mode == "ln" else "mlp"] += 24
    r["unicom ViT-L/14"] = {"mlp_lowering": modes, "launches": counts, "bf16_vs_f32": rel,
                            "bf16_kernels_vs_plain": rel_plain}
    log(f"zoo unicom ViT-L/14 (fused flags): the gate's MLP lowering at C = 1024: {modes} "
        f"('ln' K5/K6, 'mlp' K7/K8, None plain); one forward of {ZOO_FORWARD} in f32 and in "
        f"bf16: launches {counts} (expect {want}); bf16 against f32 {rel:.3e}, against the "
        f"plain versions {rel_plain:.3e} (tol 5e-2)")
    if counts != want or not rel <= 5e-2 or not rel_plain <= 5e-2:
        fail("zoo unicom ViT-L/14: the kernels did not run as the gate says, or its bf16 logits "
             "disagree")
    del models
    return r, counts


VIT_B = 768  # vit_base_patch16's width, 12 blocks, patch 16


def timm_vit_state_dict(gen, depth=12, patch=16, tokens=197):
    """A seeded timm-layout vit_base_patch16_224 state dict (what a user's
    timm file holds): LayerNorm weights 1, every other tensor normal(0.02),
    timm's init scale."""
    d = VIT_B
    shapes = {"cls_token": (1, 1, d), "pos_embed": (1, tokens, d),
              "patch_embed.proj.weight": (d, 3, patch, patch), "patch_embed.proj.bias": (d,)}
    for i in range(depth):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (d,), f"{b}.norm1.bias": (d,),
                       f"{b}.attn.qkv.weight": (3 * d, d), f"{b}.attn.qkv.bias": (3 * d,),
                       f"{b}.attn.proj.weight": (d, d), f"{b}.attn.proj.bias": (d,),
                       f"{b}.norm2.weight": (d,), f"{b}.norm2.bias": (d,),
                       f"{b}.mlp.fc1.weight": (4 * d, d), f"{b}.mlp.fc1.bias": (4 * d,),
                       f"{b}.mlp.fc2.weight": (d, 4 * d), f"{b}.mlp.fc2.bias": (d,)})
    shapes.update({"norm.weight": (d,), "norm.bias": (d,)})
    return {k: torch.ones(s) if "norm" in k and k.endswith("weight")
            else 0.02 * torch.randn(s, generator=gen) for k, s in shapes.items()}


RESAMPLE_DIR = os.path.join("build", "resample_smoke")  # the timm file and NKBX_PRETRAINED_DIR


def check_resample():
    """RESAMPLE: a seeded timm-layout vit_base_patch16_224 file through the
    converter's CLI (``python -m nkbx_torch.models.convert``, a subprocess)
    into a temporary $NKBX_PRETRAINED_DIR as vit_base_patch16_384.msgpack;
    ``get_model`` of vit_base_patch16_384 at 384 px with ``pretrained`` and
    fused_attention, bf16: its pos_embed resampled 197 -> 577 equal to the
    same resample on the CPU, a block's weights equal to the file's; a
    bucket-64 ServingModule forward through K3 at N = 577 (12 launches, no
    other kernel), held against the plain versions (5% of the largest), and
    its img/s."""
    from nkbx_torch.models.convert import resample_pos_embed

    shutil.rmtree(RESAMPLE_DIR, ignore_errors=True)
    pre = os.path.join(RESAMPLE_DIR, "pretrained")
    os.makedirs(pre)
    sd = timm_vit_state_dict(torch.Generator().manual_seed(0))
    weights = os.path.join(RESAMPLE_DIR, "vit_base_patch16_224.pth")
    torch.save(sd, weights)
    target = os.path.join(pre, "vit_base_patch16_384.msgpack")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.models.convert", "--model",
                           "vit_base_patch16_224", "--weights", weights, "--out", target],
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    log(f"resample: the converter CLI exit {proc.returncode} in {cli_s:.1f} s: "
        f"{proc.stdout.strip()[-200:]} {proc.stderr.strip()[-400:]}")
    if proc.returncode != 0 or not os.path.exists(target):
        fail("the converter CLI did not write the pretrained file")
    saved = os.environ.get("NKBX_PRETRAINED_DIR")
    os.environ["NKBX_PRETRAINED_DIR"] = pre
    try:
        model = get_model({"model": "vit_base_patch16_384", "pretrained": True,
                           "backbone_opts": {"fused_attention": True}}, ZOO_CLASSES,
                          input_size=(384, 384), seed=0, dtype=torch.bfloat16)
    finally:
        if saved is None:
            os.environ.pop("NKBX_PRETRAINED_DIR")
        else:
            os.environ["NKBX_PRETRAINED_DIR"] = saved
    bb = model.module.backbone
    pos = bb.pos_embed.detach().cpu()
    query = bb.TransformerBlock_0.MultiHeadDotProductAttention_0.query.weight.detach().cpu()
    same_pos = tuple(pos.shape) == (1, 577, VIT_B) and torch.equal(
        pos, resample_pos_embed(sd["pos_embed"], 577))
    same_block = torch.equal(query, sd["blocks.0.attn.qkv.weight"][:VIT_B])
    log(f"resample: pos_embed {tuple(pos.shape)} equal to the CPU resample of the file's "
        f"(1, 197, 768): {same_pos}; block 0's query weight equal to the file's: {same_block}")
    if not (same_pos and same_block):
        fail("the 224-grid file did not load into the 384 ViT as resampled")
    serving = ServingModule(model, buckets=(BUCKET,), warm_up_on_load=False)
    x = np.random.default_rng(4).integers(0, 256, (BUCKET, 384, 384, 3), dtype=np.uint8)
    set_plain(False)
    zero_counts()
    out = serve_all(serving, [x])[0]
    counts = read_counts()
    set_plain(True)
    plain = serve_all(serving, [x])[0]
    set_plain(False)
    rel = max_err(out, plain) / float(plain.abs().max())
    want = dict.fromkeys(COUNTED, 0)
    want["attention"] = 12
    bench = serving.benchmark(BUCKET, iters=10)
    r = {"cli_s": cli_s, "launches": counts, "kernels_vs_plain": rel,
         "serve_pipelined_img_s": bench["pipelined_images_per_sec"],
         "serve_p50_ms": bench["p50_ms"], "compute_p50_ms": bench["compute_p50_ms"]}
    log(f"resample: bucket-64 forward at 384 px, launches {counts} (expect {want}), bf16 "
        f"against the plain versions {rel:.3e} (tol 5e-2); {json.dumps(r)}")
    if counts != want or not rel <= 5e-2 or not torch.isfinite(out).all():
        fail("the resampled ViT's forward did not go through K3 at N = 577 or disagrees")
    return r, counts


# --- phase 11: the modern recipe (MODERN) ------------------------------------------------

MODERN_DIR = os.path.join("build", "modern_smoke")  # data, configs and runs
MODERN_CONFIG = os.path.join("configs", "modern_recipe_config.py")
MODERN_BATCH = 128  # the recipe's batch
MODERN_CHECK_ROWS = 32  # rows of MODERN (a)'s card-against-CPU check: every op drawn
MODERN_K = 20  # the recipe's steps_per_dispatch
# 25 full batches (a call of 20 and a shorter one of 5) and a padded val batch
MODERN_SPLITS = (("train", 25 * MODERN_BATCH), ("val", 2 * MODERN_BATCH + 17))
MODERN_WORKERS = 6  # the card's machine has 8 cores
A4_STEPS = 3


def check_modern_stage(cfg):
    """MODERN (a): the recipe's device stage (RandAugment num_ops = 2,
    magnitude 9, 4 affine grids, then Normalize) on a CUDA uint8 batch of
    MODERN_CHECK_ROWS at 224 px with fixed draws (from a CPU generator; every
    op of the policy drawn) against the CPU with the same draws, and
    TrivialAugmentWide (4 grids) the same way: each
    round from the same input (the CPU's output of the round before) within
    1e-3 on the 0-255 scale, the samples on identity, a warp, posterize,
    solarize or equalize equal, leaving out the pixels whose source
    coordinate lies within 1e-4 of a .5 tie (counted); the card's whole
    stage equal to its own rounds, gate and Normalize, and its share of
    values off the CPU's whole stage logged (a tie in round 1 moves round 2's
    global ops: not held); a second run on the card bit-identical; then the
    stage's ms a batch in bf16 with its own draws from a CUDA generator (CUDA
    events) and a profile of one batch of MODERN_BATCH (device ms,
    launches)."""
    from nkbx_torch.transforms import device as D
    from nkbx_torch.transforms import spec as S

    pipe = cfg.train_pipeline
    (ra,) = [t for t in pipe.device_transforms if isinstance(t, S.RandAugment)]
    norm = pipe.device_transforms[-1]
    std = 255.0 * min(norm.std)
    full = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (MODERN_BATCH, 224, 224, 3), dtype=np.uint8)).to(DEV)  # the timed batch
    x = full[:MODERN_CHECK_ROWS].cpu()  # the checked rows
    xd = x.to(DEV)
    out = {}
    for name, t in (("randaugment", ra), ("trivialaugment",
                                          S.TrivialAugmentWide(num_affine_grids=ra.num_affine_grids))):
        stage = pipe.device_stage() if t is ra else S.Compose([t, norm]).device_stage()
        (d,) = stage.draw(tuple(x.shape), torch.Generator().manual_seed(3))
        if torch.bincount(d["op"].flatten(), minlength=14).min() == 0:
            fail(f"modern (a): the {name} draws of {MODERN_CHECK_ROWS} rows miss an op")
        dc = {k: v.to(DEV) for k, v in d.items()}
        xr, errs, ties, equal = x.float(), [], 0, True
        for r in range(d["op"].shape[0]):
            point, grids = D.policy_magnitudes(t, d, r, 224, 224)
            point_c, grids_c = D.policy_magnitudes(t, dc, r, 224, 224)
            want = D.policy_round(xr, d["op"][r], d["grid"][r], point, grids)
            got = D.policy_round(xr.to(DEV), dc["op"][r], dc["grid"][r], point_c,
                                 grids_c).cpu()
            tie = D.policy_ties(t, d, r, 224, 224)
            keep = ~tie[..., None]
            ties += int(tie.sum())
            errs.append(max_err(got * keep, want * keep))
            exact = torch.isin(d["op"][r], torch.tensor(D.EXACT_OPS))
            equal &= torch.equal((got * keep)[exact], (want * keep)[exact])
            xr = want
        got = stage(xd, draws=[dc])
        m, sd = (torch.as_tensor(v, device=DEV) for v in (stage.mean, stage.std))
        composed = torch.equal(got, (D._apply_policy(t, xd.float(), dc) - m) / sd)
        far = (got.cpu() - stage(x, draws=[d])).abs() > 1e-3 / std
        whole = float(far.float().mean())
        again = torch.equal(got, stage(xd, draws=[dc]))
        gen = torch.Generator(device=DEV).manual_seed(0)
        ms = cuda_ms(lambda: stage(full, torch.bfloat16, generator=gen), iters=STAGE_ITERS)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage(full, torch.bfloat16, generator=gen)
            torch.cuda.synchronize()
        events = report_profile(prof, 1, f"in one {name} device-stage batch of {MODERN_BATCH} "
                                f"at 224 px", ms, f"profile_modern_stage_{name}.txt")
        out[name] = {"max_abs_err_0_255_by_round": errs, "tie_pixels": ties,
                     "exact_ops_equal": equal, "stage_is_the_rounds": composed,
                     "whole_share_over_tol": whole, "rerun_identical": again,
                     "ms_per_batch": ms,
                     "device_busy_ms": device_ms(events, 1) if events else None,
                     "launches": sum(e.count for _, e in events),
                     "ops_drawn": torch.bincount(d["op"].flatten(), minlength=14).tolist()}
        log(f"modern (a) {name}: card against CPU with the same draws, by round max|d| "
            f"{[f'{e:.3e}' for e in errs]} (tol 1e-3), exact ops equal {equal}, {ties} tie "
            f"pixels left out; the card's stage equal to its rounds, gate and Normalize "
            f"{composed}; whole stage against the CPU's: a share {whole:.2e} of values beyond "
            f"{1e-3 / std:.2e} (what a tie moves in a later round; not held); rerun identical "
            f"{again}; {ms:.4f} ms a batch in bf16 with its own draws")
        if max(errs) > 1e-3 or not equal or not again or not composed:
            fail(f"modern (a): the {name} device stage on the card disagrees with the CPU")
    return out


def modern_train_step(cfg, model, scan):
    """The recipe's train step for ``model`` as the trainer builds it:
    criterion, optimizer, device stage, mixup, EMA; ``scan`` steps a call."""
    import warnings

    from nkbx_torch.train import build_train_step, get_loss, get_optimizer

    with warnings.catch_warnings():  # the mixup_alpha warning is held in MODERN (c)
        warnings.simplefilter("ignore")
        return build_train_step(model, get_loss(cfg.criterion, device=DEV),
                                get_optimizer(cfg.optimizer),
                                augment_fn=cfg.train_pipeline.device_apply, scan_steps=scan,
                                ema_decay=cfg.model_ema_decay, mixup=cfg.mixup)


def modern_step_parts(cfg, dtype, scan, seed=0):
    """The recipe's model (random weights from seed 0, 10 classes; with
    ``pretrained`` and no converted file it warns and keeps them), its state
    with the EMA shadow, and its step: (model, state, step)."""
    import warnings

    from nkbx_torch.train import TrainState

    with warnings.catch_warnings():  # the pretrained warning is held in MODERN (c)
        warnings.simplefilter("ignore")
        model = get_model(cfg.model, [f"class{i}" for i in range(N_CLASSES)], seed=0,
                          dtype=dtype)
    return model, TrainState.create(model, seed=seed, ema=True), modern_train_step(cfg, model,
                                                                                   scan)


def check_modern_step(cfg):
    """MODERN (b), the bare step of the recipe: resnet50 at 224 px, batch
    128, bf16 over f32 masters, exact BatchNorm, RandAugment + Normalize on
    the card, CutMix (the config's ``mixup_alpha`` is ignored, as nkbx
    ignores it) at prob 0.5, cross-entropy with label smoothing 0.1, sgd at
    lr 0.5, EMA 0.9998, ``scan_steps=20``. One call on 20 stacked seeded
    batches: finite losses, metrics of shape (20, ...), an EMA shadow that
    moved and differs from the weights; then, warm, one timed 20-step call
    (host clock, synchronised) against 20 single calls, img/s each, the peak
    memory of the 20-step call, a profile of one single step (device ms by
    kind of kernel, idle share; the 20-step call's idle share against that
    step's device ms),
    and the device stage, the mixup and the EMA update alone on CUDA events.
    In f32 (TF32 off, cuDNN deterministic for this check): 3 steps in one
    call against 3 single calls from the same weights and generator seed:
    losses within 1e-6 relative and every tensor of the state dict within
    1e-6 of its largest value (bit-identical expected and reported)."""
    from nkbx_torch.train.mixup import Mixup

    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (MODERN_K, MODERN_BATCH, 224, 224, 3),
                                          dtype=np.uint8), device=DEV)
    labels = torch.as_tensor(rng.integers(0, N_CLASSES, (MODERN_K, MODERN_BATCH)), device=DEV)
    masks = torch.ones((MODERN_K, MODERN_BATCH), dtype=torch.bool, device=DEV)
    model, state, step = modern_step_parts(cfg, torch.bfloat16, MODERN_K)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    state, m = step(state, images, labels, masks, 1.0, 1.0)
    losses = m["loss"].float().cpu().numpy()
    shadow, live = state.ema_module.state_dict(), model.module.state_dict()
    moved = sum(not torch.equal(shadow[k], init[k]) for k in shadow)
    apart = sum(not torch.equal(shadow[k], live[k]) for k in shadow)
    shapes = {k: tuple(m[k].shape) for k in ("loss", "confidences", "predictions", "mask")}
    log(f"modern (b): one call of {MODERN_K} steps, batch {MODERN_BATCH}, bf16: losses "
        f"{[round(float(v), 4) for v in losses]}; metric shapes {shapes}; the EMA shadow moved "
        f"in {moved} and differs from the weights in {apart} of {len(shadow)} tensors")
    if (not np.isfinite(losses).all() or shapes["loss"] != (MODERN_K,)
            or shapes["confidences"] != (MODERN_K, MODERN_BATCH, N_CLASSES) or not moved
            or not apart):
        fail("modern (b): the 20-step call's losses, metrics or EMA are wrong")
    out = {"losses": losses.tolist()}
    # warm: a timed 20-step call against 20 single calls of the same state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, images, labels, masks, 1.0, 1.0)
    torch.cuda.synchronize()
    ms20 = (time.perf_counter() - t0) * 1e3
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    single = modern_train_step(cfg, model, 1)
    state, _ = single(state, images[0], labels[0], masks[0], 1.0, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(MODERN_K):
        state, m1 = single(state, images[k], labels[k], masks[k], 1.0, 1.0)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    out.update(call20_ms=ms20, singles20_ms=ms1,
               img_s_call20=MODERN_K * MODERN_BATCH / ms20 * 1e3,
               img_s_singles=MODERN_K * MODERN_BATCH / ms1 * 1e3)
    out["profile_step"] = profile_step(
        lambda st: single(st, images[0], labels[0], masks[0], 1.0, 1.0), state, "resnet50_modern",
        MODERN_BATCH, ms1 / MODERN_K)
    # the call's steps launch the single step's kernels (mixup's draw moves a few), so
    # its idle share takes that step's device ms: a profile of the whole call took a
    # minute of host time to read
    out["idle_share_call20"] = 1 - out["profile_step"]["device_ms"] / (ms20 / MODERN_K)
    x = cfg.train_pipeline.device_apply(images[0], torch.bfloat16)
    mix = Mixup({k: v for k, v in cfg.mixup.items() if k != "mixup_alpha"})
    gen = torch.Generator(device=DEV).manual_seed(1)
    out["device_stage_ms"] = cuda_ms(lambda: cfg.train_pipeline.device_apply(
        images[0], torch.bfloat16, generator=gen), iters=STAGE_ITERS)
    out["mixup_ms"] = cuda_ms(lambda: mix(x, masks[0], generator=gen), iters=STAGE_ITERS)
    out["ema_ms"] = cuda_ms(lambda: state.update_ema(cfg.model_ema_decay), iters=STAGE_ITERS)
    log(f"modern (b): one {MODERN_K}-step call {ms20:.1f} ms ({out['img_s_call20']:.1f} img/s) "
        f"against {MODERN_K} single calls {ms1:.1f} ms ({out['img_s_singles']:.1f} img/s); idle "
        f"share {out['idle_share_call20']} (one call) and {out['profile_step']['idle_share']:.3f} "
        f"(a single step); peak {out['peak_mb']:.1f} MB; the device stage "
        f"{out['device_stage_ms']:.3f} ms, the mixup {out['mixup_ms']:.3f} ms, the EMA "
        f"{out['ema_ms']:.3f} ms a step (CUDA events)")
    del model, state, step, single, images
    torch.cuda.empty_cache()

    # f32: 3 steps in one call against 3 single calls with the same draws
    torch.backends.cudnn.deterministic, bench = True, torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        small = torch.as_tensor(rng.integers(0, 256, (3, MODERN_BATCH, 224, 224, 3),
                                             dtype=np.uint8), device=DEV)
        runs = []
        for scan in (3, 1):
            model, state, step = modern_step_parts(cfg, torch.float32, scan, seed=5)
            if scan == 3:
                state, m = step(state, small, labels[:3], masks[:3], 1.0, 1.0)
                loss = m["loss"]
            else:
                loss = []
                for k in range(3):
                    state, m = step(state, small[k], labels[k], masks[k], 1.0, 1.0)
                    loss.append(m["loss"])
                loss = torch.stack(loss)
            runs.append((loss.cpu(), {k: v.clone() for k, v in model.module.state_dict().items()},
                         {k: v.clone() for k, v in state.ema_module.state_dict().items()}))
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, bench
    (l3, sd3, ema3), (l1, sd1, ema1) = runs
    loss_rel = float(((l3 - l1).abs() / l1.abs()).max())
    worst = max(float((sd3[k].float() - sd1[k].float()).abs().max())
                / max(float(sd1[k].float().abs().max()), 1e-30)
                for k in sd3 if sd3[k].is_floating_point())
    identical = (torch.equal(l3, l1) and all(torch.equal(sd3[k], sd1[k]) for k in sd3)
                 and all(torch.equal(ema3[k], ema1[k]) for k in ema3))
    out.update(f32_loss_rel=loss_rel, f32_state_rel=worst, f32_identical=identical)
    log(f"modern (b): f32, 3 steps in one call against 3 single calls: losses "
        f"{l3.tolist()} / {l1.tolist()}, max rel {loss_rel:.3e} (tol 1e-6); state max |d| over "
        f"each tensor's largest {worst:.3e} (tol 1e-6); bit-identical {identical}")
    if not loss_rel <= 1e-6 or not worst <= 1e-6 or not np.isfinite(l3.numpy()).all():
        fail("modern (b): the f32 3-step call disagrees with 3 single calls")
    return out


def write_modern_folder(root, seed=0):
    """A seeded ImageFolder of uint8 BMP files, 48-112 px a side, 10 classes
    of different mean colour (the host stage resizes them to 224)."""
    rng = np.random.default_rng(seed)
    for split, n in MODERN_SPLITS:
        for i in range(n):
            c = i % N_CLASSES
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            h, w = (int(v) for v in rng.integers(48, 113, 2))
            tint = np.array([(c * 37) % 96, (c * 59) % 96, (c * 83) % 96]) - 48
            img = np.clip(rng.integers(0, 256, (h, w, 3)) + tint, 0, 255).astype(np.uint8)
            write_bmp(os.path.join(d, f"{i}.bmp"), img)


def start_modern_cli():
    """MODERN (c)'s data, config and train CLI, started in a subprocess
    (check_modern_cli holds it); returns (its handle, start, run directory,
    data directory)."""
    shutil.rmtree(MODERN_DIR, ignore_errors=True)
    data = os.path.abspath(os.path.join(MODERN_DIR, "data"))
    run = os.path.abspath(os.path.join(MODERN_DIR, "run"))
    write_modern_folder(data)
    cfg_path = shipped_config("modern_recipe_config", [
        ('"root": "data/train"', f'"root": "{data}/train"', 1),
        ('"root": "data/val"', f'"root": "{data}/val"', 1),
        ('"path": f"data/runs/{experiment_name}"', f'"path": "{run}"', 1),
        ("n_epochs = 90", "n_epochs = 2", 1),
        ('"num_workers": 16', f'"num_workers": {MODERN_WORKERS}', 2)],
        os.path.join(MODERN_DIR, "modern.py"))
    env = {k: v for k, v in os.environ.items() if k != "NKBX_PRETRAINED_DIR"}
    return (start_cli(["-m", "nkbx_torch.train", "-cfg", cfg_path], "modern_train.log", env),
            time.perf_counter(), run, data)


def check_modern_cli(started):
    """MODERN (c)-(d), each CLI in a subprocess (``started``: (c)'s, from
    start_modern_cli):
    (c) ``python -m nkbx_torch.train`` on configs/modern_recipe_config.py with
        only the data roots, the run directory, n_epochs (2) and num_workers
        changed (``shipped_config``), over a seeded ImageFolder of
        25 x 128 + 273 BMP files: each epoch one call of 20 steps and one of
        5; ``pretrained`` without a converted file and the config's
        ``mixup_alpha`` must each warn; exit 0, its files, finite metrics;
        the recipe's own lr (0.5) is kept;
    (d) ``python -m nkbx_torch.eval`` on the run's weights/best.pt
        (configs/eval_config.py with the run's paths, the model rebuilt from
        resnet50, and the recipe's val data, pipeline and criterion):
        balanced accuracy and loss within 1e-6 relative of metrics.csv's best
        epoch; best.pt equal to the EMA shadow in weights/best/train_state.pt
        and not to its raw weights."""
    handle, t0, run, data = started
    out = {}
    text, _ = finish_cli(handle, "the modern recipe's train run")
    out["train_cli_s"] = time.perf_counter() - t0
    rows = read_metrics_csv(os.path.join(run, "metrics.csv"))
    have = [n for n in ("classes.json", "metrics.csv", "weights/best.pt", "weights/last.pt",
                        "weights/best", "weights/last") if os.path.exists(os.path.join(run, n))]
    warned = {"pretrained": "no converted checkpoint for 'resnet50'" in text,
              "mixup_alpha": "'mixup_alpha' is ignored" in text}
    log(f"modern (c): python -m nkbx_torch.train on configs/modern_recipe_config.py exit 0 in "
        f"{out['train_cli_s']:.1f} s (beside (e)); {have}; metrics.csv rows {len(rows)}; "
        f"warnings {warned}")
    if len(have) != 6 or len(rows) != 2 or not all(warned.values()):
        fail(f"the modern recipe's train run failed (log in {OUT_DIR}/modern_train.log): "
             f"{text[-2000:]}")
    shutil.copy(os.path.join(run, "metrics.csv"), os.path.join(OUT_DIR, "modern_metrics.csv"))
    keys = ("train loss", "Val loss", "Val balanced accuracy", "train images/sec/chip")
    for r in rows:
        log(f"   epoch {r['Epoch']}: " + ", ".join(f"{k} {float(r[k]):.6f}" for k in keys))
        if not all(np.isfinite(float(r[k])) for k in keys):
            fail("the modern recipe's metrics are not finite")
    out["train_img_s"] = [float(r["train images/sec/chip"]) for r in rows]
    out["train_loss"] = [float(r["train loss"]) for r in rows]
    best, best_acc = rows[0], -1.0
    for r in rows:  # the trainer's rule: the first epoch that beats the best so far
        if float(r["Val balanced accuracy"]) > best_acc:
            best, best_acc = r, float(r["Val balanced accuracy"])
    saved = torch.load(os.path.join(run, "weights", "best", "train_state.pt"),
                       map_location="cpu", weights_only=True)
    best_pt = torch.load(os.path.join(run, "weights", "best.pt"), map_location="cpu",
                         weights_only=True)
    is_ema = all(torch.equal(best_pt[k], saved["ema"][k]) for k in saved["ema"])
    is_raw = all(torch.equal(best_pt[k], saved["module"][k]) for k in saved["module"])
    out["best_pt_is_ema"], out["best_pt_is_raw"] = is_ema, is_raw
    with open(os.path.join("configs", "eval_config.py")) as f:
        header = next(line for line in f if line.startswith("import"))
    save = os.path.abspath(os.path.join(MODERN_DIR, "eval"))
    eval_cfg = shipped_config("eval_config", [
        ('train_run_path = "data/runs/train_singletask_run_1"', f'train_run_path = "{run}"', 1),
        ('save_path = "data/runs/val_singletask_run_1"', f'save_path = "{save}"', 1)],
        os.path.join(MODERN_DIR, "eval.py"))
    with open(eval_cfg, "a") as f:  # the recipe's val data, pipeline, model and criterion
        f.write(textwrap.dedent(f"""
            {header.strip()}
            val_data = {{"type": "ImageFolder", "root": "{data}/val", "shuffle": False,
                        "batch_size": {MODERN_BATCH}, "num_workers": {MODERN_WORKERS},
                        "drop_last": False}}
            img_size = 224
            val_pipeline = T.Compose([
                T.LongestMaxSize(img_size),
                T.PadIfNeeded(img_size, img_size, border_mode=0, value=0),
                T.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
                T.ToTensorV2(),
            ])
            model = {{"task": task, "model": "resnet50",
                     "checkpoint": f"{{train_run_path}}/weights/best.pt"}}
            criterion = {{"task": task, "type": "CrossEntropyLoss", "label_smoothing": 0.1}}
        """))
    proc, out["eval_cli_s"] = run_cli("nkbx_torch.eval", eval_cfg, "modern_eval.log")
    if proc.returncode != 0:
        fail(f"the modern eval CLI failed (log in {OUT_DIR}/modern_eval.log): "
             f"{proc.stderr[-2000:]}")
    with open(os.path.join(save, "metrics.json")) as f:
        metrics = json.load(f)
    d_acc = abs(metrics["epoch_acc"] - best_acc) / max(best_acc, 1e-12)
    d_loss = (abs(float(np.mean(metrics["loss"])) - float(best["Val loss"]))
              / abs(float(best["Val loss"])))
    out.update(eval_acc=metrics["epoch_acc"], eval_loss=float(np.mean(metrics["loss"])),
               eval_rel_diff_acc=d_acc, eval_rel_diff_loss=d_loss)
    log(f"modern (d): python -m nkbx_torch.eval exit 0 in {out['eval_cli_s']:.1f} s on "
        f"weights/best.pt (epoch {best['Epoch']}): balanced accuracy {metrics['epoch_acc']:.8f} "
        f"(metrics.csv {best_acc:.8f}, rel diff {d_acc:.3e}), loss {out['eval_loss']:.8f} "
        f"(metrics.csv {float(best['Val loss']):.8f}, rel diff {d_loss:.3e}); tol 1e-6; best.pt "
        f"is the EMA shadow {is_ema}, the raw weights {is_raw}")
    if d_acc > 1e-6 or d_loss > 1e-6 or not is_ema or is_raw:
        fail("modern (d): the eval CLI does not reproduce the best epoch, or best.pt is not "
             "the EMA shadow")
    return out


# a fixed sample of nkbx's flax paths of swin_tiny's 173 parameters (nkbx's
# SingletaskClassifier over its Swin), the keys its gradient norms are logged under
SWIN_T_FLAX_PATHS = ("backbone/patch_embed/kernel", "backbone/patch_norm/scale",
                     "backbone/stage0_block0/attn/qkv/kernel",
                     "backbone/stage0_block0/attn/relative_position_bias_table",
                     "backbone/stage0_block0/fc1/kernel", "backbone/stage0_block0/norm2/bias",
                     "backbone/downsample2/reduction/kernel",
                     "backbone/stage3_block1/attn/proj/bias", "backbone/norm/scale",
                     "head/kernel", "head/bias")
SWIN_T_N_PARAMS = 173


def check_modern_kernels():
    """MODERN (e), the A4 options on a path with kernels: swin_tiny at
    batch 64 (the last 6 rows padded), bf16, flips + Normalize, nadam at
    check_train's fine-tuning lrs, cross-entropy, with grad_accum_steps=2,
    EMA 0.9998, mixup {"alpha": 0.2, "cutmix_alpha": 1.0} and
    log_gradients. 3 steps through the kernels (counts set to 0 just before,
    read after the first step and after the third: K1, K2, K5 and K6 launch
    twice a step what one plain step launches, each microbatch once), the
    same 3 steps from the same weights and generator seed through the plain
    versions in bf16, and the first step through plain in f32 (TF32 off).
    Held under PERF.md §2's rules: the 6 microbatch losses within 0.5% of
    plain bf16's; the first step's accumulated gradients (``.grad``, the two
    microbatches' mass-weighted mean, the kernels' backward at batch 32)
    under bf16's rule (check_bf16_grads: each tensor within twice plain
    bf16's distance from plain f32, plus 1e-3). The first step's logged norms
    equal the norms of those gradients (f32, 1e-5 relative); a norm is one
    scalar, one sample of rounding noise, so it is not held to plain's
    distance itself. The norms finite, one per parameter (173) under nkbx's
    flax paths, SWIN_T_FLAX_PATHS among them. Returns the kernels' counts of
    the 3 steps and the numbers."""
    from nkbx_torch.models import convert
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (A4_STEPS, BUCKET, 224, 224, 3),
                                          dtype=np.uint8), device=DEV)
    labels = torch.as_tensor(rng.integers(0, N_CLASSES, (A4_STEPS, BUCKET)), device=DEV)
    mask = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    mask[-6:] = False
    pipe = Compose([HorizontalFlip(), Normalize()])
    bundle = get_optimizer({"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4,
                            "weight_decay": 0.05})
    one = SWIN.counts(torch.bfloat16, True)
    init = None

    def run(dtype, plain, steps):
        """``steps`` steps from the same weights and generator seed: the
        losses, the counts after the first step and after the last, the first
        step's accumulated gradients and its norms, the last step's norms."""
        nonlocal init
        set_plain(plain)
        model = SWIN.model(dtype)
        if init is None:
            init = {k: v.clone() for k, v in model.module.state_dict().items()}
        model.module.load_state_dict(init)
        state = TrainState.create(model, seed=0, ema=True)
        step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), bundle,
                                augment_fn=pipe.device_apply, grad_accum_steps=2,
                                ema_decay=0.9998, mixup={"alpha": 0.2, "cutmix_alpha": 1.0},
                                log_gradients=True)
        torch.cuda.synchronize()
        zero_counts()
        out = {"losses": []}
        for i in range(steps):
            state, m = step(state, images[i], labels[i], mask, 1.0, 1.0)
            out["losses"].append(m["loss"].float())
            if i == 0:
                torch.cuda.synchronize()
                out["first"] = read_counts()
                out["grads"] = {convert.flax_param_path(n, t): t.grad.clone()
                                for n, t in model.module.named_parameters()}
                out["norms1"] = {k: v.clone() for k, v in m["grad_norms"].items()}
        torch.cuda.synchronize()
        out["counts"] = read_counts()
        out["norms"] = {k: float(v) for k, v in m["grad_norms"].items()}
        out["losses"] = torch.stack(out["losses"]).cpu()
        set_plain(False)
        return out

    k = run(torch.bfloat16, False, A4_STEPS)
    p = run(torch.bfloat16, True, A4_STEPS)
    p32 = run(torch.float32, True, 1)
    rel = float(((k["losses"] - p["losses"]).abs() / p["losses"].abs()).max())
    twice = {n: 2 * v for n, v in one.items()}
    norms = k["norms"]
    keys_ok = len(norms) == SWIN_T_N_PARAMS and set(SWIN_T_FLAX_PATHS) <= set(norms)
    finite = all(np.isfinite(list(norms.values())))
    zero = dict.fromkeys(one, 0)
    log(f"modern (e): swin_tiny, batch {BUCKET}, bf16, grad_accum_steps=2, EMA, mixup, "
        f"log_gradients: microbatch losses {k['losses'].tolist()} (plain "
        f"{p['losses'].tolist()}), max rel {rel:.3e} (tol 5e-3); launches in step 1 "
        f"{k['first']} (want twice one plain step's: {twice}), in {A4_STEPS} steps "
        f"{k['counts']}; plain's {p['counts']}, plain f32's {p32['counts']}; {len(norms)} "
        f"gradient norms, finite {finite}, keys nkbx's {keys_ok}; step {A4_STEPS}'s total "
        f"{sum(norms.values()):.6e} (plain {sum(p['norms'].values()):.6e})")
    if k["first"] != twice or k["counts"] != {n: A4_STEPS * v for n, v in twice.items()}:
        fail("modern (e): K1, K2, K5 and K6 did not launch twice a step under accumulation")
    if p["counts"] != zero or p32["counts"] != zero:
        fail(f"modern (e): the plain path launched kernels: {p['counts']}, {p32['counts']}")
    if rel > 5e-3 or k["losses"].shape != (A4_STEPS, 2) or not keys_ok or not finite:
        fail("modern (e): the A4 step's losses disagree with the plain path, or its gradient "
             "norms are not finite under nkbx's keys")
    check_bf16_grads("modern (e) step 1's accumulated gradients", k["grads"], p["grads"],
                     p32["grads"])
    # nadam's weight decay is decoupled and freeze_scale is 1: each logged norm
    # is the norm of the accumulated gradient held above
    if set(k["norms1"]) != set(k["grads"]):
        fail("modern (e): the logged gradient norms and the parameters differ in their keys")
    norm_err = max(abs(float(k["norms1"][n] - g.norm())) / max(float(g.norm()), 1e-30)
                   for n, g in k["grads"].items())
    log(f"modern (e): step 1's logged norms against the norms of its accumulated gradients, "
        f"max rel {norm_err:.3e} (tol 1e-5)")
    if norm_err > 1e-5:
        fail("modern (e): the logged gradient norms are not the accumulated gradients' norms")
    return k["counts"], {"loss_rel": rel, "losses": k["losses"].tolist(),
                         "plain_losses": p["losses"].tolist(),
                         "grad_norms_total": sum(norms.values()),
                         "plain_grad_norms_total": sum(p["norms"].values())}


def check_modern():
    """MODERN, configs/modern_recipe_config.py in the port: (a)
    check_modern_stage, (b) check_modern_step, which run no kernel of ours
    (resnet50 with exact BatchNorm: the counts, set to 0 before and read
    after, stay 0); then (c)'s train CLI starts (start_modern_cli) and runs
    beside (e) check_modern_kernels, the A4 options through K1, K2, K5 and
    K6, which times nothing; then (c)-(d) check_modern_cli. Returns (the
    numbers, (e)'s counts)."""
    from nkbx_torch.utils import load_config

    cfg = load_config(MODERN_CONFIG)
    zero_counts()
    out = {"device_stage": check_modern_stage(cfg)}
    out["step"] = check_modern_step(cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        fail(f"modern (a)-(b) launched port kernels they should not: {counts}")
    started = start_modern_cli()
    counts, out["a4_swin"] = check_modern_kernels()
    out["cli"] = check_modern_cli(started)
    log(f"modern: {json.dumps(out)}")
    return out, counts


# --- HEAVY: configs/heavy_augs_config.py in the port -------------------------------

HEAVY_DIR = os.path.join("build", "heavy_smoke")  # data, config and run
HEAVY_CONFIG = os.path.join("configs", "heavy_augs_config.py")
HEAVY_SIZE = 224  # the config's img_size
# 10 full batches of 64 a train epoch and a padded val batch
HEAVY_SPLITS = (("train", 10 * BUCKET), ("val", 2 * BUCKET + 9))
HEAVY_WORKERS = 6  # the card's machine has 8 cores
HEAVY_OP_ITERS = 10  # timed launches of each op alone
# a warp's source coordinate (up to ~300 px at 224) may differ across devices by a
# few f32 ulps of it and of its sine and cosine; the output moves at most 255 a
# pixel of source shift, so a warp's output is held to 1e-3 + 255 times this
WARP_COORD_TOL = 5e-4


def heavy_classes(cfg):
    """Two or three classes for each of the config's six targets."""
    return {t: [f"{t}_{k}" for k in range(2 + i % 2)] for i, t in enumerate(cfg.target_names)}


def check_heavy_stage(cfg):
    """HEAVY (a): configs/heavy_augs_config.py's device stage (MotionBlur,
    brightness/contrast, HSV, RandomShadow, RandomFog, RandomRain, coarse
    dropout, Normalize), and Rotate and ShiftScaleRotate (p = 1) in both
    border modes (a constant of 114), on a CUDA uint8 batch of 64 at 224 px
    with fixed draws (from a CPU generator) against the CPU with the same
    draws: op by op, each from the same input (the CPU's output of the op
    before), within 1e-3 on the 0-255 scale, MotionBlur's kernels equal in
    support, all leaving out the ties (``op_ties``: counted); the whole stage
    within 1e-3 / (255·std) after Normalize without the ties of any op;
    a warp's source coordinates within WARP_COORD_TOL px of the CPU's, its
    bilinear sampling at the CPU's coordinates within 1e-3, and its output
    within 1e-3 + 255·WARP_COORD_TOL (a bilinear sample moves at most 255 a
    pixel of source shift); then the stage's ms a batch in bf16 with its own
    draws from a CUDA generator (CUDA events), each op's ms and peak memory
    over its input alone, the stage's peak and a profile of one batch
    (device ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from nkbx_torch.transforms import device as D
    from nkbx_torch.transforms import spec as S

    pipe = cfg.train_pipeline
    norm = pipe.device_transforms[-1]
    std = 255.0 * min(norm.std)
    size = (BUCKET, HEAVY_SIZE, HEAVY_SIZE)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (*size, 3), dtype=np.uint8))
    xd = x.to(DEV)
    stages = [("heavy", pipe.device_stage())] + [
        (name, S.Compose([t, norm]).device_stage()) for name, t in (
            ("rotate_reflect101", S.Rotate(p=1.0)),
            ("rotate_constant", S.Rotate(border_mode="constant", value=114.0, p=1.0)),
            ("shift_scale_rotate_reflect101", S.ShiftScaleRotate(p=1.0)),
            ("shift_scale_rotate_constant", S.ShiftScaleRotate(border_mode="constant",
                                                               value=114.0, p=1.0)))]
    warps = (S.Rotate, S.ShiftScaleRotate)
    out, bad = {}, []
    for name, stage in stages:
        draws = stage.draw(tuple(x.shape), torch.Generator().manual_seed(3))
        on_card = [{k: v.to(DEV) for k, v in d.items()} for d in draws]
        xr, errs, op_ms, op_peak = x.float(), {}, {}, {}
        ties, kernels_equal, tie_count, warp = torch.zeros(size, dtype=torch.bool), True, {}, {}
        tol = 1e-3
        for t, d, dc in zip(stage.ops, draws, on_card):
            op = type(t).__name__
            apply = D._APPLIERS[type(t)]
            want = apply(t, xr, d)
            xc = xr.to(DEV)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = apply(t, xc, dc)
            torch.cuda.synchronize()
            op_peak[op] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            got = got.cpu()
            tie = D.op_ties(t, d, HEAVY_SIZE, HEAVY_SIZE)
            keep = ~tie[..., None]
            errs[op], tie_count[op] = max_err(got * keep, want * keep), int(tie.sum())
            ties |= tie
            if isinstance(t, S.MotionBlur):
                taps = ~D.motion_ties(t, d)
                kernels_equal = torch.equal((D.motion_kernels(t, dc).cpu() > 0)[taps],
                                            (D.motion_kernels(t, d) > 0)[taps])
                tie_count["MotionBlur_taps"] = int((~taps).sum())
            if isinstance(t, warps):
                src = D.warp_sources(t, d, HEAVY_SIZE, HEAVY_SIZE)
                src_c = D.warp_sources(t, dc, HEAVY_SIZE, HEAVY_SIZE)
                mode = D.BORDER_MODES[t.border_mode]
                warp = {"coord_err_px": max(max_err(a.cpu(), b) for a, b in zip(src_c, src)),
                        "sampling_err": max_err(D.bilinear_warp(
                            xc, *(v.to(DEV) for v in src), mode, t.value).cpu(),
                            D.bilinear_warp(xr, *src, mode, t.value))}
                tol = 1e-3 + 255.0 * WARP_COORD_TOL
                if warp["coord_err_px"] > WARP_COORD_TOL or warp["sampling_err"] > 1e-3:
                    bad.append(f"{name} coordinates or sampling")
            op_ms[op] = cuda_ms(lambda: apply(t, xc, dc), iters=HEAVY_OP_ITERS)
            xr = want
        keep = ~ties[..., None]
        whole = max_err(stage(xd, draws=on_card).cpu() * keep, stage(x, draws=draws) * keep)
        gen = torch.Generator(device=DEV).manual_seed(0)
        ms = cuda_ms(lambda: stage(xd, torch.bfloat16, generator=gen), iters=STAGE_ITERS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stage(xd, torch.bfloat16, generator=gen)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage(xd, torch.bfloat16, generator=gen)
            torch.cuda.synchronize()
        events = report_profile(prof, 1, f"in one {name} device-stage batch of {BUCKET} at "
                                f"{HEAVY_SIZE} px", ms, f"profile_heavy_stage_{name}.txt")
        out[name] = {"max_abs_err_0_255_by_op": errs, "tol_0_255": tol, "ties": tie_count,
                     "kernels_equal": kernels_equal, "max_abs_err_normalized": whole,
                     "warp": warp, "ms_per_batch": ms, "op_ms": op_ms,
                     "op_peak_mb_over_input": op_peak, "peak_mb_over_input": peak,
                     "peak_in_f32_batches": peak * 2 ** 20 / (x.numel() * 4),
                     "device_busy_ms": device_ms(events, 1) if events else None,
                     "launches": sum(e.count for _, e in events),
                     "gates": [int(d["gate"].sum()) for d in draws]}
        log(f"heavy (a) {name}: card against CPU with the same draws, by op max|d| "
            f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol {tol:.4g}), ties left out "
            f"{tie_count}, MotionBlur supports equal {kernels_equal}, warp {warp}; the whole "
            f"stage {whole:.3e} (tol {tol / std:.2e}); {ms:.4f} ms a batch in bf16 with its "
            f"own draws, by op {json.dumps(op_ms)}; peak {peak:.1f} MB over the input, by op "
            f"{json.dumps(op_peak)}")
        if max(errs.values()) > tol or whole > tol / std or not kernels_equal:
            bad.append(name)
    if bad:
        fail(f"heavy (a): the device stage on the card disagrees with the CPU: {bad}")
    return out


def write_heavy_csv(data, classes, seed=0):
    """A seeded annotated CSV (path, fold, one column a target) of BMP files
    under ``data/images``, 96-200 px a side, each target's class drawn per
    image."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    names = sorted(classes)
    rows = ["path,fold," + ",".join(names)]
    for fold, n in HEAVY_SPLITS:
        for i in range(n):
            h, w = (int(v) for v in rng.integers(96, 201, 2))
            name = f"{fold}_{i}.bmp"
            write_bmp(os.path.join(data, "images", name),
                      rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
            labels = [classes[t][int(rng.integers(0, len(classes[t])))] for t in names]
            rows.append(f"{name},{fold}," + ",".join(labels))
    with open(os.path.join(data, "annotations.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def check_heavy_cli(cfg):
    """HEAVY (b): ``python -m nkbx_torch.train`` in a subprocess on
    configs/heavy_augs_config.py with only its data paths, run directory
    and num_workers changed (mobilenetv3_large_100 at 224 px, batch 64,
    bf16, six FocalLoss heads, nadam, multistep, the freeze policy,
    log_gradients, the whole heavy device stage on the card, its own 2
    epochs) over a seeded annotated CSV of 640 + 137 BMP images;
    NKBX_PRETRAINED_DIR unset, so the pretrained warning must appear; exit
    0, its files, finite metrics and Gradients/* columns."""
    shutil.rmtree(HEAVY_DIR, ignore_errors=True)
    data = os.path.abspath(os.path.join(HEAVY_DIR, "data"))
    run = os.path.abspath(os.path.join(HEAVY_DIR, "run"))
    write_heavy_csv(data, heavy_classes(cfg))
    cfg_path = shipped_config("heavy_augs_config", [
        ('annotations_path = "data/annotations.csv"',
         f'annotations_path = "{data}/annotations.csv"', 1),
        ('image_base_dir = "data/images"', f'image_base_dir = "{data}/images"', 1),
        ('"path": f"data/runs/{experiment_name}"', f'"path": "{run}"', 1),
        ('"num_workers": 8', f'"num_workers": {HEAVY_WORKERS}', 1)],
        os.path.join(HEAVY_DIR, "heavy.py"))
    env = {k: v for k, v in os.environ.items() if k != "NKBX_PRETRAINED_DIR"}
    out = {}
    proc, out["train_cli_s"] = run_cli("nkbx_torch.train", cfg_path, "heavy_train.log", env)
    rows = read_metrics_csv(os.path.join(run, "metrics.csv")) if proc.returncode == 0 else []
    have = [n for n in ("classes.json", "metrics.csv", "weights/best.pt", "weights/last.pt")
            if os.path.exists(os.path.join(run, n))]
    warned = "no converted checkpoint for 'mobilenetv3_large_100'" in proc.stderr
    grads = [k for k in (rows[0] if rows else {}) if k.startswith("Gradients/")]
    log(f"heavy (b): python -m nkbx_torch.train on configs/heavy_augs_config.py exit "
        f"{proc.returncode} in {out['train_cli_s']:.1f} s; {have}; metrics.csv rows {len(rows)}; "
        f"{len(grads)} Gradients/* columns; pretrained warning {warned}")
    if (proc.returncode != 0 or len(have) != 4 or len(rows) != 2 or not warned
            or "Gradients/Total" not in grads):
        fail(f"the heavy_augs train run failed (log in {OUT_DIR}/heavy_train.log): "
             f"{proc.stderr[-2000:]}")
    shutil.copy(os.path.join(run, "metrics.csv"), os.path.join(OUT_DIR, "heavy_metrics.csv"))
    keys = ("train loss", "Val loss", "Val balanced accuracy", "train images/sec/chip",
            "Gradients/Total")
    for r in rows:
        log(f"   epoch {r['Epoch']}: " + ", ".join(f"{k} {float(r[k]):.6f}" for k in keys))
        if not all(np.isfinite(float(r[k])) for k in keys + tuple(grads)):
            fail("the heavy_augs run's metrics are not finite")
    out["train_img_s"] = [float(r["train images/sec/chip"]) for r in rows]
    out["train_loss"] = [float(r["train loss"]) for r in rows]
    out["gradient_columns"] = len(grads)
    return out


def check_heavy():
    """HEAVY, configs/heavy_augs_config.py in the port: (a)
    check_heavy_stage, (b) its train step at 224 px, batch 64
    (shipped_model_check: step ms, a profile's device ms and idle share,
    serving), (c) check_heavy_cli. No kernel of ours runs on it: the
    counts, set to 0 before and read after the in-process phases, stay 0
    (the CLI's subprocess has counts of its own). Returns the counts."""
    from nkbx_torch.utils import load_config

    cfg = load_config(HEAVY_CONFIG)
    zero_counts()
    out = {"device_stage": check_heavy_stage(cfg)}
    out["step"] = shipped_model_check("heavy_augs_config", cfg, heavy_classes(cfg), cfg.img_size)
    out["cli"] = check_heavy_cli(cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        fail(f"heavy launched port kernels it should not: {counts}")
    busy = out["device_stage"]["heavy"]["device_busy_ms"]
    out["stage_share_of_step_device_ms"] = (busy / out["step"]["profile"]["device_ms"]
                                            if busy else None)
    log(f"heavy: {json.dumps(out)}")
    return counts


# --- EXPORT: serving bundles, TorchScript and the shipped configs as shipped ---------

EXPORT_DIR = os.path.join("build", "export_smoke")  # data, configs, weights, bundles, runs
EXPORT_REQUESTS = (1, 5, BUCKET, 70)  # images a request; 70 = a chunk of 64 and one of 6
EXPORT_FORWARDS = 5  # forwards of a bucket-64 bundle for those requests
EXPORT_BENCH_ITERS = 10  # iterations of each ServingModule.benchmark(64) tier
EXPORT_SWEEP_ITERS = 3  # iterations of each tier of the serving CLI's sweep
YOLO_CLASSES = ("cat", "dog")
YOLO_SPLITS = (("train", 48), ("val", 24))  # BMP images, 2 boxes each


def start_cli(args, log_name, env=None):
    """``python <args>`` started in a subprocess whose output goes to
    OUT_DIR/<log_name>; returns a handle for finish_cli."""
    out = open(os.path.join(OUT_DIR, log_name), "w")
    proc = subprocess.Popen([sys.executable, *args], stdout=out, stderr=subprocess.STDOUT,
                            text=True, env=env)
    return proc, out


def finish_cli(started, what, timeout=900):
    """Wait for a subprocess of start_cli; fails the run on a non-zero exit;
    returns its output and, for the export CLI, the seconds its export took
    by its own log."""
    proc, out = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
        out.close()
    with open(out.name) as f:
        text = f.read()
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode} (log in {out.name}): {text[-2000:]}")
    m = re.search(r"export success, saved as \S+ \(([0-9.]+) s\)", text)
    return text, float(m.group(1)) if m else None


def export_config(path, data, run, model_cfg, size):
    """A config for the export CLI: the classes from a seeded ImageFolder of
    ten classes (one BMP each), the model, bf16 compute."""
    rng = np.random.default_rng(0)
    for c in range(N_CLASSES):
        os.makedirs(os.path.join(data, f"class{c}"), exist_ok=True)
        write_bmp(os.path.join(data, f"class{c}", "0.bmp"),
                  rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    with open(os.path.join("configs", "singletask_config.py")) as f:
        header = next(line for line in f if line.startswith("import"))  # the shipped import
    with open(path, "w") as f:
        f.write(header + textwrap.dedent(f"""
            task = "single"
            enable_mixed_precision = True
            experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
            train_data = {{"type": "ImageFolder", "root": "{data}", "batch_size": 8,
                          "num_workers": 1}}
            train_pipeline = T.Compose([T.Resize({size}, {size}), T.Normalize()])
            model = {model_cfg!r}
        """))
    return path


def same_padding(serving, fn):
    """``serving`` with its program replaced by ``fn``: the same buckets,
    padding, chunking and dtype, so that an eager model is held against a
    bundle on the same padded batches."""
    import copy

    other = copy.copy(serving)
    other._predict = torch.inference_mode()(fn)
    return other


def hold_bundle(label, serving, x, want_counts, refs):
    """Serve requests of EXPORT_REQUESTS images (the first n rows of the
    normalised batch ``x``) from a bundle: the launch counts (zeroed just
    before, read just after) equal ``want_counts``; finite logits of the
    right shape; each of ``refs`` = {name: (ServingModule with the same
    padding, tolerance as a share of the largest reference logit, or None
    for 2 bf16 ulps of it)} agrees on every request. Returns (the errors,
    the counts)."""
    zero_counts()
    outs = [serving(x[:n]) for n in EXPORT_REQUESTS]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"export {label}: {EXPORT_FORWARDS} forwards; launches "
        f"{ {k: v for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in want_counts.items() if v} })")
    if counts != want_counts:
        fail(f"the {label} bundle did not launch the kernels as expected")
    for n, o in zip(EXPORT_REQUESTS, outs):
        if tuple(o.shape) != (n, N_CLASSES) or not torch.isfinite(o).all():
            fail(f"{label} logits of request {n}: shape {tuple(o.shape)}, not finite")
    errs = {}
    for name, (ref, tol) in refs.items():
        set_plain(name != "kernels")
        want = [ref(x[:n]) for n in EXPORT_REQUESTS]
        set_plain(False)
        top = max(float(w.float().abs().max()) for w in want)
        limit = 2 * bf16_ulp(top) if tol is None else tol * top
        err = max(max_err(o, w) for o, w in zip(outs, want))
        errs[name] = {"max_abs_err": err, "tol": limit, "largest": top}
        log(f"export {label} against the eager {name} model: max|d| {err:.4e} (tol {limit:.4e}, "
            f"largest logit {top:.4f})")
        if not err <= limit:
            fail(f"the {label} bundle disagrees with the eager {name} model")
    return errs, counts


def hold_bundles(path, model, x, total, fused=None, portable=None):
    """Load a path's bundles (``fused`` and ``portable``: their files) in
    ServingModules and hold them (hold_bundle): the fused one against the
    eager model through the kernels, the portable one against the eager
    plain model, both against the plain f32 model (5%). Adds the fused
    bundle's launches to ``total``. Returns (the numbers, the servers)."""
    from nkbx_torch.export import ServingModule

    res, servers = {}, {}
    ref32 = path.model(torch.float32)
    for kind, bundle in (("fused", fused), ("portable", portable)):
        if bundle is None:
            continue
        t0 = time.perf_counter()
        serving = servers[kind] = ServingModule(bundle, warm_up_on_load=False)
        load_s = time.perf_counter() - t0
        if serving.buckets != ([BUCKET] if kind == "fused" else [1, 2, 4, 8, 16, 32, BUCKET]):
            fail(f"{path.label} {kind} bundle buckets {serving.buckets}")
        want = ({k: v * EXPORT_FORWARDS for k, v in path.counts(torch.bfloat16, False).items()}
                if kind == "fused" else dict.fromkeys(COUNTED, 0))
        refs = {"kernels" if kind == "fused" else "plain": (same_padding(serving, model.module),
                                                            None),
                "plain f32": (same_padding(serving, ref32.module), 5e-2)}
        errs, counts = hold_bundle(f"{path.label} {kind}", serving, x, want, refs)
        for k, v in counts.items():
            total[k] += v
        res[kind] = {"load_s": load_s, "errors": errs,
                     "launches": {k: v for k, v in want.items() if v}}
    return res, servers


def check_export_models(started, out):
    """EXPORT (1)-(3) and (6): ViT-B (fused flags) and ConvNeXt-T (under
    NKBX_FUSED_LN_MLP=0) exported in this process, Swin-T's three files
    from the CLIs in ``started``, bf16, seed 0, 10 classes, held. Adds to
    ``out``; returns (Swin-T's servers and model, the fused bundles'
    launch counts)."""
    from nkbx_torch.export import export_model
    from nkbx_torch.transforms import Compose, Normalize

    root = os.path.abspath(EXPORT_DIR)
    total = dict.fromkeys(COUNTED, 0)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (70, 224, 224, 3), dtype=np.uint8), device=DEV)
    x = Compose([Normalize()]).device_apply(images)  # the normalised f32 batch

    # (2) ViT-B with the fused flags and (3) ConvNeXt-T under the switch
    for path in (VIT, CONVNEXT_MLP):
        with path.environment():
            model = path.model(torch.bfloat16)
            t0 = time.perf_counter()
            bundle, _ = export_model(model, (BUCKET, 224, 224, 3),
                                     os.path.join(root, f"{path.label}_fused.nkbx"),
                                     dynamic="none", fused_attention=True)
            export_s = time.perf_counter() - t0
            res, _ = hold_bundles(path, model, x, total, fused=bundle)
            out[path.label] = {"export_s": export_s, **res}
            log(f"export {path.label}: {json.dumps(out[path.label])}")
            del model

    # (1) Swin-T's two bundles from the CLI; the serving CLI's sweep (4) starts on the
    # portable one at once
    swin = SWIN.model(torch.bfloat16)
    for kind in ("portable", "fused"):
        _, out[f"swin_tiny_{kind}_export_s"] = finish_cli(started[kind],
                                                          f"python -m nkbx_torch.export ({kind})")
    started["sweep"] = (start_cli(
        ["-m", "nkbx_torch.export.serving", os.path.join(root, "portable", "best.nkbx"),
         "--sweep", "--iters", str(EXPORT_SWEEP_ITERS)], "export_serving_sweep.log"),
        time.perf_counter())
    res, servers = hold_bundles(SWIN, swin, x, total,
                                fused=os.path.join(root, "fused", "best.nkbx"),
                                portable=os.path.join(root, "portable", "best.nkbx"))
    out["swin_tiny"] = res
    log(f"export swin_tiny: {json.dumps(res)}")

    # (6) the TorchScript file, against the eager plain model
    _, secs = finish_cli(started["torchscript"], "python -m nkbx_torch.export (torchscript)")
    traced = torch.jit.load(os.path.join(root, "ts", "best.pt"), map_location=DEV)
    set_plain(True)
    with torch.inference_mode():
        got = traced(x[:8].permute(0, 3, 1, 2).contiguous())
        want = swin.module(x[:8])
    set_plain(False)
    tol = 2 * bf16_ulp(float(want.abs().max()))
    err = max_err(got, want)
    out["torchscript"] = {"export_s": secs, "max_abs_err": err, "tol": tol}
    log(f"export swin_tiny torchscript: torch.jit.load, NCHW batch of 8 against the eager plain "
        f"model: max|d| {err:.4e} (tol {tol:.4e})")
    if not err <= tol:
        fail("the TorchScript file disagrees with the eager plain model")
    return (servers, swin), total


def check_export_server(servers, swin, sweep, out):
    """EXPORT (4): ``python -m nkbx_torch.export.serving --sweep`` on the
    portable bundle (``sweep``: its handle and start, from
    check_export_models; it ran beside the rest of EXPORT, so its numbers
    are a check of the CLI, not a measurement); then, with nothing else on
    the card, one turn of benchmark(64) of Swin-T's fused bundle, its
    portable bundle and the eager model-backed ServingModule. Numbers, not a
    claim."""
    from nkbx_torch.export import ServingModule

    handle, t0 = sweep
    text, _ = finish_cli(handle, "python -m nkbx_torch.export.serving --sweep")
    rows = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if [r["batch_size"] for r in rows] != [1, 2, 4, 8, 16, 32, BUCKET]:
        fail(f"the serving sweep's rows: {[r['batch_size'] for r in rows]}")
    out["sweep"], out["sweep_s"] = rows, time.perf_counter() - t0
    for r in rows:
        log(f"export sweep swin_tiny portable: batch {r['batch_size']}: p50 {r['p50_ms']:.3f} ms, "
            f"compute p50 {r['compute_p50_ms']:.3f} ms, pipelined "
            f"{r['pipelined_images_per_sec']:.1f} img/s (beside other work)")
    eager = ServingModule(swin, buckets=(1, 8, BUCKET), warm_up_on_load=False)
    bench = {}
    for name, serving in (("fused", servers["fused"]), ("portable", servers["portable"]),
                          ("eager", eager)):
        r = serving.benchmark(BUCKET, iters=EXPORT_BENCH_ITERS)
        bench[name] = [r]
        log(f"export benchmark({BUCKET}) swin_tiny {name}: p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms, {r['images_per_sec']:.1f} img/s (compute p50 "
            f"{r['compute_p50_ms']:.3f} ms, pipelined {r['pipelined_images_per_sec']:.1f} "
            "img/s)")
    out["benchmark"] = bench


def write_yolo_set(root, seed=0):
    """A seeded ultralytics-layout set (BMP images, 2 boxes each of the two
    classes, labels in xywhn) and its data YAML; returns the YAML's path."""
    rng = np.random.default_rng(seed)
    for split, n in YOLO_SPLITS:
        os.makedirs(os.path.join(root, split, "images"))
        os.makedirs(os.path.join(root, split, "labels"))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(160, 241, 2))
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            lines = []
            for k in range(2):
                c = (i + k) % 2
                bw, bh = rng.uniform(0.2, 0.35, 2)
                xc, yc = 0.25 + 0.5 * k, rng.uniform(0.3, 0.7)
                x0, y0 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
                img[y0:y0 + int(bh * h), x0:x0 + int(bw * w)] = (200, 60, 60) if c else (60, 60, 200)
                lines.append(f"{c} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f}")
            write_bmp(os.path.join(root, split, "images", f"{i}.bmp"), img)
            with open(os.path.join(root, split, "labels", f"{i}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    path = os.path.join(root, "data.yaml")
    with open(path, "w") as f:
        f.write(f"path: {root}\ntrain: [train/images]\nval: [val/images]\nnc: 2\nnames:\n"
                + "".join(f"  {i}: {c}\n" for i, c in enumerate(YOLO_CLASSES)))
    return path


def write_detections(root, seed=0):
    """A detections CSV over the val images: each GT box jittered (conf U[0.3,
    1], its label flipped one time in five) and one false positive an image
    (conf U[0.1, 0.6])."""
    rng = np.random.default_rng(seed)
    rows = ["image_path,xmin,ymin,xmax,ymax,conf,detection_label"]
    images = os.path.join(root, "val", "images")
    for name in sorted(os.listdir(images)):
        with open(os.path.join(root, "val", "labels", name.replace(".bmp", ".txt"))) as f:
            for line in f:
                c, xc, yc, bw, bh = map(float, line.split())
                j = rng.normal(0, 0.02, 4)
                box = np.clip([xc - bw / 2 + j[0], yc - bh / 2 + j[1], xc + bw / 2 + j[2],
                               yc + bh / 2 + j[3]], 0, 1)
                label = int(c) if rng.random() > 0.2 else 1 - int(c)
                rows.append(f"{os.path.join(images, name)},{box[0]:.6f},{box[1]:.6f},"
                            f"{box[2]:.6f},{box[3]:.6f},{rng.uniform(0.3, 1):.4f},{label}")
        x0, y0 = rng.uniform(0, 0.7, 2)
        rows.append(f"{os.path.join(images, name)},{x0:.6f},{y0:.6f},{x0 + 0.2:.6f},"
                    f"{y0 + 0.2:.6f},{rng.uniform(0.1, 0.6):.4f},{int(rng.integers(0, 2))}")
    path = os.path.join(root, "detections.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def start_export_shipped():
    """EXPORT (5)'s first two subprocesses, started by SHIPPED once (a) has
    written its run (they run beside the phases between):
    configs/yolo_crops_config.py through ``python -m nkbx_torch.train`` (its
    data path, run directory, n_epochs (2) and workers edited;
    mobilenetv3_large_100, pretrained without a file, FocalLoss,
    export_serving) over a seeded YOLO-layout set, and SHIPPED (a)'s run of
    configs/singletask_config.py through ``python -m nkbx_torch.export --to
    serving`` into its weights/best.nkbx (128 px, batch 64)."""
    run, workers = SHIPPED_RUN["run"], SHIPPED_RUN["workers"]
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)  # EXPORT's directory starts here
    root = os.path.abspath(os.path.join(EXPORT_DIR, "shipped"))
    yolo_data = os.path.join(root, "yolo")
    yaml_path = write_yolo_set(yolo_data)
    yolo_run = os.path.join(root, "yolo_run")
    yolo_cfg = shipped_config("yolo_crops_config", [
        ('yolo_yaml = "data/yolo_dataset.yaml"', f'yolo_yaml = "{yaml_path}"', 1),
        ('"path": f"data/runs/{experiment_name}"', f'"path": "{yolo_run}"', 1),
        ("n_epochs = 30", "n_epochs = 2", 1), (*workers, 2)], os.path.join(root, "yolo.py"))
    env = {k: v for k, v in os.environ.items() if k != "NKBX_PRETRAINED_DIR"}
    return {"root": root, "yolo_data": yolo_data, "yaml": yaml_path, "yolo_run": yolo_run,
            "t0": time.perf_counter(),
            "yolo": start_cli(["-m", "nkbx_torch.train", "-cfg", yolo_cfg],
                              "export_yolo_train.log", env),
            "export": start_cli(["-m", "nkbx_torch.export", "-cfg",
                                 os.path.join(SHIPPED_DIR, "singletask.py"), "--to", "serving",
                                 "-w", os.path.join(run, "weights", "best.pt"), "--input-shape",
                                 str(BUCKET), "128", "128", "3", "--save_path",
                                 os.path.join(run, "weights")], "export_singletask.log")}


def start_export_checks(started):
    """EXPORT (5)'s second half, started at EXPORT's start: the two
    subprocesses of start_export_shipped collected (the yolo_crops run must
    leave best.nkbx and last.nkbx), then the eval and inference CLIs on
    SHIPPED (a)'s best.nkbx and ``python -m nkbx_torch.det_cls_val`` on the
    yolo_crops run's, at once (finish_export_checks holds them). Returns
    (the numbers so far, the handles, the configs)."""
    from nkbx_torch.utils import load_config

    run, paths, workers = SHIPPED_RUN["run"], SHIPPED_RUN["paths"], SHIPPED_RUN["workers"]
    root = started["root"]
    out = {}
    _, secs = finish_cli(started["export"],
                         "python -m nkbx_torch.export on configs/singletask_config.py's run")
    out["singletask_export_s"] = secs
    finish_cli(started["yolo"], "python -m nkbx_torch.train on configs/yolo_crops_config.py")
    out["yolo_train_s"] = time.perf_counter() - started["t0"]
    weights = os.path.join(started["yolo_run"], "weights")
    have = [n for n in ("best.nkbx", "last.nkbx", "best.pt", "last.pt")
            if os.path.exists(os.path.join(weights, n))]
    log(f"export shipped: python -m nkbx_torch.train on configs/yolo_crops_config.py "
        f"(export_serving) exit 0 by {out['yolo_train_s']:.1f} s after it started; {have}")
    if len(have) != 4:
        fail("the yolo_crops run did not leave best.nkbx and last.nkbx")
    edits = paths + [('train_run_path = "data/runs/train_singletask_run_1"',
                      f'train_run_path = "{run}"', 1)]
    eval_save, infer_save = os.path.join(root, "eval"), os.path.join(root, "infer")
    eval_cfg = shipped_config("eval_config", edits + [
        ('save_path = "data/runs/val_singletask_run_1"', f'save_path = "{eval_save}"', 1),
        workers + (1,)], os.path.join(root, "eval.py"))
    infer_cfg = shipped_config("inference_config", [
        ('save_path = "data/runs/infer_singletask_run_1"', f'save_path = "{infer_save}"', 1),
        ('train_run_path = "data/runs/train_singletask_run_1"', f'train_run_path = "{run}"', 1),
        ('"folder_path": "data/unknown_images"', f'"folder_path": "{SHIPPED_RUN["folder"]}"', 1),
        workers + (1,)], os.path.join(root, "inference.py"))
    for cfg_path in (eval_cfg, infer_cfg):
        if not load_config(cfg_path).model.get("scripted"):
            fail(f"the edited {cfg_path} lost scripted: True")
    det_out = os.path.join(root, "det_cls_val")
    clis = {name: start_cli(["-m", f"nkbx_torch.{name}", "-cfg", cfg], f"export_{name}.log")
            for name, cfg in (("eval", eval_cfg), ("inference", infer_cfg))}
    clis["det_cls_val"] = start_cli(
        ["-m", "nkbx_torch.det_cls_val", "--config", started["yaml"], "--detections",
         write_detections(started["yolo_data"]), "--weights_classifier",
         os.path.join(weights, "best.nkbx"), "--img_size", "128", "-pad", "--output_folder",
         det_out], "export_det_cls_val.log")
    return out, (clis, time.perf_counter()), {"eval": eval_save, "infer": infer_save,
                                              "infer_cfg": infer_cfg, "det": det_out}


def finish_export_checks(pending):
    """EXPORT (5) held: eval's balanced accuracy and loss within 1e-3
    relative of SHIPPED (b)'s rebuilt model, inference's labels equal to
    SHIPPED (c)'s but where the rebuilt model's top two logits lie within 2
    bf16 ulps (counted); det_cls_val's CSVs and finite APs."""
    from nkbx_torch.data import get_inference_dataset
    from nkbx_torch.train import build_predict_fn
    from nkbx_torch.utils import load_config

    out, (clis, t0), paths = pending
    run = SHIPPED_RUN["run"]
    eval_save, infer_save, infer_cfg = paths["eval"], paths["infer"], paths["infer_cfg"]
    for name in ("eval", "inference"):
        finish_cli(clis[name], f"the {name} CLI on best.nkbx")
    out["eval_inference_s"] = time.perf_counter() - t0

    with open(os.path.join(eval_save, "metrics.json")) as f:
        metrics = json.load(f)
    rebuilt = SHIPPED_RUN["out"]
    d_acc = abs(metrics["epoch_acc"] - rebuilt["eval_acc"]) / max(rebuilt["eval_acc"], 1e-12)
    loss = float(np.mean(metrics["loss"]))
    d_loss = abs(loss - rebuilt["eval_loss"]) / abs(rebuilt["eval_loss"])
    out["eval"] = {"acc": metrics["epoch_acc"], "loss": loss, "rel_diff_acc": d_acc,
                   "rel_diff_loss": d_loss}
    log(f"export shipped: python -m nkbx_torch.eval on configs/eval_config.py (scripted: True, "
        f"best.nkbx): balanced accuracy {metrics['epoch_acc']:.8f} against the rebuilt model's "
        f"{rebuilt['eval_acc']:.8f} (rel {d_acc:.3e}), loss {loss:.8f} against "
        f"{rebuilt['eval_loss']:.8f} (rel {d_loss:.3e}); tol 1e-3")
    if d_acc > 1e-3 or d_loss > 1e-3:
        fail("the eval CLI on the bundle disagrees with the rebuilt model")

    with open(os.path.join(infer_save, "inference_annotations.csv")) as f:
        head, *lines = [line.rstrip("\n").split(",") for line in f]
    got = {p: label for label, p in lines}
    cfg = load_config(infer_cfg)
    model = get_model({"task": "single", "model": "resnet14t",
                       "checkpoint": os.path.join(run, "weights", "best.pt")},
                      SHIPPED_CLASSES, input_size=(cfg.img_size, cfg.img_size),
                      dtype=torch.bfloat16)
    loader = get_inference_dataset(cfg.inference_data, cfg.inference_pipeline)
    predict = build_predict_fn(model, augment_fn=loader.pipeline.device_apply)
    near = {}
    for batch in loader.epoch(0):
        top2 = predict(torch.from_numpy(batch["image"]).to(DEV)).float().topk(2, dim=-1)
        for p, (a, b), v in zip(batch["path"], top2.values.cpu().numpy(), batch["mask"]):
            if v:
                near[p] = a - b <= 2 * bf16_ulp(abs(a))
    want = SHIPPED_RUN["labels"]
    differ = [p for p in want if got.get(p) != want[p]]
    ties = sum(near[p] for p in want)
    out["inference"] = {"rows": len(lines), "differ": len(differ), "near_ties": int(ties)}
    log(f"export shipped: python -m nkbx_torch.inference on configs/inference_config.py "
        f"(scripted: True): {len(lines)} rows, {len(differ)} labels differ from SHIPPED (c)'s, "
        f"{int(ties)} rows with the top two logits within 2 bf16 ulps")
    if (head != ["label", "path"] or len(lines) != len(want) or set(got) != set(want)
            or any(not near[p] for p in differ)):
        fail("the inference CLI on the bundle disagrees with the rebuilt model")

    det_out = paths["det"]
    text, _ = finish_cli(clis["det_cls_val"], "python -m nkbx_torch.det_cls_val")
    aps = [float(v) for v in re.findall(r"(?:detection|classification) ([0-9.]+|nan|-?inf)(?=,|$)",
                                        text, re.M)]
    files = [n for n in ("predictions.csv", "gt.csv", "metrics.csv")
             if os.path.exists(os.path.join(det_out, n))]
    out["det_cls_val"] = {"s": time.perf_counter() - t0, "aps": aps, "files": files}
    log(f"export shipped: python -m nkbx_torch.det_cls_val on best.nkbx: {files}; APs {aps}")
    if len(files) != 3 or not aps or not np.all(np.isfinite(aps)):
        fail("det_cls_val did not write its CSVs or finite APs")
    return out


def check_export():
    """EXPORT: the shipped configs' subprocesses that SHIPPED started are
    collected and the next ones (start_export_checks) and Swin-T's three
    export CLIs start at once (from a best.pt of Swin-T written here); then
    check_export_models, finish_export_checks (which runs no kernel of ours
    in this process) and, once no subprocess is left, check_export_server.
    Returns (the numbers, the fused bundles' launch counts)."""
    t0 = time.perf_counter()
    root = os.path.abspath(EXPORT_DIR)
    set_plain(False)
    torch.save(SWIN.model(torch.bfloat16).module.state_dict(), os.path.join(root, "best.pt"))
    cfg = export_config(os.path.join(root, "swin.py"), os.path.join(root, "classes"),
                        os.path.join(root, "run"), SWIN_CFG, 224)
    common = ["-m", "nkbx_torch.export", "-cfg", cfg, "-w", os.path.join(root, "best.pt")]
    shape = ["--input-shape", str(BUCKET), "224", "224", "3"]
    pending = start_export_checks(SHIPPED_RUN["export_started"])
    started = {
        "portable": start_cli(common + shape + ["--to", "serving", "--save_path",
                                                os.path.join(root, "portable")],
                              "export_portable.log"),
        "fused": start_cli(common + shape + ["--to", "serving", "--dynamic", "none",
                                             "--fused-attention", "--save_path",
                                             os.path.join(root, "fused")], "export_fused.log"),
        "torchscript": start_cli(common + ["--to", "torchscript", "--input-shape", "8", "224",
                                           "224", "3", "--save_path", os.path.join(root, "ts")],
                                 "export_torchscript.log")}
    out = {}
    (servers, swin), counts = check_export_models(started, out)
    zero_counts()
    out["shipped"] = finish_export_checks(pending)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        fail(f"the shipped export path launched port kernels it should not: {read_counts()}")
    check_export_server(servers, swin, started["sweep"], out)
    out["seconds"] = time.perf_counter() - t0
    log(f"export: {json.dumps(out)}")
    log(f"export: the phase took {out['seconds']:.1f} s")
    return out, counts


# --- OPTINS: nkbx's max-throughput opt-ins and the one-card tools ------------------------

OPTINS_DIR = os.path.join("build", "optins_smoke")  # configs, PNGs, converted files
OPTINS_STEPS = 5  # timed steps of each variant, after one warm-up step
OPTINS_MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]  # Normalize's, in pixel units
OPTINS_STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
# bf16 masters: each of the first 5 steps' losses within 4% of the f32 masters' run's, and
# falling. On an NVIDIA H100 80GB HBM3 at 700 W the two runs stood at most 1.53% apart with
# the step rounded twice and 1.77% with it rounded once (PERF.md); 4% is a little over twice
# that, so an update that does not train, or one that drops far more of its steps below half
# a bf16 ulp, fails
MASTER_BAND = 0.04


@contextlib.contextmanager
def deterministic():
    """cuDNN and PyTorch held to deterministic algorithms (warnings where an
    op has none): two runs of the same step then agree bit for bit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2])


@contextlib.contextmanager
def spy(module, name, out):
    """``module.<name>`` records each call's outputs (detached clones) in ``out``."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        y = real(*a, **k)
        ys = y if isinstance(y, tuple) else (y,)
        out.append([t.detach().clone() if torch.is_tensor(t) else
                    [s.detach().clone() for s in t] for t in ys])  # before any stop of a replay
        return y

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def same_outputs(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else all(torch.equal(s, t) for s, t in zip(x, y))
        for p, q in zip(a, b) for x, y in zip(p, q))


def optins_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8), device=DEV)
    labels = torch.as_tensor(rng.integers(0, 10, n), device=DEV)
    return images, labels, torch.ones(n, dtype=torch.bool, device=DEV)


def timed_steps(step, state, batch):
    """One warm-up step, then OPTINS_STEPS timed (host clock, synchronised):
    step ms, peak memory (MB) and each kernel's launches a step; then one
    step under torch.profiler: its device ms (None where the profile holds
    no device time) and the idle share against the timed step."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, *batch, 1.0, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(OPTINS_STEPS):
        state, m = step(state, *batch, 1.0, 1.0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / OPTINS_STEPS * 1e3
    counts = {k: v / OPTINS_STEPS for k, v in read_counts().items() if v}
    out = {"step_ms": step_ms,
           "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
           "launches_per_step": counts, "timed_losses": [float(v) for v in losses]}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, *batch, 1.0, 1.0)
        torch.cuda.synchronize()
    events = device_events(prof)
    out["device_ms"] = device_ms(events, 1) if events else None
    out["idle_share"] = 1 - out["device_ms"] / step_ms if events else None
    return out


def check_remat(path, module, fn, kernel):
    """``remat_stages=(0, 1, 2, 3)`` on ``path``'s train step (bf16, batch
    64, check_train's recipe) against the same step without it, from the
    same weights: one step each under deterministic algorithms, whose
    gradients, updated weights and BatchNorm running statistics must be
    bit-equal, the forward kernel (K5 or K9, its launcher spied at
    ``module.fn``) launched twice as often under remat (the replay runs the
    autograd Function's forward: its saved inputs are packed when it
    returns) and each replayed launch bit-identical to its forward launch;
    then each variant's step ms and peak memory. ``kernel``: the kernel's
    name among the launch counts."""
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize, VerticalFlip

    set_plain(False)
    pipe = Compose([HorizontalFlip(), VerticalFlip(), Normalize()])
    criterion = get_loss({"type": "CrossEntropyLoss"})
    bundle = get_optimizer({"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4,
                            "weight_decay": 0.05})
    batch = optins_batch(BUCKET)
    base = path.model(torch.bfloat16)
    init = {k: v.clone() for k, v in base.module.state_dict().items()}
    del base
    remat_cfg = dict(path.cfg, backbone_opts={**(path.cfg.get("backbone_opts") or {}),
                                              "remat_stages": (0, 1, 2, 3)})
    runs, out = {}, {}
    for label, cfg in (("plain", path.cfg), ("remat", remat_cfg)):
        model = path.model(torch.bfloat16, cfg)
        model.module.load_state_dict(init)
        step = build_train_step(model, criterion, bundle, augment_fn=pipe.device_apply)
        calls = []
        with deterministic(), spy(module, fn, calls):
            zero_counts()
            state = TrainState.create(model, seed=0)
            state, m = step(state, *batch, 1.0, 1.0)
            torch.cuda.synchronize()
        counts = read_counts()
        runs[label] = {"loss": float(m["loss"]), "counts": counts, "calls": calls,
                       "grads": {n: p.grad.clone() for n, p in model.module.named_parameters()},
                       "state": {k: v.clone() for k, v in model.module.state_dict().items()}}
        out[label] = timed_steps(step, TrainState.create(model, seed=0), batch)
        del model, step, state
        torch.cuda.empty_cache()
    p, r = runs["plain"], runs["remat"]
    n = len(p["calls"])
    grads_equal = all(torch.equal(r["grads"][k], v) for k, v in p["grads"].items())
    state_equal = all(torch.equal(r["state"][k], v) for k, v in p["state"].items())
    relaunch_equal = (len(r["calls"]) == 2 * n and same_outputs(r["calls"][:n], p["calls"])
                      and same_outputs(r["calls"][n:][::-1], p["calls"]))
    want = path.counts(torch.bfloat16, True)
    want_remat = dict(want, **{kernel: 2 * want[kernel]})
    res = {"loss": {k: v["loss"] for k, v in runs.items()}, "grads_bit_equal": grads_equal,
           "weights_and_running_stats_bit_equal": state_equal,
           "recomputed_launches_bit_identical": relaunch_equal,
           "launches_first_step": {k: {c: v for c, v in runs[k]["counts"].items() if v}
                                   for k in runs}, **out}
    log(f"optins remat {path.label}: {json.dumps(res)}")
    got = {k: {c: runs[k]["counts"][c] for c in want} for k in runs}
    if got["plain"] != want or got["remat"] != want_remat:
        fail(f"remat {path.label}: launches {got}, want {want} and {want_remat}")
    if not (grads_equal and state_equal and relaunch_equal) or p["loss"] != r["loss"]:
        fail(f"remat {path.label} changed numbers: {res}")
    return res, {k: sum(runs[x]["counts"][k] for x in runs) for k in COUNTED}


def check_input_norm():
    """resnet50 exact BN at batch 128 (bench.py's program): the model with
    ``input_norm`` (Normalize folded into the s2d stem) on the raw batch
    against the unfolded model on the Normalize'd batch, the same weights,
    eval-mode logits: in bf16 within 5% of the largest (PERF.md section 2's
    bf16 rule), in f32 within 1e-3 of it. (In train mode, BatchNorm over a
    random-init net turns bf16 rounding into 12% of the largest logit for
    either model against f32, on the CPU as well.) Then each bf16 train step
    (flips only for the folded model, flips + Normalize for the other)
    timed."""
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    classes = [f"c{i}" for i in range(1000)]
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 255, (EXACT_BATCH, 224, 224, 3), dtype=np.uint8),
                             device=DEV)
    labels = torch.as_tensor(rng.integers(0, 1000, EXACT_BATCH), device=DEV)
    mask = torch.ones(EXACT_BATCH, dtype=torch.bool, device=DEV)
    folded_cfg = {"model": "resnet50",
                  "backbone_opts": {"input_norm": (OPTINS_MEAN, OPTINS_STD)}}
    out, models = {}, {}
    for dt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.05)):
        plain = get_model(RESNET_EXACT.cfg, classes, seed=0, dtype=dt)
        folded = get_model(folded_cfg, classes, seed=0, dtype=dt)
        folded.module.load_state_dict(plain.module.state_dict())
        normalized = Compose([Normalize()]).device_apply(images, out_dtype=dt)
        with torch.no_grad():
            want = plain.module.eval()(normalized).float()
            got = folded.module.eval()(images.to(dt)).float()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        out[DTYPE_NAME[dt]] = {"logits_max_abs_err": err, "logits_max": scale}
        if not err <= tol * scale:
            fail(f"input_norm {DTYPE_NAME[dt]}: logits {err} off the unfolded model's "
                 f"(limit {tol * scale})")
        models = {"normalize": plain, "input_norm": folded}
    for label, pipe in (("normalize", Compose([HorizontalFlip(p=0.5), Normalize()])),
                        ("input_norm", Compose([HorizontalFlip(p=0.5)]))):
        state, step = sgd_step(models[label], False, pipe.device_apply)
        out[label] = timed_steps(step, state, (images, labels, mask))
    log(f"optins input_norm (resnet50, batch {EXACT_BATCH}): {json.dumps(out)}")
    return out


def check_master_weights():
    """bf16_master_weights on resnet50 exact BN at batch 128 (bench.py's
    program, sgd at lr 0.1, flips + Normalize): 5 steps with bf16 master
    parameters beside 5 with f32 masters from the same weights: each step's
    loss within MASTER_BAND of the f32 run's and falling, parameters and
    moments bf16,
    running statistics f32; step ms and peak memory of each."""
    from nkbx_torch.train import TrainState
    from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

    classes = [f"c{i}" for i in range(1000)]
    rng = np.random.default_rng(0)
    batch = (torch.as_tensor(rng.integers(0, 255, (EXACT_BATCH, 224, 224, 3), dtype=np.uint8),
                             device=DEV),
             torch.as_tensor(rng.integers(0, 1000, EXACT_BATCH), device=DEV),
             torch.ones(EXACT_BATCH, dtype=torch.bool, device=DEV))
    pipe = Compose([HorizontalFlip(p=0.5), Normalize()])
    out = {}
    for label, master in (("f32", None), ("bf16", torch.bfloat16)):
        model = get_model(RESNET_EXACT.cfg, classes, seed=0, dtype=torch.bfloat16)
        _, step = sgd_step(model, False, pipe.device_apply)
        state = TrainState.create(model, seed=0, master_dtype=master)
        losses = []
        for _ in range(5):
            state, m = step(state, *batch, 1.0, 1.0)
            losses.append(float(m["loss"]))
        dtypes = sorted({str(p.dtype) for p in model.module.parameters()}
                        | {str(t.dtype) for st in state.opt_state.values() for t in st.mu})
        stats = sorted({str(b.dtype) for b in model.module.buffers()})
        out[label] = {"losses": losses, "param_and_moment_dtypes": dtypes, "stat_dtypes": stats,
                      **timed_steps(step, state, batch)}
        del model, step, state
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(out["bf16"]["losses"], out["f32"]["losses"])]
    out["loss_rel_diff"] = rel
    log(f"optins bf16_master_weights (resnet50, batch {EXACT_BATCH}): {json.dumps(out)}")
    bf = out["bf16"]["losses"]
    if (max(rel) > MASTER_BAND or not np.isfinite(bf).all() or not bf[-1] < bf[0]
            or out["bf16"]["param_and_moment_dtypes"] != ["torch.bfloat16"]
            or out["bf16"]["stat_dtypes"] != ["torch.float32"]):
        fail(f"bf16_master_weights: {out}")
    return out


OPTINS_REFERENCE = '''\
import albumentations as A
import cv2
from albumentations.pytorch import ToTensorV2

device = "cuda:0"
enable_gradient_scaler = True
task = "single"
train_data = {{"type": "ImageFolder", "root": "{data}/train", "batch_size": 64}}
val_data = {{"type": "ImageFolder", "root": "{data}/val", "batch_size": 64}}
train_pipeline = A.Compose([
    A.LongestMaxSize(224, always_apply=True),
    A.PadIfNeeded(224, 224, border_mode=cv2.BORDER_CONSTANT, value=0),
    A.HorizontalFlip(p=0.5), A.RandomBrightnessContrast(p=0.5),
    A.Normalize(), ToTensorV2()])
val_pipeline = A.Compose([
    A.LongestMaxSize(224, always_apply=True),
    A.PadIfNeeded(224, 224, border_mode=cv2.BORDER_CONSTANT, value=0),
    A.Normalize(), ToTensorV2()])
model = {{"task": task, "model": "swin_tiny_patch4_window7_224", "pretrained": False}}
optimizer = {{"type": "nadam", "lr": 1e-4}}
criterion = {{"task": task, "type": "CrossEntropyLoss"}}
'''


def check_tools(best_pt, data):
    """The one-card tools through their CLIs, subprocesses on the card (the
    first three at once):
    (a) ``--to-torch`` on swin_tiny's ``best.pt``: the torch file converted
        forward again and loaded gives logits bit-equal to ``best.pt``'s
        (bf16, a batch of 64 through K1 and K5), the forwards recorded by
        ``profile_trace``;
    (b) ``python -m nkbx_torch.core.profiling`` on that trace, and its
        aggregation's K1 and K5 ms against ``key_averages``' of the same
        profiler;
    (c) ``save_augs`` N = 16 over ``data`` with the trainer's train pipeline
        (flips, Normalize): each PNG equals the device stage's output on the
        same draws (a generator seeded 0), un-normalised here;
    (d) ``migrate --check`` on a reference-format config written here.
    Returns (results, launch counts of (a)'s forwards)."""
    from nkbx_torch.core.runtime import profile_trace
    from nkbx_torch.data import get_dataset, imread_rgb
    from nkbx_torch.models.convert import (convert_reference_checkpoint, from_jax_variables,
                                           load_torch_checkpoint)
    from nkbx_torch.save_augs import unnormalize_params
    from nkbx_torch.transforms import Compose, Normalize
    from nkbx_torch.utils import load_config

    out = {}
    name = "swin_tiny_patch4_window7_224"
    pth = os.path.join(OPTINS_DIR, "swin_tiny.pth")
    cfg_path = os.path.join(OPTINS_DIR, "save_augs_config.py")
    with open(cfg_path, "w") as f:
        f.write(trainer_config(data, os.path.join(OPTINS_DIR, "unused_run")))
    pngs = os.path.join(OPTINS_DIR, "augs")
    shutil.rmtree(pngs, ignore_errors=True)
    old = os.path.join(OPTINS_DIR, "reference_config.py")
    with open(old, "w") as f:
        f.write(OPTINS_REFERENCE.format(data=data))
    new = os.path.join(OPTINS_DIR, "reference_config_nkbx.py")
    t0 = time.perf_counter()  # the three CLIs at once; nothing is timed meanwhile
    started = {
        "to_torch": start_cli(["-m", "nkbx_torch.models.convert", "--to-torch", "--model", name,
                               "--weights", best_pt, "--out", pth], "optins_to_torch.log"),
        "save_augs": start_cli(["-m", "nkbx_torch.save_augs", "-cfg", cfg_path, "-n", "16",
                                "-o", pngs], "optins_save_augs.log"),
        "migrate": start_cli(["-m", "nkbx_torch.utils.migrate", old, "-o", new, "--check"],
                             "optins_migrate.log")}
    logs = {k: finish_cli(v, f"optins {k}", timeout=300)[0] for k, v in started.items()}
    out["clis_s"] = time.perf_counter() - t0
    classes = [f"class{i}" for i in range(N_CLASSES)]
    trained = get_model({"model": name}, classes, seed=0, dtype=torch.bfloat16)
    trained.module.load_state_dict(torch.load(best_pt, map_location="cpu", weights_only=True))
    back = get_model({"model": name}, classes, seed=1, dtype=torch.bfloat16)
    tree = convert_reference_checkpoint(name, load_torch_checkpoint(pth))
    back.module.load_state_dict(from_jax_variables(tree, reference=back.module))
    x = Compose([Normalize()]).device_apply(optins_batch(BUCKET, seed=3)[0],
                                            out_dtype=torch.bfloat16)
    traces = os.path.join(OPTINS_DIR, "trace")
    shutil.rmtree(traces, ignore_errors=True)
    zero_counts()
    with torch.no_grad(), profile_trace(traces) as prof:
        a, b = trained.module.eval()(x), back.module.eval()(x)
    counts = read_counts()
    out["to_torch_logits_bit_equal"] = bool(torch.equal(a, b))
    out["to_torch_launches"] = {k: v for k, v in counts.items() if v}
    if not out["to_torch_logits_bit_equal"] or not counts["window_attention"]:
        fail(f"--to-torch round trip: {out}")

    agg = aggregate_trace(traces)
    events = device_events(prof)
    want = dict.fromkeys(COUNTED, 0)
    want.update(ln_mlp=counts["ln_mlp"], window_attention=counts["window_attention"])
    for kernel in ("window_attention", "ln_mlp"):
        ms, tms = kernel_ms(events, kernel, 2, want), kernel_ms(agg["by_name"], kernel, 2, want)
        out[f"{kernel}_ms_per_forward"] = {"key_averages": ms, "trace": tms}
        if not tms or abs(tms - ms) > 1e-3 * ms + 1e-3:
            fail(f"profile_trace: the trace's {kernel} ms {tms} is not key_averages' {ms}")
    text, _ = finish_cli(start_cli(["-m", "nkbx_torch.core.profiling", traces, "--top", "5"],
                                   "optins_profiling.log"), "the profiling CLI", timeout=300)
    out["profiling_cli"] = text.splitlines()[:1]
    if "port kernels" not in text:
        fail(f"python -m nkbx_torch.core.profiling: no port kernel in {text[-2000:]}")

    if "Saved 16 augmented samples" not in logs["save_augs"]:
        fail(f"save_augs: {logs['save_augs'][-2000:]}")
    cfg = load_config(cfg_path)
    loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    mean, std, maxv = unnormalize_params(loader.pipeline)
    batch = next(iter(loader.epoch(0)))
    gen = torch.Generator(device=DEV).manual_seed(0)
    aug = loader.pipeline.device_apply(torch.as_tensor(batch["image"], device=DEV),
                                       generator=gen).cpu().numpy()
    want_png = np.clip((aug * std + mean) * maxv, 0, 255).astype(np.uint8)[:16]
    got = [imread_rgb(os.path.join(pngs, f"aug_{i}.png")) for i in range(16)]
    out["save_augs_equal"] = all(np.array_equal(g, w) for g, w in zip(got, want_png))
    if not out["save_augs_equal"]:
        fail("save_augs: the PNGs differ from the device stage on the same draws")

    out["migrate_check_ok"] = "check ok" in logs["migrate"]
    with open(new) as f:
        if not out["migrate_check_ok"] or "import nkbx.transforms as T" not in f.read():
            fail(f"migrate --check: {logs['migrate'][-2000:]}")
    log(f"optins tools: {json.dumps(out)}")
    return out, counts


def check_optins(best_pt=None, data=None):
    """OPTINS (``--optins`` alone): remat on convnext_tiny (K5/K6) and on the
    resnet50 ghost2_fused step (K9/K10), input_norm, bf16 master weights and
    the tools. Without the trainer path's ``best.pt`` and ImageFolder it
    makes them: a swin_tiny ``best.pt`` of seeded random weights and the
    same seeded ImageFolder. Returns (results, the phase's launch counts)."""
    os.makedirs(OPTINS_DIR, exist_ok=True)
    if best_pt is None:
        best_pt = os.path.join(OPTINS_DIR, "best.pt")
        model = get_model({"model": "swin_tiny_patch4_window7_224"},
                          [f"class{i}" for i in range(N_CLASSES)], seed=0)
        torch.save(model.module.state_dict(), best_pt)
        data = os.path.join(OPTINS_DIR, "data")
        shutil.rmtree(data, ignore_errors=True)
        write_image_folder(data)
    t0 = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)
    out = {}
    for label, path, module, fn, kernel in (
            ("convnext", CONVNEXT, M, "_forward", "ln_mlp"),
            ("resnet", RESNET, BN, "fused_chain_fwd", "bottleneck")):
        with path.environment():
            out[f"remat_{label}"], counts = check_remat(path, module, fn, kernel)
        total = {k: total[k] + counts[k] for k in total}
    out["input_norm"] = check_input_norm()
    out["bf16_master_weights"] = check_master_weights()
    out["tools"], counts = check_tools(best_pt, data)
    total = {k: total[k] + counts[k] for k in total}
    out["seconds"] = time.perf_counter() - t0
    log(f"optins: {out['seconds']:.1f} s")
    return out, total


# --- the probe path: the command-line probes of X1 and X2 ---------------------------

PROBE_ITERS = 3  # timed launches a shape in each probe


def drive_probes():
    """The probe path: the probes a user runs, ``python -m
    nkbx_torch.ops.matmul_bn``, ``python -m nkbx_torch.ops.grouped_conv
    --wide`` and ``python -m nkbx_torch.ops.layout`` (their ``main``), with
    every count set to 0 just before and read just after. Each launches its
    kernels PROBE_ITERS + 2 times a shape. Their outputs are held too: X1
    within one bf16 ulp and 1e-4 (sums) of the plain version, X2 within 4
    bf16 ulps of cuDNN's largest output, X3-X7 equal to their plain versions
    and the library calls."""
    zero_counts()
    wgmma0 = MB.fused_matmul_bn_relu_stats.wgmma_launches
    mb_rows = MB.main(iters=PROBE_ITERS)
    gc_rows = GC.main(wide=True, iters=PROBE_ITERS)
    layout_rows = L.main(iters=PROBE_ITERS)
    torch.cuda.synchronize()
    counts = read_counts()
    wgmma = MB.fused_matmul_bn_relu_stats.wgmma_launches - wgmma0
    want = dict.fromkeys(COUNTED, 0)
    want["matmul_bn"] = len(MB.SHAPES) * (PROBE_ITERS + 2)
    want["grouped_conv"] = len(GC.STAGES) * (PROBE_ITERS + 2)
    for name, (mod, fn) in COUNTED.items():
        if mod is L:
            want[name] = sum(c[2] is getattr(L, fn) for c in L.probe_cases()) * (PROBE_ITERS + 2)
    log(f"path probe: launches {counts} (expect {want}); X1's on its route {wgmma}")
    if counts != want or wgmma != want["matmul_bn"]:
        fail("the probes did not go through X1-X7 as expected")
    bad = [r for r in mb_rows if not (r["y_ulps"] <= 1 and r["sums_rel"] <= 1e-4)]
    bad += [r for r in gc_rows if not r["max_abs_d"] <= 4 * bf16_ulp(r["library_max"])]
    bad += [r for r in layout_rows if not r["equal"]]
    if bad:
        fail(f"a probe's kernel disagrees with its reference: {bad}")
    return counts, wgmma


# --- DIST: data parallelism over ranks (A10) ---------------------------------------

DIST_DIR = os.path.join("build", "dist_smoke")  # rank 0's states, configs and runs
DIST_SGD = {"type": "sgd", "backbone_lr": 1e-3, "classifier_lr": 1e-2}
RESNET50_GHOST2 = {"model": "resnet50", "backbone_opts": {"ghost_bn": GHOST,
                                                          "fused_bottleneck": True}}
# (label, model config, global batch, mixup, kernels every rank launches, dtype, sgd steps)
DIST_CASES = (
    ("resnet50_exact", {"model": "resnet50"}, EXACT_BATCH, None, (), "bf16", 3),
    ("resnet50_ghost2_fused", RESNET50_GHOST2, EXACT_BATCH, None,
     ("bottleneck", "bottleneck_bwd"), "bf16", 3),
    ("swin_tiny_cutmix", SWIN_CFG, BUCKET, {"cutmix_alpha": 1.0},
     ("window_attention", "window_attention_bwd", "ln_mlp", "ln_mlp_bwd"), "bf16", 3),
    ("resnet50_exact_f32_dropout", {"model": "resnet50", "classifier_dropout": 0.1}, 32, None,
     (), "f32", 1),
)
DIST_LOSS_TOL = 5e-3  # PERF.md §2: losses within 0.5%
# floors of the rules against the yardstick (world 1 on a 1-ulp-perturbed input):
# the update's relative L2 and each running statistic's largest difference
DIST_FLOOR = {"bf16": (1e-2, 1e-3), "f32": (1e-3, 1e-4)}
DIST_CLI_TOL = 1e-3  # f32 trainer CLI: metrics.csv values, relative
DIST_NCCL_TURNS = 4  # turns of (5 steps with the group of one rank, 5 steps without)


def dist_run(cfg, batch, mixup, mesh, dtype, steps, perturb=False):
    """``steps`` sgd steps of a model at full width from seed 0 on seeded
    uint8 batches of ``batch`` rows (flips + Normalize on the card), in
    ``dtype`` ("bf16"; "f32" with TF32 off): the global batch without
    ``mesh``, this rank's rows under it; ``perturb`` multiplies the
    normalised input by 1 + ulp·N(0, 1) (one ulp of the dtype: the
    yardstick of what rounding alone moves). Returns (losses, each step's
    launches, the host state dicts before and after, the port kernels'
    launches in a profile of the last step)."""
    from torch.profiler import ProfilerActivity, profile

    from nkbx_torch.core.profiling import categorize_kernel
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer

    model = get_model(cfg, [f"class{i}" for i in range(N_CLASSES)], input_size=(224, 224),
                      seed=0, dtype=DT[dtype], device=DEV)
    init = {k: v.detach().float().cpu() for k, v in model.module.state_dict().items()}
    state = TrainState.create(model, seed=0)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer(DIST_SGD), augment_fn=dist_stage(dtype, perturb),
                            mixup=mixup, mesh=mesh)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (steps, batch, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, N_CLASSES, (steps, batch))
    rows = mesh.rows(batch // mesh.data) if mesh is not None else slice(None)
    losses, launches = [], []
    for i in range(steps):
        x = torch.from_numpy(np.ascontiguousarray(images[i][rows])).to(DEV)
        y = torch.from_numpy(np.ascontiguousarray(labels[i][rows])).to(DEV)
        m = torch.ones(x.shape[0], dtype=torch.bool, device=DEV)
        zero_counts()
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if i == steps - 1 else contextlib.nullcontext())
        with ctx as prof:
            state, metrics = step(state, x, y, m, 1.0, 1.0)
            torch.cuda.synchronize()
        launches.append({k: v for k, v in read_counts().items() if v})
        losses.append(float(metrics["loss"]))
    profiled = sum(e.count for _, e in device_events(prof)
                   if categorize_kernel(e.key) == "port kernels")
    final = {k: v.detach().float().cpu() for k, v in model.module.state_dict().items()}
    del model, state, step
    torch.cuda.empty_cache()
    return losses, launches, init, final, profiled


def dist_rank(out, mode):
    """A rank of DIST (``--dist-rank OUT gloo|nccl``, torchrun's variables in
    the environment): each case's steps on this rank's rows, rank 0's final
    state saved for the caller; writes OUT/rank<r>.json."""
    import hashlib

    import torch.distributed as dist

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = initialize(distributed=True, device=None if mode == "nccl" else "cuda:0")
    mesh = make_mesh()
    res = {"rank": mesh.rank, "backend": info["backend"], "device": str(info["device"]),
           "cases": {}}
    for label, cfg, batch, mixup, _, dtype, steps in DIST_CASES:
        losses, launches, _, final, profiled = dist_run(cfg, batch, mixup, mesh, dtype, steps)
        if mesh.rank == 0:
            torch.save(final, os.path.join(out, f"{label}.pt"))
        digest = hashlib.sha256(b"".join(final[k].numpy().tobytes() for k in sorted(final)))
        res["cases"][label] = {"losses": losses, "launches": launches, "profiled": profiled,
                               "digest": digest.hexdigest()}
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def dist_env(rank, world, port):
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(out, mode, n=2):
    os.makedirs(out, exist_ok=True)
    port = free_port()
    return [start_cli([os.path.abspath(__file__), "--dist-rank", out, mode],
                      f"dist_rank{r}_{mode}.log", env=dist_env(r, n, port)) for r in range(n)]


def dist_distance(got, want, init):
    """(the update's relative L2 distance: |got − want| / |want − init| over
    every parameter; the largest difference of a running statistic over its
    tensor's largest value)."""
    params = [k for k in want if "running" not in k and "num_batches" not in k]
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in params)
    den = sum(float(((want[k] - init[k]) ** 2).sum()) for k in params)
    stats = max((float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
                 for k in want if "running" in k), default=0.0)
    return (num / max(den, 1e-30)) ** 0.5, stats


def hold_dist(mode, ranks, out, ref):
    """The ranks of ``mode`` against the world of 1 (``ref``: each case's
    run and its run on a 1-ulp-perturbed input, the yardstick): every rank
    launched what the world of 1 launched each step, its case's kernels
    included, and its profile of the last step holds them; the same
    parameters on every rank; each loss within 0.5% (or twice the
    yardstick's, where that is larger); the update (final − initial
    weights) and each running statistic within twice the yardstick's
    distance plus DIST_FLOOR (PERF.md §2's rule for ReLU nets, whose gates
    near 0 fall either way under rounding). Returns the rows to report and
    each rank's launches of every kernel over all its steps."""
    for r, started in enumerate(ranks):
        finish_cli(started, f"DIST {mode} rank {r}", timeout=600)
    runs = []
    for r in range(len(ranks)):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            runs.append(json.load(f))
    rows = {}
    for label, _, batch, _, kernels, dtype, _ in DIST_CASES:
        (want_losses, want_launches, init, want, _), (y_losses, _, _, y, _) = ref[label]
        got = torch.load(os.path.join(out, f"{label}.pt"))
        cases = [run["cases"][label] for run in runs]
        if len({c["digest"] for c in cases}) != 1:
            fail(f"DIST {mode} {label}: the ranks' parameters differ")
        for r, c in enumerate(cases):
            for i, counts in enumerate(c["launches"]):
                missing = [k for k in kernels if not counts.get(k)]
                if missing or counts != want_launches[i]:
                    fail(f"DIST {mode} {label}: rank {r} launched {counts} in step {i}, the "
                         f"world of 1 {want_launches[i]} (none of {missing})")
            if kernels and not c["profiled"]:
                fail(f"DIST {mode} {label}: rank {r}'s profile holds no kernel of ours")
        loss = [abs(a - b) / abs(b) for a, b in zip(cases[0]["losses"], want_losses)]
        y_loss = [abs(a - b) / abs(b) for a, b in zip(y_losses, want_losses)]
        update, stats = dist_distance(got, want, init)
        y_update, y_stats = dist_distance(y, want, init)
        f_update, f_stats = DIST_FLOOR[dtype]
        rows[label] = {"dtype": dtype, "loss_rel_err": loss, "yardstick_loss_rel_err": y_loss,
                       "update_rel_l2": update, "yardstick_update_rel_l2": y_update,
                       "stats_err": stats, "yardstick_stats_err": y_stats,
                       "losses_world2": cases[0]["losses"], "losses_world1": want_losses,
                       "launches_per_step": {f"rank{r}": c["launches"][-1]
                                             for r, c in enumerate(cases)},
                       "profiled_port_kernels": {f"rank{r}": c["profiled"]
                                                 for r, c in enumerate(cases)}}
        log(f"DIST {mode} {label} (global batch {batch}): {json.dumps(rows[label])}")
        if (any(a > max(DIST_LOSS_TOL, 2 * b) for a, b in zip(loss, y_loss))
                or update > 2 * y_update + f_update or stats > 2 * y_stats + f_stats):
            fail(f"DIST {mode} {label}: world 2 against world 1 off the rule: losses {loss} "
                 f"(yardstick {y_loss}), update {update:.3g} ({y_update:.3g}), running "
                 f"statistics {stats:.3g} ({y_stats:.3g})")
    totals = []
    for run in runs:
        log(f"DIST {mode} rank {run['rank']}: backend {run['backend']}, device {run['device']}")
        total = dict.fromkeys(COUNTED, 0)
        for c in run["cases"].values():
            for counts in c["launches"]:
                for k, v in counts.items():
                    total[k] += v
        totals.append(total)
    return rows, totals


def dist_trainer_config(data, run, distributed):
    """check_trainer's config in f32 with sgd for 1 epoch; ``distributed``
    for the ranks under torchrun."""
    text = trainer_config(data, run)
    for old, new in (("enable_mixed_precision = True", "enable_mixed_precision = False"),
                     ("n_epochs = 2", "n_epochs = 1"),
                     ('"n_epochs": 2', '"n_epochs": 1')):
        text = text.replace(old, new)
    text = re.sub(r"optimizer = \{[^}]*\}", "optimizer = " + json.dumps(DIST_SGD), text)
    return text + f"distributed = {distributed}\n"


def dist_nccl(out):
    """``--dist-nccl OUT``: a world of one rank over NCCL (torchrun's
    variables in the environment): the resnet50 ghost2_fused step at batch
    64 with the group (its collectives run) and the same step without it, in
    turns, and one profiled step of each; writes OUT/nccl.json."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import make_mesh
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import spec as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = initialize(distributed=True)
    mesh = make_mesh()
    cfg = RESNET50_GHOST2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8)).to(DEV)
    y = torch.from_numpy(rng.integers(0, N_CLASSES, BUCKET)).to(DEV)
    m = torch.ones(BUCKET, dtype=torch.bool, device=DEV)
    steps = {}
    for name, mh in (("group", mesh), ("no_group", None)):
        model = get_model(cfg, [f"class{i}" for i in range(N_CLASSES)], input_size=(224, 224),
                          seed=0, dtype=torch.bfloat16, device=DEV)
        state = TrainState.create(model, seed=0)
        step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                                get_optimizer(DIST_SGD),
                                augment_fn=T.Compose([T.Normalize()]).device_apply, mesh=mh)
        steps[name] = [step, state]
    times = {name: [] for name in steps}
    counts = {}
    for turn in range(DIST_NCCL_TURNS + 1):  # the first turn warms up
        for name, st in steps.items():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                st[1], metrics = st[0](st[1], x, y, m, 1.0, 1.0)
            float(metrics["loss"])
            if turn:
                times[name].append((time.perf_counter() - t0) / 5 * 1e3)
            counts[name] = {k: v // 5 for k, v in read_counts().items() if v}
    profiled = {}
    for name, st in steps.items():  # where the group's time goes: device ms, NCCL's launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            st[1], metrics = st[0](st[1], x, y, m, 1.0, 1.0)
            torch.cuda.synchronize()
        events = device_events(prof)
        profiled[name] = {"device_ms": sum(us for us, _ in events) / 1e3,
                          "launches": sum(e.count for _, e in events),
                          "nccl_launches": sum(e.count for _, e in events
                                               if "nccl" in e.key.lower()),
                          "nccl_ms": sum(us for us, e in events if "nccl" in e.key.lower()) / 1e3}
    with open(os.path.join(out, "nccl.json"), "w") as f:
        json.dump({"backend": info["backend"], "device": str(info["device"]),
                   "step_ms": times, "launches_per_step": counts, "profiled_step": profiled}, f)
    dist.barrier()
    dist.destroy_process_group()


# (c) FSDP: vit_base with the fused flags (K3-K6 on every rank), its state scattered
FSDP_KERNELS = ("attention", "attention_bwd", "ln_mlp", "ln_mlp_bwd")
FSDP_OPT = {"type": "nadam", "backbone_lr": 1e-5, "classifier_lr": 1e-4, "weight_decay": 0.05}
FSDP_EMA = 0.9
FSDP_STEPS = 3
FSDP_RATIO = 0.502  # a rank's state at rest with fsdp over the replicated rank's, at most


def dist_stage(dtype, perturb):
    """DIST's device stage (flips + Normalize); ``perturb`` multiplies the
    normalised input by 1 + ulp·N(0, 1) (one ulp of the dtype: the
    yardstick of what rounding alone moves)."""
    from nkbx_torch.transforms import spec as T

    stage = T.Compose([T.HorizontalFlip(), T.Normalize()]).device_apply
    if not perturb:
        return stage
    gen = torch.Generator(device=DEV).manual_seed(11)
    ulp = 2.0 ** (-8 if dtype == "bf16" else -23)

    def augment(image, out_dtype=None, generator=None):
        x = stage(image, out_dtype=torch.float32, generator=generator)
        noise = torch.randn(x.shape, generator=gen, device=DEV)
        return (x * (1 + ulp * noise)).to(out_dtype)

    return augment


def fsdp_run(mesh, fsdp, perturb=False):
    """``FSDP_STEPS`` bf16 nadam steps of vit_base (the fused flags) with
    its EMA, from seed 0 on seeded batches of BUCKET rows (flips +
    Normalize): the global batch without ``mesh``, this rank's rows under
    it, the state scattered with ``fsdp``. Returns (numbers: losses, each
    step's launches, host ms and peak MB, the state's MB at rest, the last
    step's profile; the initial weights on the host; the whole state after
    the steps on the card: parameters, EMA shadow, moments)."""
    from torch.profiler import ProfilerActivity, profile

    from nkbx_torch.core.profiling import categorize_kernel
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer

    model = get_model(VIT_CFG, [f"class{i}" for i in range(N_CLASSES)], input_size=(224, 224),
                      seed=0, dtype=torch.bfloat16, device=DEV)
    init = {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in model.module.state_dict().items()}
    state = TrainState.create(model, seed=0, ema=True, mesh=mesh, fsdp=fsdp)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer(FSDP_OPT), augment_fn=dist_stage("bf16", perturb),
                            ema_decay=FSDP_EMA, mesh=mesh)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (FSDP_STEPS, BUCKET, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, N_CLASSES, (FSDP_STEPS, BUCKET))
    rows = mesh.rows(BUCKET // mesh.data) if mesh is not None else slice(None)
    out = {"state_mb": state.nbytes() / 2 ** 20, "scattered": len(state.scattered[0].params)
           if state.scattered else 0, "losses": [], "launches": [], "step_ms": [], "peak_mb": []}
    for i in range(FSDP_STEPS):
        x = torch.from_numpy(np.ascontiguousarray(images[i][rows])).to(DEV)
        y = torch.from_numpy(np.ascontiguousarray(labels[i][rows])).to(DEV)
        m = torch.ones(x.shape[0], dtype=torch.bool, device=DEV)
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if i == FSDP_STEPS - 1 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx as prof:
            state, metrics = step(state, x, y, m, 1.0, 1.0)
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["peak_mb"].append(torch.cuda.max_memory_allocated() / 2 ** 20)
        out["launches"].append({k: v for k, v in read_counts().items() if v})
        out["losses"].append(float(metrics["loss"]))
    events = device_events(prof)
    out["profile_ms"] = {k: kernel_ms(events, k, 1, out["launches"][-1]) for k in FSDP_KERNELS}
    out["profiled_port_kernels"] = sum(e.count for _, e in events
                                       if categorize_kernel(e.key) == "port kernels")
    out["state_mb_after"] = state.nbytes() / 2 ** 20
    whole = {}
    with state.gathered(state.module), state.gathered(state.ema_module):
        for part, mod in (("module", state.module), ("ema", state.ema_module)):
            whole.update({f"{part}/{k}": v.detach().clone() for k, v in mod.state_dict().items()})
        for label, st in state.opt_state.items():
            for kind in ("mu", "nu"):
                for j, t in enumerate(state.whole(state.groups[label], getattr(st, kind))):
                    whole[f"{label}/{kind}/{j}"] = t.detach().clone()
    del model, state, step
    torch.cuda.empty_cache()
    return out, init, whole


def bf16_ulps(got, want):
    """|got − want|'s largest element in bf16 ulps of ``want``'s largest
    magnitude."""
    top = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / bf16_ulp(max(top, 1e-30))


def fsdp_reference(perturb):
    """fsdp_run in one process (the world of 1), its final weights on the
    host."""
    out, init, whole = fsdp_run(None, False, perturb)
    final = {k[len("module/"):]: v.float().cpu() for k, v in whole.items()
             if k.startswith("module/")}
    return out, init, final


def dist_fsdp_rank(out):
    """A rank of DIST (c) (``--dist-fsdp OUT``, torchrun's variables in the
    environment, gloo on cuda:0): fsdp_run replicated, then scattered, on
    the same inputs; the whole states compared on the host (bit for bit,
    and in bf16 ulps of each tensor's largest value); rank 0 saves the
    scattered run's final weights; writes OUT/rank<r>.json."""
    import torch.distributed as dist

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(distributed=True, device="cuda:0")
    mesh = make_mesh()
    res = {"rank": mesh.rank}
    res["replicated"], _, want = fsdp_run(mesh, False)
    want = {k: v.cpu() for k, v in want.items()}  # off the card: each run's peak its own
    res["fsdp"], _, got = fsdp_run(mesh, True)
    got = {k: v.cpu() for k, v in got.items()}
    differ = sorted(k for k in want if not torch.equal(got[k], want[k]))
    res["not_bit_equal"] = differ
    res["worst_bf16_ulps"] = max((bf16_ulps(got[k], want[k]), k) for k in differ) if differ else [
        0.0, ""]
    res["n_tensors"] = len(want)
    if mesh.rank == 0:
        torch.save({k[len("module/"):]: v.float() for k, v in got.items()
                    if k.startswith("module/")}, os.path.join(out, "vit_fsdp.pt"))
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def hold_fsdp(ranks, out, ref):
    """DIST (c)'s ranks against their replicated runs and against the world
    of 1 (``ref``: fsdp_run without a mesh, and on a 1-ulp-perturbed input)
    by hold_dist's rule; returns the numbers to report and each rank's
    launches of every kernel over its scattered steps."""
    for r, started in enumerate(ranks):
        finish_cli(started, f"DIST (c) fsdp rank {r}", timeout=600)
    runs = []
    for r in range(len(ranks)):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            runs.append(json.load(f))
    (want, init, want_final), (y, _, y_final) = ref
    got = torch.load(os.path.join(out, "vit_fsdp.pt"))
    row, totals = {"card": torch.cuda.get_device_name(0)}, {}
    for run in runs:
        r, a, b = run["rank"], run["replicated"], run["fsdp"]
        if run["worst_bf16_ulps"][0] > 1.0 or a["losses"] != b["losses"]:
            fail(f"DIST (c) rank {r}: fsdp against replicated: losses {b['losses']} against "
                 f"{a['losses']}, {len(run['not_bit_equal'])} of {run['n_tensors']} tensors not "
                 f"bit-equal, worst {run['worst_bf16_ulps']} bf16 ulps")
        for i, counts in enumerate(b["launches"]):
            if any(counts.get(k) != 12 for k in FSDP_KERNELS) or counts != a["launches"][i]:
                fail(f"DIST (c) rank {r}: step {i} launched {counts}, the replicated step "
                     f"{a['launches'][i]}; K3-K6 12 each wanted")
        if not all(b["profile_ms"][k] > 0 for k in FSDP_KERNELS):
            fail(f"DIST (c) rank {r}: the profile of the last step misses K3-K6: "
                 f"{b['profile_ms']}")
        ratio = b["state_mb"] / a["state_mb"]
        if ratio > FSDP_RATIO or b["scattered"] == 0:
            fail(f"DIST (c) rank {r}: the state at rest is {ratio:.4f} of the replicated "
                 f"rank's ({b['state_mb']:.1f} against {a['state_mb']:.1f} MB)")
        row[f"rank{r}"] = {
            "bit_equal": not run["not_bit_equal"], "not_bit_equal": run["not_bit_equal"][:20],
            "worst_bf16_ulps": run["worst_bf16_ulps"], "losses": b["losses"],
            "scattered_params": b["scattered"],
            "state_mb": {"fsdp": b["state_mb"], "replicated": a["state_mb"], "ratio": ratio},
            "peak_mb": {"fsdp": b["peak_mb"], "replicated": a["peak_mb"]},
            "step_ms": {"fsdp": b["step_ms"], "replicated": a["step_ms"]},
            "launches_per_step": b["launches"][-1], "profile_ms": b["profile_ms"],
            "profiled_port_kernels": b["profiled_port_kernels"]}
        totals[f"dist_fsdp_rank{r}"] = {k: sum(c.get(k, 0) for c in b["launches"])
                                        for k in COUNTED}
    loss = [abs(a - b) / abs(b) for a, b in zip(runs[0]["fsdp"]["losses"], want["losses"])]
    y_loss = [abs(a - b) / abs(b) for a, b in zip(y["losses"], want["losses"])]
    update, _ = dist_distance(got, want_final, init)
    y_update, _ = dist_distance(y_final, want_final, init)
    row.update({"loss_rel_err": loss, "yardstick_loss_rel_err": y_loss, "update_rel_l2": update,
                "yardstick_update_rel_l2": y_update, "losses_world1": want["losses"],
                "world1_peak_mb": want["peak_mb"], "world1_step_ms": want["step_ms"]})
    log(f"DIST (c) fsdp, vit_base at global batch {BUCKET}: {json.dumps(row)}")
    if (any(a > max(DIST_LOSS_TOL, 2 * b) for a, b in zip(loss, y_loss))
            or update > 2 * y_update + DIST_FLOOR["bf16"][0]):
        fail(f"DIST (c): fsdp world 2 against world 1 off the rule: losses {loss} (yardstick "
             f"{y_loss}), update {update:.3g} ({y_update:.3g})")
    return row, totals


def check_dist():
    """DIST (A10; also ``--dist`` alone): data parallelism over ranks, the
    ranks subprocesses, every rank's failure the run's.

    (a) Two ranks on the one card over gloo (``device="cuda:0"``; NCCL
        refuses two ranks on one device), started first, against the world
        of 1 here, each case also run here on a 1-ulp-perturbed input (the
        yardstick): 3 bf16 sgd steps of resnet50 exact BN and resnet50
        ghost2_fused at a global batch of 128 (64 a rank) and swin_tiny at
        64 with CutMix (the partners on the other rank), and one f32 step
        (TF32 off) of resnet50 exact BN at 32 with classifier_dropout 0.1
        (each rank keeps its rows of the global batch's mask, drawn from
        the state's generator), where the yardstick is tight.
        Each rank launches its case's kernels every step (K9/K10,
        K1/K2/K5/K6) as the world of 1 does, and its profile of the last
        step holds them; hold_dist's rules.
    (b) The trainer CLI under ``torch.distributed.run --nproc_per_node 2``
        on the card (``--device cuda:0``, gloo), f32, sgd, 1 epoch of
        check_trainer's folder, against the CLI in one process: every
        metrics.csv value but the throughput within 1e-3 relative.
    (c) FSDP: vit_base with the fused flags over 2 gloo ranks on the card,
        its state scattered (``fsdp``; dist_fsdp_rank, hold_fsdp): 3 bf16
        nadam steps with EMA at a global batch of 64 against the replicated
        ranks on the same inputs and against the world of 1 here (and its
        1-ulp yardstick) by (a)'s rule; K3-K6 12 a step on each rank, in the
        last step's profile; the state at rest at most FSDP_RATIO of the
        replicated rank's; each step's peak memory. The trainer CLI as (b)
        with ``fsdp = True`` against (b)'s 2 ranks: metrics.csv within 1e-3
        and last.pt's tensors within 1e-3 of each one's largest value.
    (d) NCCL: a world of one rank runs the ghost2_fused step with its
        group's collectives and without a group, in turns (the step ms of
        each: what the reduction costs in a world of one, read beside (a)-(c),
        which share the card and the host with it); where the machine has 2
        cards, two ranks over NCCL held as in (a).

    Two ranks sharing one card measure nothing of scaling."""
    t0 = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    data = os.path.join(TRAINER_DIR, "data")
    if not os.path.isdir(data):
        write_image_folder(data)
    clis = {}
    for n, name in ((1, "world1"), (2, "world2"), (2, "world2_fsdp")):
        cfg_path = os.path.join(DIST_DIR, f"trainer_{name}.py")
        with open(cfg_path, "w") as f:
            f.write(dist_trainer_config(data, os.path.join(DIST_DIR, f"run_{name}"), n > 1)
                    + ("fsdp = True\n" if name.endswith("fsdp") else ""))
        args = (["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                 "-m", "nkbx_torch.train", "-cfg", cfg_path, "--device", "cuda:0"] if n > 1
                else ["-m", "nkbx_torch.train", "-cfg", cfg_path])
        clis[name] = start_cli(args, f"dist_trainer_{name}.log")
    ranks = start_ranks(os.path.join(DIST_DIR, "gloo"), "gloo")  # beside the world of 1
    fsdp_dir = os.path.join(DIST_DIR, "fsdp")
    os.makedirs(fsdp_dir)
    port = free_port()
    fsdp_ranks = [start_cli([os.path.abspath(__file__), "--dist-fsdp", fsdp_dir],
                            f"dist_fsdp_rank{r}.log", env=dist_env(r, 2, port)) for r in range(2)]
    nccl_dir = os.path.join(DIST_DIR, "nccl")
    os.makedirs(nccl_dir)
    nccl_world1 = start_cli([os.path.abspath(__file__), "--dist-nccl", nccl_dir], "dist_nccl.log",
                            env=dist_env(0, 1, free_port()))
    ref = {label: (dist_run(cfg, batch, mixup, None, dtype, steps),
                   dist_run(cfg, batch, mixup, None, dtype, steps, perturb=True))
           for label, cfg, batch, mixup, _, dtype, steps in DIST_CASES}
    fsdp_ref = (fsdp_reference(False), fsdp_reference(True))
    out = {}
    out["gloo"], totals = hold_dist("gloo", ranks, os.path.join(DIST_DIR, "gloo"), ref)
    out["fsdp"], fsdp_totals = hold_fsdp(fsdp_ranks, fsdp_dir, fsdp_ref)
    logs = {n: finish_cli(clis[name], f"DIST trainer CLI, {name}")[0]
            for n, name in ((1, "world1"), (2, "world2"))}
    if "backend gloo" not in logs[2] or "rank 1 of 2" not in logs[2]:
        fail("DIST (b): the trainer's ranks did not report their gloo group")
    rows = [read_metrics_csv(os.path.join(DIST_DIR, f"run_world{n}", "metrics.csv"))
            for n in (1, 2)]
    worst = 0.0
    for a, b in zip(*rows, strict=True):
        for key, v in a.items():
            if key in ("Epoch", "train images/sec/chip") or not v:
                continue
            worst = max(worst, abs(float(b[key]) - float(v)) / max(abs(float(v)), 1e-30))
    out["trainer_cli_metrics_rel_err"] = worst
    log(f"DIST (b) trainer CLI, 2 ranks against 1, f32: metrics.csv within {worst:.3g}")
    if worst > DIST_CLI_TOL:
        fail(f"DIST (b): metrics.csv of 2 ranks differs from 1 rank's by {worst:.3g}")
    out["fsdp_trainer_cli"] = check_fsdp_cli(finish_cli(clis["world2_fsdp"],
                                                        "DIST trainer CLI, world2_fsdp")[0])
    finish_cli(nccl_world1, "DIST (d) NCCL world of 1")
    with open(os.path.join(nccl_dir, "nccl.json")) as f:
        nccl = json.load(f)
    for name in ("group", "no_group"):
        if not (nccl["launches_per_step"][name].get("bottleneck")
                and nccl["launches_per_step"][name].get("bottleneck_bwd")):
            fail(f"DIST (d): the {name} step launched no K9/K10")
    nccl["median_ms"] = {k: float(np.median(v)) for k, v in nccl["step_ms"].items()}
    nccl["overhead_ms"] = nccl["median_ms"]["group"] - nccl["median_ms"]["no_group"]
    out["nccl_world1"] = nccl
    log(f"DIST (d) NCCL world of 1, resnet50 ghost2_fused at batch {BUCKET}: {json.dumps(nccl)}")
    if torch.cuda.device_count() >= 2:
        out["nccl"], _ = hold_dist("nccl", start_ranks(os.path.join(DIST_DIR, "nccl2"), "nccl"),
                                   os.path.join(DIST_DIR, "nccl2"), ref)
    else:
        log("DIST (d): one card, so no two-rank NCCL world")
    out["seconds"] = time.perf_counter() - t0
    log(f"DIST: {out['seconds']:.1f} s")
    shutil.rmtree(DIST_DIR, ignore_errors=True)  # ~300 MB of states
    return out, {**{f"dist_rank{r}": t for r, t in enumerate(totals)}, **fsdp_totals}


def check_fsdp_cli(log_text):
    """DIST (c)'s trainer CLI with ``fsdp = True`` against (b)'s 2 ranks:
    its log reports the scattered state, metrics.csv within DIST_CLI_TOL,
    last.pt's tensors within DIST_CLI_TOL of each one's largest value."""
    m = re.search(r"fsdp: (\d+) of (\d+) parameters scattered over 2 ranks; the state at rest "
                  r"([0-9.]+) MiB", log_text)
    if m is None:
        fail("DIST (c): the fsdp trainer's log does not report its scattered state")
    runs = [os.path.join(DIST_DIR, f"run_{name}") for name in ("world2", "world2_fsdp")]
    a, b = (read_metrics_csv(os.path.join(r, "metrics.csv")) for r in runs)
    worst = 0.0
    for ra, rb in zip(a, b, strict=True):
        for key, v in ra.items():
            if key in ("Epoch", "train images/sec/chip") or not v:
                continue
            worst = max(worst, abs(float(rb[key]) - float(v)) / max(abs(float(v)), 1e-30))
    want, got = (torch.load(os.path.join(r, "weights", "last.pt"), map_location="cpu")
                 for r in runs)
    if got.keys() != want.keys():
        fail("DIST (c): the fsdp trainer's last.pt holds other tensors")
    weights = max(float((got[k].double() - want[k].double()).abs().max())
                  / max(float(want[k].double().abs().max()), 1e-30) for k in want)
    row = {"scattered": int(m.group(1)), "parameters": int(m.group(2)),
           "state_mib_a_rank": float(m.group(3)), "metrics_rel_err": worst,
           "last_pt_rel_err": weights,
           "last_pt_bit_equal": all(torch.equal(got[k], want[k]) for k in want)}
    log(f"DIST (c) trainer CLI, fsdp against 2 replicated ranks, f32: {json.dumps(row)}")
    if worst > DIST_CLI_TOL or weights > DIST_CLI_TOL:
        fail(f"DIST (c): the fsdp trainer differs from the replicated one: {row}")
    return row


def dist_only():
    """``--dist``: the card's name and power limit, the kernels of the
    phase built (K1-K6, K9, K10) and DIST alone, its numbers as the last
    line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["window_attention", "window_attention_bwd", "attention", "attention_bwd",
                  "ln_mlp", "ln_mlp_bwd", "bottleneck", "bottleneck_bwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    out, counts = check_dist()
    log(json.dumps({"dist": out, "counts": counts}))


def main():
    t_start = time.perf_counter()
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

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {phase_s[name]} s (whole run so far "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out

    attn_rows, attn_err = timed("attention", check_attention)
    mlp_rows, mlp_err = timed("mlp", check_mlp)
    attn_bwd_rows, attn_bwd_err = timed("attention_bwd", check_attention_bwd)
    mlp_bwd_rows, mlp_bwd_err = timed("mlp_bwd", check_mlp_bwd)
    sep_rows, sep_err = timed("sep_attention", check_sep_attention)
    sep_bwd_rows, sep_bwd_err = timed("sep_attention_bwd", check_sep_attention_bwd)
    mlp_only_rows, mlp_only_err = timed("mlp_only", check_mlp_only)
    mlp_only_bwd_rows, mlp_only_bwd_err = timed("mlp_only_bwd", check_mlp_only_bwd)
    chain_rows, chain_err = timed("chain", check_chain)
    mb_rows, mb_err = timed("matmul_bn", check_matmul_bn)
    gc_rows, gc_err = timed("grouped_conv", check_grouped_conv)
    layout_rows, layout_err = timed("layout", check_layout)
    served, trained = {}, {}
    for p in PATHS:
        if p.serves:
            with p.environment():
                served[p.label] = timed(f"serve_{p.label}", check_path, p)
    for p in PATHS:
        with p.environment():
            trained[p.label] = timed(f"train_{p.label}", check_train, p)
    resnet_step = timed("resnet_step", check_resnet_step)
    exact = timed("resnet_exact", check_resnet_exact)
    bench = timed("bench", check_bench, exact)
    masked = timed("resnet_masked", check_resnet_masked)
    log(f"resnet50 exact BN (batch {EXACT_BATCH}) and masked BN (batch {BUCKET}): "
        f"{json.dumps({'exact': exact, 'masked_vs_exact_batch64': masked})}")
    dropout = timed("dropout", check_dropout)
    log(f"bench and dropout: {json.dumps({'bench': bench, 'dropout': dropout})}")
    trainer_counts = timed("trainer", check_trainer)
    served["trainer"] = trained["trainer"] = trainer_counts
    probe_counts, probe_wgmma = timed("probes", drive_probes)
    probed = {"probe": probe_counts}
    timed("shipped", check_shipped)
    zoo, served["zoo"] = timed("zoo", check_zoo)
    resample, served["resample"] = timed("resample", check_resample)
    log(f"zoo and resample: {json.dumps({'zoo': zoo, 'resample': resample})}")
    _, modern_counts = timed("modern", check_modern)
    served["modern"] = trained["modern"] = modern_counts
    served["heavy"] = trained["heavy"] = timed("heavy", check_heavy)
    _, served["export"] = timed("export", check_export)
    optins, served["optins"] = timed("optins", check_optins,
        os.path.join(TRAINER_DIR, "run_cli", "weights", "best.pt"),
        os.path.join(TRAINER_DIR, "data"))
    trained["optins"] = served["optins"]
    dist_out, dist_counts = timed("dist", check_dist)
    log(f"phase seconds: {json.dumps(phase_s)}")
    served.update(dist_counts)
    trained.update(dist_counts)

    fwd, step = "one bucket-64 swin_tiny forward, bf16", "one batch-64 swin_tiny train step, bf16"
    vfwd = ("one bucket-64 vit_base_patch16_224 forward, bf16 (12 launches at N=197, bias and "
            "mask None; library: SDPA unmasked; *_zeros: with the (1, N, N) zeros against SDPA's "
            "float mask; *_learned: a learned (12, N, N) bias and a (1, N, N) mask against SDPA "
            "given their sum), cold L2")
    vstep = ("one batch-64 vit_base_patch16_224 train step, bf16 (12 launches at N=197, bias and "
             "mask None; library: SDPA's unmasked backward; *_zeros, *_learned as for K3, no "
             "dbias), cold L2")
    cfwd = ("one bucket-64 convnext_tiny forward under NKBX_FUSED_LN_MLP=0, bf16 (3/3/9/3 "
            "launches), cold L2")
    cstep = ("one batch-64 convnext_tiny train step under NKBX_FUSED_LN_MLP=0, bf16 (3/3/9/3 "
             "launches), cold L2")
    rfwd = "the forward of one batch-64 resnet50 ghost_bn=2 train step, bf16 (2/3/5 launches)"
    rstep = "the backward of one batch-64 resnet50 ghost_bn=2 train step, bf16 (2/3/5 launches)"
    chain_fwd = [chain_rows[f"stage {s}"] for s in (1, 2, 3)]
    chain_bwd = [{k: r["bwd_" + k] for k in ("ms", "first_ms", "plain_ms", "bound_ms", "bound_by",
                                             "bound_share")}
                 for r in chain_fwd]
    chain_mult = tuple(k for k, *_ in RESNET_STAGES[:3])
    kernels = []
    # each row is one launch at a stage's shape; ``mult`` its launches per forward or step
    for name, src, replaces, rows, err, launched, per, mult in (
            ("window_attention", "nkbx_torch/ops/csrc/window_attention.cu",
             "nkbx/ops/attention.py:302", attn_rows[:4], attn_err, served, fwd, DEPTHS),
            ("ln_mlp", "nkbx_torch/ops/csrc/ln_mlp.cu", "nkbx/ops/mlp.py:504",
             [mlp_rows[f"s{i}"] for i in range(4)], mlp_err, served, fwd, DEPTHS),
            ("window_attention_bwd", "nkbx_torch/ops/csrc/window_attention_bwd.cu",
             "nkbx/ops/attention.py:313", attn_bwd_rows[:4], attn_bwd_err, trained, step,
             DEPTHS),
            ("ln_mlp_bwd", "nkbx_torch/ops/csrc/ln_mlp_bwd.cu", "nkbx/ops/mlp.py:520",
             [mlp_bwd_rows[f"s{i}"] for i in range(4)], mlp_bwd_err, trained, step, DEPTHS),
            ("attention", "nkbx_torch/ops/csrc/attention.cu", "nkbx/ops/attention.py:275",
             [sep_rows["N=197"]], sep_err, served, vfwd, (12,)),
            ("attention_bwd", "nkbx_torch/ops/csrc/attention_bwd.cu",
             "nkbx/ops/attention.py:285", [sep_bwd_rows["N=197"]], sep_bwd_err, trained,
             vstep, (12,)),
            ("mlp", "nkbx_torch/ops/csrc/ln_mlp.cu", "nkbx/ops/mlp.py:250",
             [mlp_only_rows[f"s{i}"] for i in range(4)], mlp_only_err, served, cfwd,
             CONVNEXT_DEPTHS),
            ("mlp_bwd", "nkbx_torch/ops/csrc/ln_mlp_bwd.cu", "nkbx/ops/mlp.py:265",
             [mlp_only_bwd_rows[f"s{i}"] for i in range(4)], mlp_only_bwd_err, trained, cstep,
             CONVNEXT_DEPTHS),
            ("bottleneck", "nkbx_torch/ops/csrc/bottleneck.cu", "nkbx/ops/bottleneck.py:177",
             chain_fwd, chain_err["fwd"], trained, rfwd, chain_mult),
            ("bottleneck_bwd", "nkbx_torch/ops/csrc/bottleneck_bwd.cu",
             "nkbx/ops/bottleneck.py:222", chain_bwd, chain_err["bwd"], trained, rstep,
             chain_mult),
            ("matmul_bn", "nkbx_torch/ops/csrc/matmul_bn.cu",
             "experiments/pallas_fused_matmul_bn.py:30", mb_rows, mb_err, probed,
             "one launch at each of the probe's three shapes, bf16, on the route (wgmma + "
             "TMA), cold L2", (1,) * len(mb_rows)),
            ("grouped_conv", "nkbx_torch/ops/csrc/grouped_conv.cu",
             "experiments/r3_grouped_conv_vpu.py:75", gc_rows, gc_err, probed,
             "one launch at each of resnext50_32x4d's four stages, bf16, cold L2",
             (1,) * len(gc_rows))):
        def total(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(m * v for m, v in zip(mult, vals, strict=True))

        by_path = {label: counts[name] for label, counts in launched.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err["bf16"], "max_abs_err_f32": err["f32"],
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total("library_ms") if "library_ms" in rows[0] else None,
            "per": per,
        })
    for row, (name, replaces, counted) in LAYOUT_ROWS.items():
        rows = layout_rows[row]
        kernels.append({
            "name": name, "route": "cuda", "source": "nkbx_torch/ops/csrc/layout.cu",
            "replaces": replaces, "launches": sum(probed["probe"][c] for c in counted),
            "launches_by_path": {"probe": sum(probed["probe"][c] for c in counted)},
            "max_abs_err": layout_err["bf16"], "max_abs_err_f32": layout_err["f32"],
            **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes", "bound_share": [r["bound_share"] for r in rows],
            "over_library_ms": [r["over_library_ms"] for r in rows],
            "spread_ms": [r["spread_ms"] for r in rows],
            "per": f"one launch at each of {row}'s shapes, bf16: "
                   + ", ".join(r["case"] for r in rows)})
    # K5/K6: the first design's time (through its C entry) and the products alone
    # through torch.matmul (not one call) beside the new design's, each stage's
    # share of the bound; on the other models' paths ConvNeXt-T's stages with its
    # layer-scale (3/3/9/3 launches) and ViT-B's 12 launches at R = 12608 (and
    # bucket 8's 1576); the GEMM route's launches by path; K5's and K6's device
    # ms in the bucket-64 forwards' and the train steps' profiles
    for k, rows, what in ((kernels[1], mlp_rows, "serve"), (kernels[3], mlp_bwd_rows, "train")):
        swin = [rows[f"s{i}"] for i in range(4)]
        k["first_design_ms"] = sum(m * r["first_ms"] for m, r in zip(DEPTHS, swin))
        k["matmul_ms"] = sum(m * r["matmul_ms"] for m, r in zip(DEPTHS, swin))
        k["bound_share"] = {lab: r["bound_share"] for lab, r in rows.items()}
        for key in ("ms", "first_ms", "plain_ms", "matmul_ms", "bound_ms"):
            k[key + "_by_path"] = {
                "convnext_tiny": sum(m * rows[f"cnx-s{i}"][key]
                                     for i, m in enumerate(CONVNEXT_DEPTHS)),
                "vit_base": 12 * rows["vit-b64"][key], "vit_base_bucket8": 12 * rows["vit-b8"][key]}
        k["launches_gemm"] = {f"{p.label}_{w}": n for p in PATHS
                              for (name, w), n in p.gemm_launches.items() if name == k["name"]}
        k["profile_ms"] = {f"{p.label}_{w}": ms for p in PATHS
                           for (name, w), ms in p.profiled.items() if name == k["name"]}
    # K7/K8 the same on ConvNeXt-T's stages (3/3/9/3 launches under
    # NKBX_FUSED_LN_MLP=0), and ViT-B's MLP at R = 12608 and 1576 (12 launches a
    # forward or step of a ViT-B with fused_mlp=True under the switch, a path
    # this run does not drive)
    for k, rows in ((kernels[6], mlp_only_rows), (kernels[7], mlp_only_bwd_rows)):
        cnx = [rows[f"s{i}"] for i in range(4)]
        k["first_design_ms"] = sum(m * r["first_ms"] for m, r in zip(CONVNEXT_DEPTHS, cnx))
        k["matmul_ms"] = sum(m * r["matmul_ms"] for m, r in zip(CONVNEXT_DEPTHS, cnx))
        k["bound_share"] = {lab: r["bound_share"] for lab, r in rows.items()}
        for key in ("ms", "first_ms", "plain_ms", "matmul_ms", "bound_ms"):
            k[key + "_by_path"] = {"vit_base": 12 * rows["vit-b64"][key],
                                   "vit_base_bucket8": 12 * rows["vit-b8"][key]}
        k["launches_gemm"] = {f"{p.label}_{w}": n for p in PATHS
                              for (name, w), n in p.gemm_launches.items() if name == k["name"]}
        k["profile_ms"] = {f"{p.label}_{w}": ms for p in PATHS
                           for (name, w), ms in p.profiled.items() if name == k["name"]}
    # K3 with the zero tensors beside the ViT's None; K3 and X2 shares of their bounds
    kernels[4].update({f"{key}_{how}": 12 * sep_rows["N=197"][f"{key}_{how}"]
                       for how in ("zeros", "learned")
                       for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    kernels[4]["bound_share"] = {lab: sep_rows[lab]["bound_share"]
                                 for lab in ("N=50", "N=197", "N=577")}
    # K4 the same; the ViT train step's K4 device time from its profile
    kernels[5].update({f"{key}_{how}": None if sep_bwd_rows["N=197"][f"{key}_{how}"] is None
                       else 12 * sep_bwd_rows["N=197"][f"{key}_{how}"]
                       for how in ("zeros", "learned")
                       for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    kernels[5]["bound_share"] = {lab: sep_bwd_rows[lab]["bound_share"]
                                 for lab in ("N=50", "N=197", "N=577")}
    kernels[5]["sdpa_backend"] = sep_bwd_rows["N=197"]["backend"]
    kernels[5]["profile_ms_per_step"] = VIT.profiled.get(("attention_bwd", "train"))
    # K3/K4 on each ViT path's profile: vit_base at N = 197, unicom_b16 at N = 196
    for k in kernels[4:6]:
        k["profile_ms"] = {f"{p.label}_{w}": ms for p in (VIT, UNICOM)
                           for (name, w), ms in p.profiled.items() if name == k["name"]}
    kernels[11]["bound_share"] = [r["bound_share"] for r in gc_rows]
    # X1: the first design's cold ms (through its C entry) beside the route's, each
    # shape's share of the bound, and the probe path's launches on the route
    kernels[10]["first_design_ms"] = sum(r["first_ms"] for r in mb_rows)
    kernels[10]["bound_share"] = {r["shape"]: r["bound_share"] for r in mb_rows}
    kernels[10]["launches_wgmma"] = {"probe": probe_wgmma}
    # K2: cold-L2 shares of the bound, SDPA's backend, window 12, the tensor-core
    # launches of the Swin-T train path and its step's K2 device time (the reduction in)
    kernels[2]["bound_share"] = {r["stage"]: r["bound_share"] for r in attn_bwd_rows}
    kernels[2]["sdpa_backend"] = attn_bwd_rows[0]["backend"]
    kernels[2].update({f"{key}_w12": attn_bwd_rows[4][key]
                       for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    kernels[2]["launches_tc_swin_train"] = SWIN.tc_launches[("window_attention_bwd", "train")]
    kernels[2]["profile_ms_per_step"] = SWIN.profiled.get(("window_attention_bwd", "train"))
    # K1 the same (cold-L2 shares, window 12, its first design's cold ms beside), the
    # tensor-core launches of the Swin-T serving and train paths, and its device time
    # in a bucket-64 forward's and a train step's profile
    kernels[0]["bound_share"] = {r["stage"]: r["bound_share"] for r in attn_rows}
    kernels[0]["sdpa_backend"] = attn_rows[0]["backend"]
    kernels[0]["first_design_ms"] = sum(m * r["first_ms"]
                                        for m, r in zip(DEPTHS, attn_rows[:4], strict=True))
    kernels[0].update({f"{key}_w12": attn_rows[4][key]
                       for key in ("ms", "first_ms", "plain_ms", "library_ms", "bound_ms")})
    kernels[0]["launches_tc_swin_serve"] = SWIN.tc_launches[("window_attention", "serve")]
    kernels[0]["launches_tc_swin_train"] = SWIN.tc_launches[("window_attention", "train")]
    kernels[0]["profile_ms_per_forward"] = SWIN.profiled.get(("window_attention", "serve"))
    kernels[0]["profile_ms_per_step"] = SWIN.profiled.get(("window_attention", "train"))
    # K10 is held by each gradient's relative L2 (check_chain): its worst, beside max|err|
    kernels[9]["max_rel_l2"], kernels[9]["max_rel_l2_f32"] = (chain_err["bwd_l2"]["bf16"],
                                                              chain_err["bwd_l2"]["f32"])
    # K9/K10: the first design's cold ms (through the launch helpers) beside the
    # tensor-core route's, each stage's share of the bound, the route's launches
    # on the ResNet train path, and the device ms of each in the profiled step
    for k, rows, key in ((kernels[8], chain_fwd, "k9_ms"), (kernels[9], chain_bwd, "k10_ms")):
        k["first_design_ms"] = sum(m * r["first_ms"] for m, r in zip(chain_mult, rows))
        k["bound_share"] = {f"stage {i}": r["bound_share"] for i, r in enumerate(rows, 1)}
        k["launches_tc"] = RESNET.tc_launches[(k["name"], "train")]
        k["profile_ms_per_step"] = resnet_step[key]
    kernels[9]["resnet_step"] = resnet_step
    # K5/K6 and K9/K10 under remat_stages=(0, 1, 2, 3): launches a step (OPTINS)
    for k, what in ((kernels[1], "remat_convnext"), (kernels[3], "remat_convnext"),
                    (kernels[8], "remat_resnet"), (kernels[9], "remat_resnet")):
        k["launches_per_step_remat"] = optins[what]["remat"]["launches_per_step"].get(k["name"])
    # K1/K2/K5/K6 (swin_tiny) and K9/K10 (resnet50 ghost2_fused) on every rank of DIST (a):
    # launches a step, each rank's own count
    for k, label in ((kernels[0], "swin_tiny_cutmix"), (kernels[1], "swin_tiny_cutmix"),
                     (kernels[2], "swin_tiny_cutmix"), (kernels[3], "swin_tiny_cutmix"),
                     (kernels[8], "resnet50_ghost2_fused"), (kernels[9], "resnet50_ghost2_fused")):
        k["launches_per_step_by_rank"] = {
            f"{label}_{r}": c.get(k["name"], 0)
            for r, c in dist_out["gloo"][label]["launches_per_step"].items()}
    # K3-K6 (vit_base) on every rank of DIST (c), its state scattered: launches a step
    for k in (kernels[4], kernels[5], kernels[1], kernels[3]):
        k.setdefault("launches_per_step_by_rank", {}).update({
            f"vit_base_fsdp_{r}": dist_out["fsdp"][r]["launches_per_step"].get(k["name"], 0)
            for r in ("rank0", "rank1")})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def resnet_step_only():
    """``--resnet-step``: the card's name and power limit, the chain's kernels
    built, and check_resnet_step alone, its numbers as the last line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["bottleneck", "bottleneck_bwd"])
    log(json.dumps({"resnet_step": check_resnet_step()}))


def layout_only():
    """``--layout``: the card's name and power limit, layout.cu built, and
    check_layout alone, its rows as the last line (from a copy of this file
    in another checkout, that checkout's X3-X7 against the same library
    calls)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build(["layout"])
    rows, _ = check_layout()
    log(json.dumps({"layout": rows}))


def modern_only():
    """``--modern``: the card's name and power limit, Swin-T's kernels built
    (K1, K2, K5, K6), and MODERN alone, its numbers as the last line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["window_attention", "window_attention_bwd", "ln_mlp", "ln_mlp_bwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    out, counts = check_modern()
    log(json.dumps({"modern": out, "counts": counts}))


def export_only():
    """``--export``: the card's name and power limit, the forward kernels of
    the exported models built (K1, K3, K5, K7), SHIPPED (a)-(c) for the run
    that EXPORT (5) exports, and EXPORT alone, its numbers as the last
    line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["window_attention", "attention", "ln_mlp"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    check_shipped_cli()
    out, counts = check_export()
    log(json.dumps({"export": out, "counts": counts}))


def heavy_only():
    """``--heavy``: the card's name and power limit and HEAVY alone (it runs
    no kernel of ours, so nothing is built), its launch counts as the last
    line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps({"heavy_counts": check_heavy()}))


def bench_only():
    """``--bench``: the card's name and power limit, RESNET_EXACT, BENCH and
    DROPOUT alone (they run no kernel of ours, so nothing is built), their
    numbers as the last line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact = check_resnet_exact()
    log(json.dumps({"exact": exact, "bench": check_bench(exact), "dropout": check_dropout()}))


def optins_only():
    """``--optins``: the card's name and power limit, the kernels of the
    phase built (K1, K2, K5, K6, K9, K10) and OPTINS alone, its numbers as the
    last line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["window_attention", "window_attention_bwd", "ln_mlp", "ln_mlp_bwd",
                  "bottleneck", "bottleneck_bwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    out, counts = check_optins()
    log(json.dumps({"optins": out, "counts": counts}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--dist-fsdp"]:
        dist_fsdp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--dist-nccl"]:
        dist_nccl(sys.argv[2])
    elif sys.argv[1:] == ["--dist"]:
        dist_only()
    elif sys.argv[1:] == ["--optins"]:
        optins_only()
    elif sys.argv[1:] == ["--resnet-step"]:
        resnet_step_only()
    elif sys.argv[1:] == ["--modern"]:
        modern_only()
    elif sys.argv[1:] == ["--heavy"]:
        heavy_only()
    elif sys.argv[1:] == ["--export"]:
        export_only()
    elif sys.argv[1:] == ["--layout"]:
        layout_only()
    elif sys.argv[1:] == ["--bench"]:
        bench_only()
    else:
        main()
