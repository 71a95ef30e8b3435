"""The train step's options (``build_train_step``'s ``ema_decay``,
``grad_accum_steps``, ``scan_steps``, ``mixup``, ``log_gradients``), their
epoch loop, collectors, checkpoints and trainer keys, against nkbx on the
CPU.

Locksteps: 3 steps of nkbx's ``build_train_step`` against the port's from
the same weights on the same uint8 batches (Normalize on both sides), sgd
with backbone and head lrs and coupled weight decay, a cosine lr factor and
a frozen first step (freeze_scale 0, 1, 1), the last row of each batch
padded. The model is the tiny Swin of tests/test_torch_train.py (no
BatchNorm, GELU, f32) but for EMA, which also averages BatchNorm running
statistics: there the tiered-bottleneck tiny ResNet of
tests/test_torch_resnet.py with ``masked_bn=True`` (exact BatchNorm, its
seed-8 batches). Tolerances as tests/test_torch_train.py's lockstep: loss
per step rtol 1e-4; parameters (and EMA parameters) 2e-6 + 1e-5 relative,
for the ResNet plus tests/test_torch_resnet.py's allowance for a relu gate
within f32 noise of 0 (lr * 3e-2 of the leaf's largest gradient a step);
running statistics 1e-5 + 1e-4 relative; gradient norms rtol 1e-4 (+1e-9).
Mixup is fed the draws nkbx made from its step key (``step.mixup.draw``
replaced), so that both mix the same way.

- EMA (decay 0.9, so that three steps move the shadow): the shadow's
  parameters and running statistics against nkbx's ``ema_params`` and
  ``ema_batch_stats``;
- A = 2 accumulation with CE, class-weighted CE and focal with
  ``ignore_index`` rows, padded rows included; metrics stacked (2, ...);
- ``scan_steps=3`` against nkbx's multi-step, and bit-identical to 3 single
  calls of the port (flips drawn from the state's generator);
- mixup, CutMix and both under A = 2 (CE with label smoothing 0.1);
- gradient norms, keys and values, through the frozen step and under A = 2;
- nkbx's guard errors, with nkbx's messages;
- ``train_epoch``: chunks of K with a shorter last one, ``consumed_batches``
  at a preemption and on resume;
- the exact and bounded collectors on stacked metrics and gradient norms
  against nkbx's ``EpochCollector``;
- EMA checkpoints saved and restored, both ways across EMA;
- a trainer run of a small config in nkbx's form with the recipe's keys
  (RandAugment, mixup with ``mixup_alpha``, label smoothing, EMA, steps per
  dispatch, bounded metrics), where ``best.pt`` equals the saved EMA shadow.
"""

import functools
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models import resnet as jresnet
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.swin import SwinTransformer as JSwin
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.train.engine import EpochCollector as JCollector
from nkbx.transforms import spec as jspec
from nkbx_torch.models import from_jax_variables, get_model, param_labels
from nkbx_torch.models import resnet as tresnet
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.train import (TrainState, build_train_step, get_loss, get_optimizer,
                              get_scheduler, preempt)
from nkbx_torch.train.checkpoint import restore_train_state, save_checkpoint
from nkbx_torch.train.engine import EpochCollector, train_epoch
from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

TINY = dict(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2)
RESNET = dict(stage_sizes=(1, 1), block_cls="Bottleneck", stem="tiered", stem_width=16)
SIZE, BATCH, STEPS = 32, 6, 3
SGD = {"type": "sgd", "backbone_lr": 5e-2, "classifier_lr": 1e-1,
       "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-3}
# the ResNet takes tests/test_torch_resnet.py's lockstep as it is: its sgd and its
# batches of 4 (seed 8)
RESNET_SGD = {"type": "sgd", "backbone_lr": 1e-2, "classifier_lr": 1e-2,
              "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-4}
OPT = {"swin": SGD, "resnet": RESNET_SGD}
BATCHES = {"swin": BATCH, "resnet": 4}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]
GATE_FLIP = 3e-2  # of a leaf's largest gradient: one ResNet relu gate on the other side
CE = {"type": "CrossEntropyLoss"}
SMOOTH = {"type": "CrossEntropyLoss", "label_smoothing": 0.1}
CASES = {
    "ema": ("resnet", {"ema_decay": 0.9}, CE),
    "accum-ce": ("swin", {"grad_accum_steps": 2}, CE),
    "accum-weighted-ce": ("swin", {"grad_accum_steps": 2},
                          {"type": "CrossEntropyLoss", "weight": [1.0, 2.5, 0.5]}),
    "accum-focal-ignore": ("swin", {"grad_accum_steps": 2}, {"type": "FocalLoss", "gamma": 2.0}),
    "mixup": ("swin", {"mixup": {"alpha": 0.4}}, SMOOTH),
    "cutmix": ("swin", {"mixup": {"cutmix_alpha": 1.0}}, SMOOTH),
    "mixup-accum": ("swin", {"mixup": {"alpha": 0.4, "cutmix_alpha": 1.0},
                             "grad_accum_steps": 2}, SMOOTH),
    "grad-norms": ("swin", {"log_gradients": True}, CE),
    "grad-norms-accum": ("swin", {"log_gradients": True, "grad_accum_steps": 2}, CE),
}


# --- the two models --------------------------------------------------------------------


def _jax_module(net):
    if net == "swin":
        backbone = JSwin(dtype=jnp.float32, fused_attention=False, fused_mlp=False, **TINY)
    else:
        backbone = jresnet.ResNet(dtype=jnp.float32,
                                  **dict(RESNET, block_cls=jresnet.Bottleneck))
    return JSingle(backbone=backbone, n_classes=3)


@functools.lru_cache(maxsize=None)
def _variables(net):
    """nkbx's initial variables, every leaf perturbed (running variances
    kept positive)."""
    module = _jax_module(net)
    variables = jax.device_get(jax.jit(lambda x: module.init(jax.random.PRNGKey(0), x,
                                                             train=False))(
        jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port_model(net):
    if net == "swin":
        backbone = SwinTransformer(dtype=torch.float32, img_size=(SIZE, SIZE), **TINY)
    else:
        backbone = tresnet.ResNet(dtype=torch.float32,
                                  **dict(RESNET, block_cls=tresnet.Bottleneck))
    module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(_variables(net), reference=module))
    return ClassificationModel(module.eval(), list("abc"), "single", backbone.num_features,
                               (SIZE, SIZE), torch.float32, torch.device("cpu"))


def _batches(case, steps=STEPS):
    net, _, loss_cfg = CASES.get(case, ("swin", None, CE))
    b = BATCHES[net]
    rng = np.random.default_rng(8 if net == "resnet" else 7)
    images = rng.integers(0, 256, (steps, b, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (steps, b)).astype(np.int64)
    mask = np.ones((steps, b), bool)
    mask[:, -1] = False
    images[:, -1] = 0  # the loader's padded row
    if loss_cfg["type"] == "FocalLoss":
        labels[:, 1] = -100  # ignored rows, one in each microbatch but the last
    return images, labels, mask


def _nkbx_mix_draws(cfg, key, shape):
    """The draws nkbx's mix makes from ``key``, in the port's layout."""
    alpha, cutmix_alpha = float(cfg.get("alpha", 0.0)), float(cfg.get("cutmix_alpha", 0.0))
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    use_cutmix = (cutmix_alpha > 0.0 if alpha <= 0.0 else
                  cutmix_alpha > 0.0 and bool(jax.random.bernoulli(k_switch,
                                                                   cfg.get("switch_prob", 0.5))))
    a = cutmix_alpha if use_cutmix else alpha
    lam0 = jax.random.beta(k_lam_c if use_cutmix else k_lam_m, a, a)
    ky, kx = jax.random.split(k_box)
    return {"apply": torch.tensor(bool(jax.random.bernoulli(k_apply, cfg.get("prob", 1.0)))),
            "use_cutmix": torch.tensor(use_cutmix), "lam0": torch.tensor(np.float32(lam0)),
            "cy": torch.tensor(int(jax.random.randint(ky, (), 0, shape[1]))),
            "cx": torch.tensor(int(jax.random.randint(kx, (), 0, shape[2])))}


def _mix_draws(cfg, steps=STEPS):
    """nkbx's mix key of step i: split(fold_in(key, i), 3)[2] (engine.py:174-176)."""
    return [_nkbx_mix_draws(cfg, jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i),
                                                  3)[2], (BATCH, SIZE, SIZE, 3))
            for i in range(steps)]


@functools.lru_cache(maxsize=None)
def _nkbx_run(case):
    """nkbx's losses, state dicts, EMA state dicts and gradient norms after
    each step."""
    net, opts, loss_cfg = CASES[case]
    variables = _variables(net)
    module = _jax_module(net)
    model = JModel(module, variables, list("abc"), "single", 64)
    bundle = jget_optimizer(variables["params"], OPT[net])
    step = jbuild_train_step(model, jget_loss(loss_cfg), bundle,
                             augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                             masked_bn=net == "resnet", **opts)
    state = JState.create(variables["params"], variables.get("batch_stats", {}), bundle.tx,
                          ema=opts.get("ema_decay", 0) > 0)
    images, labels, mask = _batches(case)
    out = {"loss": [], "state": [], "ema": [], "grad_norms": [], "loss_shape": []}
    for i in range(STEPS):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                              jnp.asarray(mask[i]), jax.random.PRNGKey(0),
                              jnp.asarray(LR_FACTORS[i], jnp.float32),
                              jnp.asarray(FREEZE_SCALES[i], jnp.float32))
        out["loss"].append(np.asarray(metrics["loss"]))
        out["state"].append(from_jax_variables(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats})))
        if state.ema_params is not None:
            out["ema"].append(from_jax_variables(jax.device_get(
                {"params": state.ema_params, "batch_stats": state.ema_batch_stats})))
        if "grad_norms" in metrics:
            out["grad_norms"].append({k: float(v) for k, v in metrics["grad_norms"].items()})
    return out


def _hold(module_sd, want, slack=None):
    """Each entry of ``module_sd`` within the lockstep's bound of ``want``'s,
    a parameter's widened by ``slack`` (the ResNet's relu gates)."""
    for key, value in module_sd.items():
        if key not in want:
            continue
        w = want[key].numpy()
        if key.endswith(("running_mean", "running_var")):
            bound = 1e-5 + 1e-4 * np.abs(w)
        else:
            bound = 2e-6 + 1e-5 * np.abs(w) + (slack or {}).get(key, 0.0)
        err = np.abs(value.numpy() - w)
        assert (err <= bound).all(), (key, float(err.max()), float((err - bound).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_options_lockstep_with_nkbx(case):
    net, opts, loss_cfg = CASES[case]
    want = _nkbx_run(case)
    model = _port_model(net)
    state = TrainState.create(model, ema=opts.get("ema_decay", 0) > 0)
    step = build_train_step(model, get_loss(loss_cfg), get_optimizer(OPT[net]),
                            augment_fn=Compose([Normalize()]).device_apply,
                            masked_bn=net == "resnet", **opts)
    if "mixup" in opts:
        feed = iter(_mix_draws(opts["mixup"]))
        step.mixup.draw = lambda shape, generator, device=None: next(feed)
    images, labels, mask = _batches(case)
    a = opts.get("grad_accum_steps", 1)
    labels_of = param_labels(model.module)
    slack = dict.fromkeys(labels_of, 0.0) if net == "resnet" else None
    for i in range(STEPS):
        state, metrics = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                              torch.from_numpy(mask[i]), LR_FACTORS[i], FREEZE_SCALES[i])
        loss = metrics["loss"].numpy()
        assert loss.shape == want["loss"][i].shape == ((a,) if a > 1 else ())
        np.testing.assert_allclose(loss, want["loss"][i], rtol=1e-4, atol=0)
        if a > 1:
            assert metrics["confidences"].shape == (a, BATCH // a, 3)
            assert metrics["mask"].shape == (a, BATCH // a)
        if slack is not None:
            for key, p in model.module.named_parameters():
                lr = RESNET_SGD[f"{labels_of[key]}_lr"] * LR_FACTORS[i]
                lr *= FREEZE_SCALES[i] if labels_of[key] == "backbone" else 1.0
                slack[key] += lr * GATE_FLIP * p.grad.abs().max().item()
        _hold(model.module.state_dict(), want["state"][i], slack)
        if want["ema"]:
            _hold(state.ema_module.state_dict(), want["ema"][i], slack)
        if want["grad_norms"]:
            got = {k: float(v) for k, v in metrics["grad_norms"].items()}
            assert list(got) == sorted(want["grad_norms"][i])
            for k, v in want["grad_norms"][i].items():
                assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-9), (i, k)
            frozen = [v for k, v in got.items() if k.startswith("backbone/")]
            assert frozen and (all(v == 0 for v in frozen) if i == 0 else min(frozen) > 0)
    if want["ema"]:
        # the shadow moved, and is not the weights
        init = _port_model(net).module.state_dict()
        ema = state.ema_module.state_dict()
        assert any(not torch.equal(ema[k], init[k]) for k in ema)
        assert any(not torch.equal(ema[k], v) for k, v in model.module.state_dict().items())


def test_scan_steps_match_nkbx_multi_step_and_single_calls():
    """K = 3 stacked batches in one call: losses (3,) and the weights after
    against nkbx's multi-step (lr factor and freeze scale fixed for the
    call, as nkbx's scan takes them); and bit-identical to 3 single calls of
    the port with flips drawn from the same seeded generator."""
    images, labels, mask = _batches("scan")
    variables = _variables("swin")
    module = _jax_module("swin")
    bundle = jget_optimizer(variables["params"], SGD)
    jstep = jbuild_train_step(JModel(module, variables, list("abc"), "single", 64),
                              jget_loss(CE), bundle,
                              augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                              scan_steps=3)
    jstate, jm = jstep(JState.create(variables["params"], {}, bundle.tx), jnp.asarray(images),
                       jnp.asarray(labels), jnp.asarray(mask), jax.random.PRNGKey(0),
                       jnp.asarray(0.75, jnp.float32), jnp.asarray(1.0, jnp.float32))
    model = _port_model("swin")
    state = TrainState.create(model)
    step = build_train_step(model, get_loss(CE), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, scan_steps=3)
    assert step.scan_steps == 3
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                          torch.from_numpy(mask), 0.75, 1.0)
    assert state.step == 3 and metrics["confidences"].shape == (3, BATCH, 3)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    _hold(model.module.state_dict(),
          from_jax_variables(jax.device_get({"params": jstate.params})))

    pipe = Compose([HorizontalFlip(p=0.5), Normalize()])
    runs = []
    for scan in (3, 1):
        model = _port_model("swin")
        state = TrainState.create(model, seed=4)
        step = build_train_step(model, get_loss(CE), get_optimizer(SGD),
                                augment_fn=pipe.device_apply, scan_steps=scan,
                                log_gradients=True)
        if scan == 3:
            state, m = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                            torch.from_numpy(mask), 0.75, 1.0)
        else:
            ms = []
            for i in range(3):
                state, mi = step(state, torch.from_numpy(images[i]),
                                 torch.from_numpy(labels[i]), torch.from_numpy(mask[i]), 0.75,
                                 1.0)
                ms.append(mi)
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0] if k != "grad_norms"}
            m["grad_norms"] = {k: torch.stack([x["grad_norms"][k] for x in ms])
                               for k in ms[0]["grad_norms"]}
        runs.append((model.module.state_dict(), m))
    (sd3, m3), (sd1, m1) = runs
    assert all(torch.equal(sd3[k], sd1[k]) for k in sd3)
    assert all(torch.equal(m3[k], m1[k]) for k in m3 if k != "grad_norms")
    assert all(torch.equal(m3["grad_norms"][k], m1["grad_norms"][k]) for k in m3["grad_norms"])
    assert m3["grad_norms"]["head/kernel"].shape == (3,)


def test_guard_errors_are_nkbx_s():
    variables = _variables("swin")
    jmodel = JModel(_jax_module("swin"), variables, list("abc"), "single", 64)
    jbundle = jget_optimizer(variables["params"], SGD)
    model, bundle = _port_model("swin"), get_optimizer(SGD)
    weighted = {"type": "CrossEntropyLoss", "weight": [1.0, 2.0, 1.0]}
    for kwargs, loss_cfg in (({"scan_steps": 2, "grad_accum_steps": 2}, CE),
                             ({"grad_accum_steps": 2}, dict(weighted, task="multi")),
                             ({"grad_accum_steps": 2, "mixup": {"alpha": 0.2}}, weighted),
                             ({"grad_accum_steps": 2, "mixup": {"alpha": 0.2}},
                              {"type": "FocalLoss"})):
        with pytest.raises(ValueError) as want:
            jbuild_train_step(jmodel, jget_loss(loss_cfg), jbundle, **kwargs)
        with pytest.raises(ValueError) as got:
            build_train_step(model, get_loss(loss_cfg), bundle, **kwargs)
        assert str(got.value) == str(want.value)
    images, labels, mask = _batches("accum-ce")
    jstep = jbuild_train_step(jmodel, jget_loss(CE), jbundle, grad_accum_steps=4)
    with pytest.raises(ValueError) as want:
        jstep(JState.create(variables["params"], {}, jbundle.tx), jnp.asarray(images[0]),
              jnp.asarray(labels[0]), jnp.asarray(mask[0]), jax.random.PRNGKey(0),
              jnp.asarray(1.0), jnp.asarray(1.0))
    step = build_train_step(model, get_loss(CE), bundle, grad_accum_steps=4)
    with pytest.raises(ValueError) as got:
        step(TrainState.create(model), torch.from_numpy(images[0]), torch.from_numpy(labels[0]),
             torch.from_numpy(mask[0]), 1.0, 1.0)
    assert str(got.value) == str(want.value) == "grad_accum_steps=4 must divide batch 6"


# --- the epoch loop ---------------------------------------------------------------------


class _Loader:
    """``n`` seeded batches of 4 at 32 px; raises the preemption flag as it
    yields batch ``preempt_at``."""

    batch_size, drop_last, pipeline = 4, True, None

    def __init__(self, n, preempt_at=None):
        rng = np.random.default_rng(3)
        self.batches = [{"image": rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8),
                         "label": rng.integers(0, 3, 4).astype(np.int64),
                         "mask": np.ones(4, bool)} for _ in range(n)]
        self.preempt_at = preempt_at

    def epoch(self, e, start_batch=0):
        for i in range(start_batch, len(self.batches)):
            if i == self.preempt_at:
                preempt._handler(None, None)
            yield self.batches[i]

    def __len__(self):
        return len(self.batches)


def test_train_epoch_chunks_and_preemption():
    model = _port_model("swin")
    step = build_train_step(model, get_loss(CE), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, scan_steps=3,
                            log_gradients=True)
    state = TrainState.create(model)
    calls = []

    def counting(*args):
        calls.append(args[1].shape[0])
        return step(*args)

    counting.scan_steps, counting.masked_bn = 3, False
    state, res = train_epoch(state, _Loader(7), counting, 0, 1.0, 1.0, progress=False)
    assert calls == [3, 3, 1] and state.step == 7 and res["consumed_batches"] == 7
    assert len(res["running_loss"]) == 7 and len(res["predictions"]) == 28
    assert len(res["metrics_grad_log"]["Gradients/Total"]) == 7
    preempt.reset()
    try:
        calls.clear()
        state = TrainState.create(model)
        state, res = train_epoch(state, _Loader(7, preempt_at=5), counting, 0, 1.0, 1.0,
                                 progress=False)
    finally:
        preempt.reset()
    # batches 3 and 4 were buffered for the second chunk, not stepped: not consumed
    assert res["preempted"] and calls == [3] and res["consumed_batches"] == 3
    calls.clear()
    state, res = train_epoch(state, _Loader(7), counting, 0, 1.0, 1.0, progress=False,
                             start_batch=3)
    assert calls == [3, 1] and res["consumed_batches"] == 7 and state.step == 7


def _stacked_metrics(rng, k, b, c, multi):
    """A step's metrics stacked (k, b, ...) as numpy, with gradient norms."""
    def one():
        conf = rng.dirichlet(np.ones(c), (k, b)).astype(np.float32)
        return {"confidences": conf, "predictions": conf.argmax(-1),
                "ground_truth": rng.integers(0, c, (k, b)),
                "loss": rng.random(k).astype(np.float32)}

    mask = rng.random((k, b)) < 0.8
    m = {"t1": one(), "t2": one(), "loss": rng.random(k).astype(np.float32)} if multi else one()
    m["mask"] = mask
    m["grad_norms"] = {"backbone/a/kernel": rng.random(k).astype(np.float32),
                       "head/bias": rng.random(k).astype(np.float32)}
    return m


def _tree(fn, m):
    return {k: _tree(fn, v) for k, v in m.items()} if isinstance(m, dict) else fn(m)


@pytest.mark.parametrize("mode", ["exact", "bounded"])
@pytest.mark.parametrize("task", ["single", "multi"])
def test_collectors_on_stacked_metrics_match_nkbx(mode, task):
    rng = np.random.default_rng(9)
    batches = [_stacked_metrics(rng, k, 5, 4, task == "multi") for k in (3, 3, 2)]
    ours, theirs = EpochCollector(task, mode), JCollector(task, mode)
    for m in batches:
        ours.log_iter(_tree(torch.from_numpy, m))
        theirs.log_iter(_tree(jnp.asarray, m))
    got, want = ours.get_epoch_results(), theirs.get_epoch_results()
    assert got["metrics_grad_log"].keys() == want["metrics_grad_log"].keys()
    for key, vals in want["metrics_grad_log"].items():
        np.testing.assert_allclose(got["metrics_grad_log"][key], vals, rtol=1e-7, err_msg=key)
    assert len(got["metrics_grad_log"]["Gradients/Total"]) == 8
    if mode == "bounded":
        assert got.keys() == want.keys()
        if task == "single":
            got_b, want_b = {None: got["bounded_metrics"]}, {None: want["bounded_metrics"]}
        else:
            got_b, want_b = got["bounded_metrics"], want["bounded_metrics"]
        for t in want_b:
            assert got_b[t]["epoch_acc"] == want_b[t]["epoch_acc"]
            np.testing.assert_allclose(got_b[t]["epoch_loss"], want_b[t]["epoch_loss"],
                                       rtol=1e-6)
        return
    for key in ("running_loss", "confidences", "predictions", "ground_truth"):
        g, w = got[key], want[key]
        if task == "multi":
            assert g.keys() == w.keys()
            for t in w:
                np.testing.assert_allclose(np.asarray(g[t]), np.asarray(w[t]), rtol=1e-7)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-7)


# --- checkpoints and the trainer ---------------------------------------------------------


def _tiny_resnet():
    return get_model({"model": "resnet_tiny_test"}, list("abc"), input_size=(SIZE, SIZE),
                     dtype=torch.float32, device="cpu")


def _ema_state(ema, seed):
    """A tiny ResNet's state after two steps (EMA 0.5 where ``ema``)."""
    model = _tiny_resnet()
    state = TrainState.create(model, ema=ema)
    step = build_train_step(model, get_loss(CE), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, ema_decay=0.5)
    images, labels, mask = _batches("ema")
    rng = np.random.default_rng(seed)
    for i in range(2):
        state, _ = step(state, torch.from_numpy(rng.permutation(images[i])),
                        torch.from_numpy(labels[i]), torch.ones(len(labels[i]), dtype=torch.bool),
                        1.0, 1.0)
    return state


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_ema_checkpoints_both_ways(tmp_path):
    saved = _ema_state(True, 0)
    save_checkpoint(tmp_path / "ema", saved, 1, 0.5)
    plain = _ema_state(False, 0)
    save_checkpoint(tmp_path / "plain", plain, 1, 0.5)
    assert not _equal(saved.ema_module.state_dict(), saved.module.state_dict())
    # EMA into EMA: the saved shadow
    state, epoch, best = restore_train_state(tmp_path / "ema", TrainState.create(_tiny_resnet(),
                                                                                ema=True))
    assert (epoch, best, state.step) == (1, 0.5, 2)
    assert _equal(state.ema_module.state_dict(), saved.ema_module.state_dict())
    assert _equal(state.module.state_dict(), saved.module.state_dict())
    # no EMA into EMA: the shadow starts at the restored weights
    state, _, _ = restore_train_state(tmp_path / "plain", TrainState.create(_tiny_resnet(),
                                                                            ema=True))
    assert _equal(state.ema_module.state_dict(), plain.module.state_dict())
    # EMA into no EMA: the shadow is dropped, the weights restored
    state, _, _ = restore_train_state(tmp_path / "ema", TrainState.create(_tiny_resnet()))
    assert state.ema_module is None
    assert _equal(state.module.state_dict(), saved.module.state_dict())


def _write_folder(root, n_train=12, n_val=4, classes=3):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = int(rng.integers(24, 70)), int(rng.integers(24, 70))
                img = rng.integers(0, 256, (h, w, 3)).astype(np.int32) + 50 * (c - 1)
                cv2.imwrite(str(d / f"{i}.bmp"), np.clip(img, 0, 255).astype(np.uint8))
    return root


RECIPE = """
import nkbx.transforms as T

enable_mixed_precision = False
task = "single"
n_epochs = 2
seed = 0
experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
train_data = {{"type": "ImageFolder", "root": "{root}/train", "shuffle": True,
               "batch_size": 4, "num_workers": 2, "drop_last": True}}
val_data = {{"type": "ImageFolder", "root": "{root}/val", "shuffle": False,
             "batch_size": 4, "num_workers": 2, "drop_last": False}}
train_pipeline = T.Compose([
    T.LongestMaxSize(32), T.PadIfNeeded(32, 32, border_mode=0, value=0),
    T.RandAugment(num_ops=2, magnitude=9, num_affine_grids=4),
    T.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)), T.ToTensorV2()])
val_pipeline = T.Compose([
    T.LongestMaxSize(32), T.PadIfNeeded(32, 32, border_mode=0, value=0),
    T.Normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)), T.ToTensorV2()])
model = {{"task": task, "model": "resnet_tiny_test", "classifier_dropout": 0.0,
          "classifier_initialization": "kaiming_normal_"}}
optimizer = {{"type": "sgd", "lr": 0.05, "momentum": 0.9, "weight_decay": 2e-5}}
lr_policy = {{"type": "cosine", "n_epochs": n_epochs}}
criterion = {{"task": task, "type": "CrossEntropyLoss", "label_smoothing": 0.1}}
mixup = {{"mixup_alpha": 0.2, "cutmix_alpha": 1.0, "prob": 0.5}}
model_ema_decay = 0.9
steps_per_dispatch = 4
metrics_accumulation = "bounded"
log_gradients = True
"""


def test_trainer_runs_the_recipe_keys_and_saves_the_ema(tmp_path):
    """9 train batches of 4 an epoch: calls of 4, 4 and 1; EMA 0.9; best.pt
    and last.pt are the EMA shadow (nkbx's msgpacks hold ema_params), the
    best/ and last/ checkpoints hold the shadow beside the raw weights."""
    from nkbx_torch.train.__main__ import main as cli_main
    from nkbx_torch.train.checkpoint import STATE_FILE

    root = _write_folder(tmp_path / "data")
    config = tmp_path / "recipe.py"
    config.write_text(textwrap.dedent(RECIPE.format(run=tmp_path / "run", root=root)))
    with pytest.warns(UserWarning, match="'mixup_alpha' is ignored"):
        cli_main(["-cfg", str(config), "--device", "cpu"])
    run = tmp_path / "run"
    weights = run / "weights"
    best = torch.load(weights / "best" / STATE_FILE, weights_only=True)
    last = torch.load(weights / "last" / STATE_FILE, weights_only=True)
    assert _equal(torch.load(weights / "best.pt", weights_only=True), best["ema"])
    assert _equal(torch.load(weights / "last.pt", weights_only=True), last["ema"])
    assert not _equal(last["ema"], last["module"]) and last["step"] == 18
    rows = (run / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3 and "nan" not in rows[-1].lower()
    labels = param_labels(get_model({"model": "resnet_tiny_test"}, list("abc"),
                                    device="cpu").module)
    assert set(labels) <= set(last["ema"])
