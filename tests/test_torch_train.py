"""The port's training pieces against nkbx's, on the CPU.

- Losses (weighted and smoothed cross-entropy, focal, multi-task, all with
  row masks) against ``nkbx.train.losses``: f32, 1e-6 relative.
- The optimizer on a small parameter tree against nkbx's pipeline
  (``apply_coupled_wd`` -> ``mask_frozen_grads`` -> ``tx.update`` ->
  ``select_frozen_opt_state`` -> ``scale_updates``), adam / radam / nadam /
  sgd over 6 steps with a freeze flip, in both freeze semantics: params
  within 1e-6 + 1e-5 relative.
- The flips fed the gates nkbx's device stage drew: identical output.
- A lockstep of the train step: the tiny Swin of tests/test_torch_swin.py
  (embed 16, depths (2, 2), heads (1, 2), 32 px, window 2), nkbx's weights
  carried across, 3 steps of nkbx's ``build_train_step`` (f32, XLA path)
  against the port's on identical uint8 batches, nadam with different
  backbone and classifier lr and wd, a cosine ``lr_factor``, a
  ``freeze_scale`` flip 0 -> 1 and a masked final row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.swin import SwinTransformer as JSwin
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.train import losses as jlosses
from nkbx.train import optim as joptim
from nkbx.transforms import spec as jspec
from nkbx.transforms.device import build_device_fn as jbuild_device_fn
from nkbx_torch.models import from_jax_variables, param_labels
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.train import (TrainState, build_eval_step, build_train_step, get_loss,
                              get_optimizer, get_scheduler)
from nkbx_torch.train import losses as tlosses
from nkbx_torch.train.optim import apply_updates, init_opt_state
from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize, VerticalFlip
from nkbx_torch.transforms.device import build_device_fn

# --- losses ----------------------------------------------------------------------


def _logits(seed=0, b=8, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, b).astype(np.int64)
    mask = np.ones(b, bool)
    mask[-3:] = False
    return logits, labels, mask


LOSS_CFGS = [
    {"type": "CrossEntropyLoss"},
    {"type": "CrossEntropyLoss", "weight": [1.0, 2.0, 0.5, 1.5, 3.0]},
    {"type": "CrossEntropyLoss", "weight": [1.0, 2.0, 0.5, 1.5, 3.0], "label_smoothing": 0.1},
    {"type": "FocalLoss"},
    {"type": "FocalLoss", "alpha": [0.5, 1.0, 2.0, 1.0, 0.25], "gamma": 1.5},
]


@pytest.mark.parametrize("cfg", LOSS_CFGS)
def test_single_task_losses_match_nkbx(cfg):
    logits, labels, mask = _logits()
    want = jget_loss(cfg)(jnp.asarray(logits), jnp.asarray(labels), mask=jnp.asarray(mask))
    got = get_loss(cfg)(torch.from_numpy(logits), torch.from_numpy(labels),
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_multitask_loss_matches_nkbx():
    cfg = {"type": "CrossEntropyLoss", "task": "multi", "label_smoothing": 0.05}
    (la, ya, mask), (lb, yb, _) = _logits(1), _logits(2, c=5)
    want = jget_loss(cfg)({"a": jnp.asarray(la), "b": jnp.asarray(lb)},
                          {"a": jnp.asarray(ya), "b": jnp.asarray(yb)}, mask=jnp.asarray(mask))
    got = get_loss(cfg)({"b": torch.from_numpy(lb), "a": torch.from_numpy(la)},
                        {"a": torch.from_numpy(ya), "b": torch.from_numpy(yb)},
                        mask=torch.from_numpy(mask))
    assert sorted(got) == ["a", "b", "loss"]
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


def test_focal_ignore_index_and_empty_mask_match_nkbx():
    logits, labels, mask = _logits(3)
    labels[0] = -100
    for m in (mask, np.zeros_like(mask)):
        want = jlosses.focal_loss(jnp.asarray(logits), jnp.asarray(labels), mask=jnp.asarray(m))
        got = tlosses.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 mask=torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_unknown_loss_raises():
    with pytest.raises(NotImplementedError):
        get_loss({"type": "Hinge"})


# --- optimizer -------------------------------------------------------------------


class _Tree(nn.Module):
    """A parameter tree shaped like a classifier: backbone and head."""

    def __init__(self, params):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.conv = nn.Parameter(torch.from_numpy(params["backbone"]["conv"]))
        self.backbone.norm = nn.Parameter(torch.from_numpy(params["backbone"]["norm"]))
        self.head = nn.Module()
        self.head.kernel = nn.Parameter(torch.from_numpy(params["head"]["kernel"]))
        self.head.bias = nn.Parameter(torch.from_numpy(params["head"]["bias"]))


def _tree(rng):
    return {"backbone": {"conv": rng.normal(size=(3, 4, 8)).astype(np.float32),
                         "norm": rng.normal(size=8).astype(np.float32)},
            "head": {"kernel": rng.normal(size=(8, 2)).astype(np.float32),
                     "bias": rng.normal(size=2).astype(np.float32)}}


OPT_CFG = {"lr": 1e-2, "backbone_lr": 3e-3, "weight_decay": 0.05,
           "classifier_weight_decay": 0.01}
FREEZE = (0.0, 0.0, 1.0, 1.0, 0.0, 1.0)  # two frozen steps, a flip, a refreeze
FACTORS = (1.0, 1.0, 0.9, 0.75, 0.5, 0.25)


@pytest.mark.parametrize("semantics", ["decay", "torch"])
@pytest.mark.parametrize("kind", ["adam", "radam", "nadam", "sgd"])
def test_optimizer_lockstep_with_nkbx(kind, semantics):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = dict(OPT_CFG, type=kind)
    jbundle = jget_optimizer(params, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = jbundle.tx.init(jp)
    module = _Tree(params)
    bundle = get_optimizer(cfg)
    labels = param_labels(module)
    groups = {g: [p for n, p in module.named_parameters() if labels[n] == g]
              for g in ("backbone", "classifier")}
    state = init_opt_state(groups)
    for fs, lf in zip(FREEZE, FACTORS):
        grads = _tree(rng)
        g = joptim.apply_coupled_wd(jax.tree_util.tree_map(jnp.asarray, grads), jp,
                                    jbundle.coupled_wds)
        g = joptim.mask_frozen_grads(g, jnp.asarray(fs))
        updates, new_state = jbundle.tx.update(g, opt_state, jp)
        if semantics == "torch":
            new_state = joptim.select_frozen_opt_state(new_state, opt_state, jnp.asarray(fs))
        opt_state = new_state
        jp = optax.apply_updates(jp, joptim.scale_updates(updates, jp, jbundle.lrs,
                                                          jnp.asarray(lf), jnp.asarray(fs)))
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(_leaf(grads, name))
        apply_updates(bundle, state, groups, lf, fs, semantics)
        for name, p in module.named_parameters():
            want = np.asarray(_leaf(jp, name))
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def test_schedules_match_nkbx():
    for policy in ({"type": "step", "step_size": 2, "gamma": 0.5},
                   {"type": "multistep", "steps": [1, 3], "gamma": 0.1},
                   {"type": "cosine", "n_epochs": 5}, {}):
        want, got = joptim.get_scheduler(policy), get_scheduler(policy)
        for e in range(6):
            assert got(e) == pytest.approx(want(e), rel=1e-12)


def test_param_labels_split_backbone_and_heads():
    module = SingletaskClassifier(SwinTransformer(img_size=(32, 32), embed_dim=16, depths=(2,),
                                                  n_heads=(1,), window=2), 3)
    labels = param_labels(module)
    assert labels["head.weight"] == labels["head.bias"] == "classifier"
    assert all(v == "backbone" for k, v in labels.items() if k.startswith("backbone."))


# --- flips -----------------------------------------------------------------------


def test_flips_fed_nkbx_gates_match_nkbx():
    """nkbx splits its key over the random ops and draws uniform(key_i, (B,
    1, 1, 1)) < p per op (device.py:74-83, 712-717); the same gates go to the
    port's flips."""
    images = np.random.default_rng(5).integers(0, 256, (6, 8, 10, 3), dtype=np.uint8)
    jpipe = [jspec.HorizontalFlip(p=0.5), jspec.VerticalFlip(p=0.5), jspec.Normalize()]
    key = jax.random.PRNGKey(3)
    want = jbuild_device_fn(jpipe)(jnp.asarray(images), key, True)
    gates = [np.asarray(jax.random.uniform(k, (6, 1, 1, 1)) < 0.5).reshape(-1)
             for k in jax.random.split(key, 2)]
    assert 0 < sum(g.sum() for g in gates) < 12  # some flip, some do not
    pipe = Compose([HorizontalFlip(p=0.5), VerticalFlip(p=0.5), Normalize()])
    got = pipe.device_apply(torch.from_numpy(images),
                            draws=[{"gate": torch.from_numpy(g.copy())} for g in gates])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7, atol=0)


def test_flips_draw_from_the_generator():
    images = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (16, 4, 4, 3),
                                                                dtype=np.uint8))
    fn = build_device_fn([HorizontalFlip(p=0.5), Normalize()])
    a = fn(images, generator=torch.Generator().manual_seed(1))
    b = fn(images, generator=torch.Generator().manual_seed(1))
    c = fn(images, generator=torch.Generator().manual_seed(2))
    plain = fn(images)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="after Normalize"):
        Compose([Normalize(), HorizontalFlip()])


# --- the train step against nkbx's -------------------------------------------------

TINY = dict(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2)
SIZE, BATCH, STEPS = 32, 4, 3
NADAM = {"type": "nadam", "backbone_lr": 1e-3, "classifier_lr": 1e-2,
         "backbone_weight_decay": 0.05, "classifier_weight_decay": 0.01}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]


def _batches():
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (STEPS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (STEPS, BATCH)).astype(np.int64)
    mask = np.ones(BATCH, bool)
    mask[-1] = False
    return images, labels, mask


@functools.lru_cache(maxsize=None)
def _nkbx_run():
    """(initial variables, grads of step 1, losses, params after each step)."""
    module = JSingle(backbone=JSwin(dtype=jnp.float32, fused_attention=False, fused_mlp=False,
                                    **TINY), n_classes=3)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        jax.device_get(variables))
    model = JModel(module, variables, list("abc"), "single", 64)
    criterion = jget_loss({"type": "CrossEntropyLoss"})
    bundle = jget_optimizer(variables["params"], NADAM)
    pipe = jspec.Compose([jspec.Normalize()])
    images, labels, mask = _batches()
    norm = jbuild_device_fn([jspec.Normalize()])

    def loss_fn(params):
        preds = module.apply({"params": params}, norm(jnp.asarray(images[0]), None, False),
                             train=True)
        return criterion(preds, jnp.asarray(labels[0]), mask=jnp.asarray(mask))

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(variables["params"]))
    step = jbuild_train_step(model, criterion, bundle, augment_fn=pipe.device_apply)
    state = JState.create(variables["params"], {}, bundle.tx)
    losses, params = [], []
    for i in range(STEPS):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                              jnp.asarray(mask), jax.random.PRNGKey(0),
                              jnp.asarray(LR_FACTORS[i], jnp.float32),
                              jnp.asarray(FREEZE_SCALES[i], jnp.float32))
        losses.append(float(metrics["loss"]))
        params.append(from_jax_variables({"params": jax.device_get(state.params)}))
    return variables, from_jax_variables({"params": grads}), losses, params


def _port_model(fused):
    variables = _nkbx_run()[0]
    backbone = SwinTransformer(dtype=torch.float32, img_size=(SIZE, SIZE),
                               fused_attention=fused, fused_mlp=fused, **TINY)
    module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    return ClassificationModel(module.eval(), list("abc"), "single", backbone.num_features,
                               (SIZE, SIZE), torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("fused", [None, True])
def test_train_step_lockstep_with_nkbx(fused):
    """fused=None is autograd through the plain forward; True goes through
    the kernels' autograd Functions (their plain halves on the CPU).

    Tolerances: loss per step rtol 1e-4; step-1 grads 1e-4 times each leaf's
    largest value; params after each step 2e-6 + 1e-5 relative, except where
    NAdam's first steps, about lr * sign(g), amplify a difference in a
    gradient that is unresolved: for an element whose port gradient at some
    step is under 1e-4 of its leaf's largest, the bound grows by 2 * lr *
    lr_factor * freeze_scale of that step (the farthest a sign flip moves
    it)."""
    _, jgrads, jlosses_, jparams = _nkbx_run()
    model = _port_model(fused)
    bundle = get_optimizer(NADAM)
    state = TrainState.create(model)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), bundle,
                            augment_fn=Compose([Normalize()]).device_apply)
    images, labels, mask = _batches()
    labels_of = param_labels(model.module)
    slack = {n: torch.zeros_like(p) for n, p in model.module.named_parameters()}
    for i in range(STEPS):
        state, metrics = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                              torch.from_numpy(mask), LR_FACTORS[i], FREEZE_SCALES[i])
        assert metrics["loss"].item() == pytest.approx(jlosses_[i], rel=1e-4)
        assert metrics["confidences"].shape == (BATCH, 3) and metrics["mask"].dtype == torch.bool
        for name, p in model.module.named_parameters():
            g = p.grad
            assert g is not None, name
            if i == 0:
                want = jgrads[name].numpy()
                np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                           atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)
            lr = NADAM[f"{labels_of[name]}_lr"] * LR_FACTORS[i]
            lr *= FREEZE_SCALES[i] if labels_of[name] == "backbone" else 1.0
            slack[name] += 2 * lr * (g.abs() < 1e-4 * g.abs().max()).float()
            want = jparams[i][name].numpy()
            got = p.detach().numpy()
            bound = 2e-6 + 1e-5 * np.abs(want) + slack[name].numpy()
            assert (np.abs(got - want) <= bound).all(), (name, np.abs(got - want).max())
    assert state.step == STEPS


def test_every_parameter_gets_a_gradient_through_the_functions():
    """The fault repaired here: a kernel entry that writes into a fresh
    tensor cuts the graph. On the CPU the Functions' plain halves run; every
    parameter of the tiny Swin, through fused=True, gets a nonzero grad."""
    model = _port_model(True)
    images, labels, mask = _batches()
    x = Compose([Normalize()]).device_apply(torch.from_numpy(images[0]))
    model.module.train()
    loss = get_loss({"type": "CrossEntropyLoss"})(model.module(x), torch.from_numpy(labels[0]),
                                                   mask=torch.from_numpy(mask))
    loss.backward()
    for name, p in model.module.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


def test_eval_step_metrics_and_no_grad():
    model = _port_model(None)
    images, labels, mask = _batches()
    metrics = build_eval_step(model, get_loss({"type": "CrossEntropyLoss"}),
                              Compose([Normalize()]).device_apply)(
        None, torch.from_numpy(images[0]), torch.from_numpy(labels[0]), torch.from_numpy(mask))
    assert set(metrics) == {"confidences", "predictions", "ground_truth", "loss", "mask"}
    assert not metrics["loss"].requires_grad
    np.testing.assert_allclose(metrics["confidences"].sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("option,value", [("grad_accum_steps", 2), ("scan_steps", 4),
                                          ("ema_decay", 0.999), ("mixup", {"alpha": 0.2}),
                                          ("log_gradients", True)])
def test_unported_train_options_raise(option, value):
    """Each of nkbx's five step options, once refused, builds and runs one
    CPU step of the tiny Swin (``scan_steps`` on 4 stacked batches, EMA on a
    state made with ``ema=True``); their locksteps against nkbx are in
    tests/test_torch_train_options.py."""
    model = _port_model(None)
    state = TrainState.create(model, ema=option == "ema_decay")
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer({"type": "sgd", "lr": 1e-2}),
                            augment_fn=Compose([Normalize()]).device_apply, **{option: value})
    images, labels, mask = _batches()
    args = [torch.from_numpy(a) for a in (images[0], labels[0], mask)]
    if option == "scan_steps":
        args = [torch.stack([a] * value) for a in args]
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    state, metrics = step(state, *args, 1.0, 1.0)
    lead = {"grad_accum_steps": (2,), "scan_steps": (4,)}.get(option, ())
    assert metrics["loss"].shape == lead and torch.isfinite(metrics["loss"]).all()
    assert state.step == (value if option == "scan_steps" else 1)
    assert any(not torch.equal(before[k], v) for k, v in model.module.state_dict().items())
    if option == "log_gradients":
        assert "head/kernel" in metrics["grad_norms"]
    if option == "ema_decay":
        shadow = state.ema_module.state_dict()
        assert all(not torch.equal(shadow[k], before[k]) for k, _ in
                   model.module.named_parameters())


def test_ema_is_not_ported():
    """``TrainState.create(ema=True)``, once refused, keeps the EMA shadow: a
    second module whose weights start equal to the model's (nkbx
    state.py:52-53), without gradients, and no shadow without ``ema``."""
    model = _port_model(None)
    state = TrainState.create(model, ema=True)
    assert state.ema_module is not None and state.ema_module is not model.module
    live, shadow = model.module.state_dict(), state.ema_module.state_dict()
    assert live.keys() == shadow.keys() and all(torch.equal(live[k], shadow[k]) for k in live)
    assert all(not p.requires_grad for p in state.ema_module.parameters())
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(*state.ema_pairs()))
    assert TrainState.create(model).ema_module is None
