"""The port's DenseNet against nkbx's, on the CPU.

- A narrow DenseNet (``block_config=(1, 2)``, growth 8, 16 stem features,
  32 px) built on both sides, nkbx's perturbed weights and running
  statistics carried across by ``from_jax_variables``: eval and train
  forwards, the running statistics after the train forward, and a
  ``masked_bn`` train forward with a padded row.
- ``buffer_concat=True``, accepted and lowered to the one concat path: the
  flag changes nothing (the same tree, equal logits in eval and train mode,
  a backward with the concat path's gradients), and nkbx's buffer lowering
  gives the same logits.
- densenet121/169/201 at full size, as shapes: every leaf of nkbx's tree
  maps through the converter's rule onto the port's state dict;
  ``num_features`` equal. densenet121 at full width in bf16 on the CPU:
  finite.
- A 3-step train lockstep against nkbx's ``build_train_step`` (SGD, a
  freeze flip, a padded row, ``masked_bn=True``).

Tolerances, float32: logits 5e-4 and running statistics 1e-4 + 1e-4
relative (as tests/test_torch_zoo.py); the buffer lowering against the
concat path exactly in the forward, gradients 1e-6; the lockstep's losses 1e-4
relative and parameters 2e-6 + 1e-5 relative plus lr * 3e-2 of a leaf's
largest gradient per step (a relu gate on the other side, as
tests/test_torch_resnet.py states).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models import densenet as jdensenet
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.registry import create_backbone as jcreate_backbone
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx_torch.models import convert as tconvert
from nkbx_torch.models import create_backbone, from_jax_variables, get_model, param_labels
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.densenet import NAMES, DenseNet
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize

SIZE = 32
NARROW = dict(block_config=(1, 2), growth_rate=8, init_features=16)


def _jax_net(buffer_concat=False):
    return JSingle(backbone=jdensenet.DenseNet(dtype=jnp.float32, buffer_concat=buffer_concat,
                                               **NARROW), n_classes=3)


def _port_net(buffer_concat=False):
    return SingletaskClassifier(DenseNet(dtype=torch.float32, buffer_concat=buffer_concat,
                                         **NARROW), 3)


@functools.lru_cache(maxsize=None)
def _variables():
    """nkbx's variables of the narrow net, every leaf perturbed (the running
    variances kept positive)."""
    variables = jax.device_get(jax.jit(lambda x: _jax_net().init(
        jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.1, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port_state(buffer_concat=False):
    module = _port_net(buffer_concat)
    module.load_state_dict(from_jax_variables(_variables(), reference=module))
    return module


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _check_stats(module, mutated):
    want = from_jax_variables({"params": _variables()["params"],
                               "batch_stats": jax.device_get(mutated["batch_stats"])})
    n = 0
    for key, value in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
            n += 1
    assert n == 2 * (1 + 2 * 3 + 1 + 1)  # stem, 3 layers of two, a transition, final


def test_narrow_densenet_matches_nkbx():
    variables, jmod = _variables(), _jax_net()
    x = _images(4)

    @jax.jit
    def both(v, xx):
        return (jmod.apply(v, xx, train=False),
                jmod.apply(v, xx, train=True, mutable=["batch_stats"]))

    want_eval, (want_train, mutated) = both(variables, jnp.asarray(x))
    module = _port_state()
    with torch.no_grad():
        got_eval = module.eval()(torch.from_numpy(x))
        got_train = module.train()(torch.from_numpy(x))
    assert np.abs(np.asarray(want_eval)).max() > 0.1
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=5e-4, rtol=0)
    _check_stats(module, mutated)


def test_masked_bn_matches_nkbx():
    """A train forward with the last row padded (zeros) and masked out of
    every BatchNorm's statistics: the valid rows' logits and the running
    statistics."""
    variables, jmod = _variables(), _jax_net()
    x = _images(4, seed=2)
    x[-1] = 0
    mask = np.array([True, True, True, False]).reshape(-1, 1, 1, 1)
    want, mutated = jax.jit(lambda v, xx, m: jmod.apply(v, xx, train=True, mask=m,
                                                        mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(mask))
    module = _port_state().train()
    with torch.no_grad():
        got = module(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], atol=5e-4, rtol=0)
    _check_stats(module, mutated)


def test_buffer_concat_equals_the_concat_path_and_trains():
    concat, buffered = _port_state(), _port_state(buffer_concat=True)
    assert list(buffered.state_dict()) == list(concat.state_dict())
    x = torch.from_numpy(_images(4, seed=3))
    mask = torch.tensor([True, True, True, False]).reshape(-1, 1, 1, 1)
    with torch.no_grad():
        assert torch.equal(buffered.eval()(x), concat.eval()(x))
    grads = []
    for module in (concat, buffered):
        module.train()
        out = module(x, mask=mask)
        out.square().sum().backward()
        grads.append((out.detach(), {n: p.grad for n, p in module.named_parameters()}))
    (out_c, g_c), (out_b, g_b) = grads
    assert torch.equal(out_b, out_c)
    assert sorted(g_b) == sorted(g_c)
    for name in g_c:
        assert g_b[name] is not None, name
        torch.testing.assert_close(g_b[name], g_c[name], atol=1e-6, rtol=1e-6, msg=name)
    for key, value in buffered.state_dict().items():
        assert torch.equal(value, concat.state_dict()[key]), key  # running statistics too
    want = _jax_net(buffer_concat=True).apply(_variables(), jnp.asarray(x.numpy()), train=False)
    with torch.no_grad():
        got = _port_state(buffer_concat=True).eval()(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def _flax_shapes(tree, prefix=()):
    """{port state-dict name: shape} of a flax shape tree, through the
    converter's per-leaf rule on zero-stride stand-ins (no memory)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flax_shapes(value, prefix + (key,)))
        else:
            proxy = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), value.shape,
                                                    (0,) * len(value.shape))
            rule = tconvert._stat_leaf if prefix[0] == "batch_stats" else tconvert._leaf
            name, arr = rule(prefix[1:] + (key,), proxy)
            out[".".join(prefix[1:] + (name,))] = tuple(arr.shape)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_converter_maps_every_leaf_at_full_size(name):
    jbb = jcreate_backbone(name, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jbb.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = _flax_shapes({"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    with torch.device("meta"):
        bb = create_backbone(name, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in bb.state_dict().items()} == want
    assert bb.num_features == jbb.num_features


def test_full_width_bf16_forward_on_cpu():
    model = get_model({"model": "densenet121", "backbone_dropout": 0.1}, list("abcde"),
                      input_size=(64, 64), device="cpu", dtype=torch.bfloat16)
    assert model.emb_size == 1024
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                                           dtype=np.uint8))
    out = model(Compose([Normalize()]).device_apply(x, torch.bfloat16))
    assert out.shape == (2, 5) and out.dtype == torch.float32 and torch.isfinite(out).all()


# --- the train step against nkbx's ----------------------------------------------------

BATCH, STEPS = 4, 3
SGD = {"type": "sgd", "backbone_lr": 1e-2, "classifier_lr": 1e-2,
       "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-4}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]
GATE_FLIP = 3e-2


def _batches():
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (STEPS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (STEPS, BATCH)).astype(np.int64)
    mask = np.ones(BATCH, bool)
    mask[-1] = False
    images[:, -1] = 0  # the loader's padded row
    return images, labels, mask


def test_train_step_lockstep_with_nkbx():
    variables, jmod = _variables(), _jax_net()
    jmodel = JModel(jmod, variables, list("abc"), "single", 40)
    jbundle = jget_optimizer(variables["params"], SGD)
    jstep = jbuild_train_step(jmodel, jget_loss({"type": "CrossEntropyLoss"}), jbundle,
                              augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                              masked_bn=True)
    jstate = JState.create(variables["params"], variables["batch_stats"], jbundle.tx)
    module = _port_state()
    model = ClassificationModel(module, list("abc"), "single", module.backbone.num_features,
                                (SIZE, SIZE), torch.float32, torch.device("cpu"))
    state = TrainState.create(model)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=True)
    images, labels, mask = _batches()
    labels_of = param_labels(module)
    slack = dict.fromkeys(labels_of, 0.0)
    for i in range(STEPS):
        jstate, jmetrics = jstep(jstate, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                                 jnp.asarray(mask), jax.random.PRNGKey(0),
                                 jnp.asarray(LR_FACTORS[i], jnp.float32),
                                 jnp.asarray(FREEZE_SCALES[i], jnp.float32))
        want_sd = from_jax_variables(jax.device_get({"params": jstate.params,
                                                     "batch_stats": jstate.batch_stats}))
        state, metrics = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                              torch.from_numpy(mask), LR_FACTORS[i], FREEZE_SCALES[i])
        assert metrics["loss"].item() == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
        params = dict(module.named_parameters())
        for key, value in module.state_dict().items():
            want = want_sd[key].numpy()
            if key in params:
                lr = SGD[f"{labels_of[key]}_lr"] * LR_FACTORS[i]
                lr *= FREEZE_SCALES[i] if labels_of[key] == "backbone" else 1.0
                slack[key] += lr * GATE_FLIP * params[key].grad.abs().max().item()
                bound = 2e-6 + 1e-5 * np.abs(want) + slack[key]
            else:
                bound = 1e-5 + 1e-4 * np.abs(want)
            err = np.abs(value.numpy() - want)
            assert (err <= bound).all(), (key, i, float(err.max()), float((err - bound).max()))
