"""The port's MobileNetV3 and EfficientNet (B0-B7, V2 S/M/L) families
against nkbx's, on the CPU.

- Narrow nets at 64 px (MobileNetV3 at width 0.75 over a 4-block spec with
  and without expansion, SE, relu and hard_swish; EfficientNet at width
  0.25, depth 0.25; EfficientNetV2 over a fused-expand-1, fused-expand-4
  and MBConv spec), nkbx's perturbed weights and running statistics carried
  across by ``from_jax_variables``: eval and train forwards, the running
  statistics after the train forward, and a ``masked_bn`` train forward
  with a padded row; ``ghost_bn=2`` equal to exact BatchNorm on each pair
  of rows (nkbx's nets have no ghost option).
- Every leaf of all 13 registered names (at full size, as shapes only)
  maps through the converter's rule onto the port's state dict.
- ``make_divisible``, the round_repeats ceil of B1-B7 and ``num_features``
  equal nkbx's; ``param_labels`` put the heads, and only they, in the
  ``classifier`` group, as nkbx's do.
- A 3-step train lockstep of the narrow MobileNetV3 against nkbx's
  ``build_train_step`` (SGD, a freeze flip, a padded row, masked BN).
- mobilenetv3_large_100 and efficientnet_b0 at full width through
  ``get_model`` in bf16 on the CPU: finite.

Tolerances, float32: logits 5e-4 (as for the other families) and running
statistics 1e-4 + 1e-4 relative; the lockstep's losses 1e-4 relative and
parameters 2e-6 + 1e-5 relative plus lr * 3e-2 of a leaf's largest
gradient per step (one relu gate on the other side, as
tests/test_torch_resnet.py states).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models import common as jcommon
from nkbx.models import efficientnet as jeff
from nkbx.models import mobilenetv3 as jmnv3
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import MultitaskClassifier as JMulti
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.classifier import param_labels as jparam_labels
from nkbx.models.registry import create_backbone as jcreate_backbone
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx_torch.models import convert as tconvert
from nkbx_torch.models import create_backbone, from_jax_variables, get_model, param_labels
from nkbx_torch.models import efficientnet as teff
from nkbx_torch.models import mobilenetv3 as tmnv3
from nkbx_torch.models.classifier import (ClassificationModel, MultitaskClassifier,
                                          SingletaskClassifier)
from nkbx_torch.models.common import make_divisible
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize

SIZE = 64
MNV3_SPEC = ((3, 16, 16, True, "re", 2), (3, 16, 16, False, "re", 1),
             (3, 48, 24, False, "hs", 2), (5, 72, 24, True, "hs", 1))
V2_SPEC = (("fused", 1, 3, 1, 1, 8, 0.0), ("fused", 4, 3, 2, 2, 16, 0.0),
           ("mb", 4, 3, 2, 2, 24, 0.25))
NARROW = {
    "mobilenetv3": (jmnv3.MobileNetV3, tmnv3.MobileNetV3,
                    dict(spec=MNV3_SPEC, width_mult=0.75, last_conv=96, head_features=40)),
    "efficientnet": (jeff.EfficientNet, teff.EfficientNet, dict(width_mult=0.25,
                                                                depth_mult=0.25)),
    "efficientnetv2": (jeff.EfficientNetV2, teff.EfficientNetV2, dict(spec=V2_SPEC,
                                                                      stem_width=8)),
}
NEW_NAMES = tmnv3.NAMES + teff.NAMES


def _jax_net(name):
    jcls, _, kw = NARROW[name]
    return JSingle(backbone=jcls(dtype=jnp.float32, **kw), n_classes=3)


def _port_net(name):
    _, tcls, kw = NARROW[name]
    return SingletaskClassifier(tcls(dtype=torch.float32, **kw), 3)


@functools.lru_cache(maxsize=None)
def _variables(name):
    """nkbx's variables of a narrow net, every leaf perturbed (the running
    variances kept positive)."""
    variables = jax.device_get(jax.jit(lambda x: _jax_net(name).init(
        jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.1, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port_state(name):
    module = _port_net(name)
    module.load_state_dict(from_jax_variables(_variables(name), reference=module))
    return module


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _check_stats(module, variables, mutated):
    want = from_jax_variables({"params": variables["params"],
                               "batch_stats": jax.device_get(mutated["batch_stats"])})
    for key, value in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(NARROW))
def test_narrow_nets_match_nkbx(name):
    variables, jmod = _variables(name), _jax_net(name)
    x = _images(4)

    @jax.jit
    def both(v, xx):
        return (jmod.apply(v, xx, train=False),
                jmod.apply(v, xx, train=True, mutable=["batch_stats"]))

    want_eval, (want_train, mutated) = both(variables, jnp.asarray(x))
    module = _port_state(name)
    with torch.no_grad():
        got_eval = module.eval()(torch.from_numpy(x))
        got_train = module.train()(torch.from_numpy(x))
    assert np.abs(np.asarray(want_eval)).max() > 0.1
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=5e-4, rtol=0)
    _check_stats(module, variables, mutated)


@pytest.mark.parametrize("name", ["mobilenetv3", "efficientnet"])
def test_masked_bn_matches_nkbx(name):
    """A train forward with the last row padded (zeros) and masked out of
    every BatchNorm's statistics: the valid rows' logits and the running
    statistics."""
    variables, jmod = _variables(name), _jax_net(name)
    x = _images(4, seed=2)
    x[-1] = 0
    mask = np.array([True, True, True, False]).reshape(-1, 1, 1, 1)
    want, mutated = jax.jit(lambda v, xx, m: jmod.apply(v, xx, train=True, mask=m,
                                                        mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(mask))
    module = _port_state(name).train()
    with torch.no_grad():
        got = module(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], atol=5e-4, rtol=0)
    _check_stats(module, variables, mutated)


@pytest.mark.parametrize("name", ["mobilenetv3", "efficientnetv2"])
def test_ghost_bn_normalises_each_group_by_its_own_statistics(name):
    """nkbx's nets take no ghost_bn; the port's take it as its other families
    do: with ghost_bn=2 a train forward of 4 rows equals exact BatchNorm run
    on each pair of rows alone."""
    _, tcls, kw = NARROW[name]
    torch.manual_seed(0)
    exact = SingletaskClassifier(tcls(dtype=torch.float32, **kw), 3)
    ghost = SingletaskClassifier(tcls(dtype=torch.float32, ghost_bn=2, **kw), 3)
    ghost.load_state_dict(exact.state_dict())
    x = torch.from_numpy(_images(4, seed=3))
    with torch.no_grad():
        got = ghost.train()(x)
        want = torch.cat([exact.train()(x[:2]), exact.train()(x[2:])])
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


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


@pytest.mark.parametrize("name", NEW_NAMES)
def test_converter_maps_every_leaf_at_full_size(name):
    jbb = jcreate_backbone(name, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jbb.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    want = _flax_shapes({"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    with torch.device("meta"):
        bb = create_backbone(name, dtype=torch.float32)
    got = {k: tuple(v.shape) for k, v in bb.state_dict().items()}
    assert got == want
    assert bb.num_features == jbb.num_features


def test_make_divisible_round_repeats_and_widths_match_nkbx():
    for v in list(range(1, 200)) + [v * m for v in (16, 24, 40, 80, 112, 160, 960, 1280)
                                    for m in (0.25, 0.5, 0.75, 1.1, 1.2, 1.4, 1.6, 1.8, 2.0)]:
        assert make_divisible(v) == jcommon.make_divisible(v), v
    for mult in (1.0, 1.1, 1.2, 1.4, 1.8, 2.2, 2.6, 3.1):
        for r in (1, 2, 3, 4):
            assert teff._round_repeats(r, mult) == jeff._round_repeats(r, mult)
    depths = {f"efficientnet_b{i}": m for i, m in enumerate((1.0, 1.1, 1.2, 1.4, 1.8, 2.2, 2.6,
                                                             3.1))}
    for name, mult in depths.items():
        with torch.device("meta"):
            bb = create_backbone(name, dtype=torch.float32)
        blocks = sum(isinstance(m, teff.MBConv) for m in bb.children())
        assert blocks == sum(-(-r * mult // 1) for r in (1, 2, 2, 3, 3, 4, 1)), name


def test_param_labels_put_the_heads_in_the_classifier_group():
    """nkbx's labels of a multi-task classifier's tree, under the port's
    names, equal the port's: the heads ``classifier``, the rest (MobileNetV3's
    ``Dense_0`` feature head included) ``backbone``."""
    classes = {"size": ["s", "l"], "color": ["a", "b", "c"]}
    leaf_names = {"kernel": "weight", "scale": "weight"}
    for jbb, tbb in ((jmnv3.MobileNetV3(spec=MNV3_SPEC, last_conv=32, head_features=16),
                      tmnv3.MobileNetV3(spec=MNV3_SPEC, last_conv=32, head_features=16)),
                     (jeff.EfficientNetV2(spec=V2_SPEC, stem_width=8),
                      teff.EfficientNetV2(spec=V2_SPEC, stem_width=8))):
        jmod = JMulti(backbone=jbb, classes=classes)
        params = jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x, train=False),
                                jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))["params"]
        want = {}
        for path, label in jax.tree_util.tree_flatten_with_path(jparam_labels(params))[0]:
            keys = [p.key for p in path]
            want[".".join(keys[:-1] + [leaf_names.get(keys[-1], keys[-1])])] = label
        got = param_labels(MultitaskClassifier(tbb, classes))
        assert got == want
        assert {k for k, v in got.items() if v == "classifier"} == {
            f"head_{t}.{w}" for t in classes for w in ("weight", "bias")}


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
    name = "mobilenetv3"
    variables, jmod = _variables(name), _jax_net(name)
    jmodel = JModel(jmod, variables, list("abc"), "single", 40)
    jbundle = jget_optimizer(variables["params"], SGD)
    jstep = jbuild_train_step(jmodel, jget_loss({"type": "CrossEntropyLoss"}), jbundle,
                              augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                              masked_bn=True)
    jstate = JState.create(variables["params"], variables["batch_stats"], jbundle.tx)
    module = _port_state(name)
    model = ClassificationModel(module, list("abc"), "single", 40, (SIZE, SIZE), torch.float32,
                                torch.device("cpu"))
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


@pytest.mark.parametrize("name,emb", [("mobilenetv3_large_100", 1280), ("efficientnet_b0", 1280)])
def test_full_width_bf16_forward_on_cpu(name, emb):
    model = get_model({"model": name, "backbone_dropout": 0.1}, list("abcde"),
                      input_size=(96, 96), device="cpu", dtype=torch.bfloat16)
    assert model.emb_size == emb
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3),
                                                           dtype=np.uint8))
    out = model(Compose([Normalize()]).device_apply(x, torch.bfloat16))
    assert out.shape == (2, 5) and out.dtype == torch.float32 and torch.isfinite(out).all()
