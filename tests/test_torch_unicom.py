"""The port's unicom ViT and the ViT's ``pool``/``projection_dim`` fields
against nkbx's, on the CPU.

- A tiny ``UnicomViT`` (patch 8, dim 64, 4 heads, 2 blocks, embedding 32,
  32 px: 16 tokens, no class token) built on both sides, nkbx's perturbed
  weights and running statistics carried across by ``from_jax_variables``,
  the same batch of 8 through both (8 x 16 = 128 rows, so nkbx's fused
  LN-MLP takes its Pallas kernel): with ``fused_attention``/``fused_mlp``
  off, and on (nkbx's Pallas kernels in interpret mode, the port's entries
  computing their plain versions on CPU tensors), in eval and train mode,
  the head's BatchNorm1d running statistics after the train forward, and a
  train forward with two padded rows masked out of the head's statistics.
- The fused blocks hand LayerNorm eps 1e-5 to the LN-MLP kernel and None for
  the attention's bias and mask.
- A 3-step train lockstep against nkbx's ``build_train_step`` (SGD, a
  freeze flip, a padded row, ``masked_bn=True``).
- The registry: ``"unicom ViT-B/32"`` etc. parse as nkbx's, an unknown
  variant raises, ``list_backbones()`` equals nkbx's, and the three unicom
  ViTs at full size (as shapes) map leaf for leaf onto nkbx's trees.
- A tiny ViT with ``pool="mean"`` and ``projection_dim`` (no class token, a
  ``feature_proj`` Dense) against nkbx's.

Tolerances, float32: logits 5e-4 and running statistics 1e-4 + 1e-4
relative (as tests/test_torch_zoo.py); the lockstep's losses 1e-4 relative
and parameters 2e-6 + 1e-5 relative plus lr * 3e-2 of a leaf's largest
gradient per step (as tests/test_torch_zoo.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.registry import create_backbone as jcreate_backbone
from nkbx.models.registry import list_backbones as jlist_backbones
from nkbx.models.vit import UnicomViT as JUnicom
from nkbx.models.vit import ViT as JViT
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx_torch.models import common as tcommon
from nkbx_torch.models import convert as tconvert
from nkbx_torch.models import vit as tvit
from nkbx_torch.models import create_backbone, from_jax_variables, list_backbones, param_labels
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.vit import UnicomViT, ViT
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize

SIZE = 32
TINY = dict(patch_size=8, dim=64, depth=2, n_heads=4, embedding_size=32)
BATCH = 8


def _jax_net(fused):
    return JSingle(backbone=JUnicom(dtype=jnp.float32, fused_attention=fused, fused_mlp=fused,
                                    **TINY), n_classes=3)


def _port_net(fused):
    return SingletaskClassifier(UnicomViT(dtype=torch.float32, fused_attention=fused,
                                          fused_mlp=fused, img_size=(SIZE, SIZE), **TINY), 3)


@functools.lru_cache(maxsize=None)
def _variables():
    """nkbx's variables of the tiny unicom classifier, every leaf perturbed
    (the running variances kept positive)."""
    variables = jax.device_get(jax.jit(lambda x: _jax_net(False).init(
        jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port_state(fused):
    module = _port_net(fused)
    module.load_state_dict(from_jax_variables(_variables(), reference=module))
    return module


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _check_stats(module, mutated):
    want = from_jax_variables({"params": _variables()["params"],
                               "batch_stats": jax.device_get(mutated["batch_stats"])})
    keys = [k for k in module.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 4  # feature_bn1 and feature_bn2
    for key in keys:
        np.testing.assert_allclose(module.state_dict()[key].numpy(), want[key].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_logits_and_head_statistics_match_nkbx(fused):
    jmod, variables = _jax_net(fused), _variables()
    x = _images(BATCH)

    @jax.jit
    def both(v, xx):
        return (jmod.apply(v, xx, train=False),
                jmod.apply(v, xx, train=True, mutable=["batch_stats"]))

    want_eval, (want_train, mutated) = both(variables, jnp.asarray(x))
    module = _port_state(fused)
    with torch.no_grad():
        got_eval = module.eval()(torch.from_numpy(x))
        got_train = module.train()(torch.from_numpy(x))
    assert np.abs(np.asarray(want_eval)).max() > 0.1
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=5e-4, rtol=0)
    _check_stats(module, mutated)


def test_masked_head_statistics_match_nkbx():
    """Two padded rows (zeros) masked out of the head's BatchNorm1d pair in
    a train forward: the valid rows' logits and the running statistics."""
    jmod, variables = _jax_net(False), _variables()
    x = _images(BATCH, seed=2)
    x[-2:] = 0
    mask = (np.arange(BATCH) < BATCH - 2).reshape(-1, 1, 1, 1)
    want, mutated = jax.jit(lambda v, xx, m: jmod.apply(v, xx, train=True, mask=m,
                                                        mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(mask))
    module = _port_state(False).train()
    with torch.no_grad():
        got = module(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[:-2], np.asarray(want)[:-2], atol=5e-4, rtol=0)
    _check_stats(module, mutated)


def test_fused_blocks_pass_eps_1e5_and_no_attention_bias(monkeypatch):
    seen = {"eps": [], "attn": []}
    ln_mlp, attention = tcommon.fused_ln_mlp, tvit.fused_attention

    def ln_mlp_spy(*args, gamma=None, eps):
        seen["eps"].append(eps)
        return ln_mlp(*args, gamma=gamma, eps=eps)

    def attention_spy(q, k, v, bias, mask, scale, heads):
        seen["attn"].append((bias, mask, heads))
        return attention(q, k, v, bias, mask, scale, heads)

    monkeypatch.setattr(tcommon, "fused_ln_mlp", ln_mlp_spy)
    monkeypatch.setattr(tvit, "fused_attention", attention_spy)
    with torch.no_grad():
        _port_state(True).eval()(torch.from_numpy(_images(2)))
    assert seen == {"eps": [1e-5, 1e-5], "attn": [(None, None, 4)] * 2}


# --- the train step against nkbx's ----------------------------------------------------

STEPS = 3
SGD = {"type": "sgd", "backbone_lr": 1e-2, "classifier_lr": 1e-2,
       "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-4}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]
GATE_FLIP = 3e-2


def test_train_step_lockstep_with_nkbx():
    variables, jmod = _variables(), _jax_net(False)
    jmodel = JModel(jmod, variables, list("abc"), "single", TINY["embedding_size"])
    jbundle = jget_optimizer(variables["params"], SGD)
    jstep = jbuild_train_step(jmodel, jget_loss({"type": "CrossEntropyLoss"}), jbundle,
                              augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                              masked_bn=True)
    jstate = JState.create(variables["params"], variables["batch_stats"], jbundle.tx)
    module = _port_state(False)
    model = ClassificationModel(module, list("abc"), "single", TINY["embedding_size"],
                                (SIZE, SIZE), torch.float32, torch.device("cpu"))
    state = TrainState.create(model)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=True)
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (STEPS, 4, SIZE, SIZE, 3), dtype=np.uint8)
    images[:, -1] = 0  # the loader's padded row
    labels = rng.integers(0, 3, (STEPS, 4)).astype(np.int64)
    mask = np.array([True, True, True, False])
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


# --- the registry ----------------------------------------------------------------------


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


@pytest.mark.parametrize("name,emb", [("unicom ViT-B/32", 512), ("unicom ViT-B/16", 768),
                                      ("unicom ViT-L/14", 768)])
def test_unicom_names_map_every_leaf_at_full_size(name, emb):
    jbb = jcreate_backbone(name, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jbb.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    want = _flax_shapes({"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    with torch.device("meta"):
        bb = create_backbone(name, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in bb.state_dict().items()} == want
    assert bb.num_features == jbb.num_features == emb


def test_registry_lists_and_parses_nkbx_names():
    assert list_backbones() == jlist_backbones()
    for bad in ("unicom ViT-H/14", "unicom"):
        with pytest.raises(NotImplementedError, match="Unknown unicom variant"):
            create_backbone(bad)
    with pytest.raises(NotImplementedError, match="Did you mean 'densenet121'.*Full list"):
        create_backbone("densenet12")


# --- the ViT's pool and projection_dim ------------------------------------------------

VIT = dict(patch_size=8, dim=64, depth=1, n_heads=2)


@pytest.mark.parametrize("pool,proj", [("mean", None), ("mean", 24), ("cls", 24)])
def test_vit_pool_and_projection_match_nkbx(pool, proj):
    jmod = JSingle(backbone=JViT(dtype=jnp.float32, pool=pool, projection_dim=proj, **VIT),
                   n_classes=3)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                         train=False))
    rng = np.random.default_rng(4)
    variables = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32), variables)
    backbone = ViT(dtype=torch.float32, pool=pool, projection_dim=proj, img_size=(SIZE, SIZE),
                   **VIT)
    assert backbone.num_features == (proj or VIT["dim"])
    assert hasattr(backbone, "cls_token") is (pool == "cls")
    module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    x = _images(3, seed=5)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
