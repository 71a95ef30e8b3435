"""The nkbx_torch serving slice against nkbx, end to end, on the CPU.

A tiny Swin (embed 16, depths (2, 2), heads (1, 2), 32 px input) is built on
both sides; nkbx's variables, perturbed so that no bias or LayerNorm leaf
sits at its init, are carried across with ``from_jax_variables``. The same
uint8 batch, made with numpy, goes through nkbx's Normalize + model and the
port's. Window 2 covers the shift mask in both stages and PatchMerging;
window 8 covers the window collapse (8 -> 4 on the 4x4 stage-1 grid, no
shift, a 7x7 bias table).

Tolerance: float32 logits 5e-4 (the remaining differences are nkbx's erf and
reciprocal approximations and the order of sums, through 4 blocks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models.classifier import MultitaskClassifier as JMulti
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.swin import SwinTransformer as JSwin
from nkbx.transforms import spec as jspec
from nkbx.transforms.device import build_device_fn as jbuild_device_fn
from nkbx_torch.export import ServingModule, default_buckets
from nkbx_torch.models import get_model
from nkbx_torch.models.classifier import (ClassificationModel, MultitaskClassifier,
                                          SingletaskClassifier)
from nkbx_torch.models.convert import from_jax_variables
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.transforms import Compose, Normalize
from nkbx_torch.transforms.device import build_device_fn

TINY = dict(embed_dim=16, depths=(2, 2), n_heads=(1, 2))
SIZE = 32
MULTI = {"color": ["r", "g", "b"], "shape": ["o", "x"]}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_side(window, task):
    """(variables, predict) of nkbx's classifier, params perturbed."""
    backbone = JSwin(window=window, dtype=jnp.float32, **TINY)
    module = (JSingle(backbone=backbone, n_classes=3) if task == "single"
              else JMulti(backbone=backbone, classes=MULTI))
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        jax.device_get(variables))
    norm = jbuild_device_fn([jspec.Normalize()])

    def predict(images):
        x = norm(jnp.asarray(images), jax.random.PRNGKey(0), False)
        return jax.device_get(module.apply(variables, x, train=False))

    return variables, predict


def _port(window, task, **opts):
    backbone = SwinTransformer(window=window, dtype=torch.float32, img_size=(SIZE, SIZE),
                               **TINY, **opts)
    module = (SingletaskClassifier(backbone, 3) if task == "single"
              else MultitaskClassifier(backbone, MULTI))
    variables, _ = _jax_side(window, task)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    module.eval()
    classes = list("abc") if task == "single" else MULTI
    return ClassificationModel(module, classes, task, backbone.num_features, (SIZE, SIZE),
                               torch.float32, torch.device("cpu"))


def _port_predict(model, images):
    norm = build_device_fn([Normalize()])
    return model(norm(torch.from_numpy(images)))


def _assert_close(got, want, atol=5e-4):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("window,task", [(2, "single"), (8, "single"), (2, "multi")])
@pytest.mark.parametrize("fused", [None, True])
def test_logits_match_nkbx(window, task, fused):
    """fused=True takes the kernels' entries, which on CPU tensors compute
    the plain versions; None is auto, the plain versions off the card."""
    _, predict = _jax_side(window, task)
    model = _port(window, task, fused_attention=fused, fused_mlp=fused)
    images = _images(3)
    _assert_close(_port_predict(model, images), predict(images))


def test_window_collapse_sizes_bias_table():
    model = _port(8, "single")
    bb = model.module.backbone
    assert bb.stage0_block1.attn.relative_position_bias_table.shape == (15 ** 2, 1)
    assert bb.stage1_block1.attn.relative_position_bias_table.shape == (7 ** 2, 2)
    with pytest.raises(ValueError, match="window"):
        bb(torch.zeros(1, 64, 64, 3))  # stage-1 grid 8 wants the 8x8 window


def test_normalize_matches_nkbx():
    images = _images(2, seed=4)
    want = jbuild_device_fn([jspec.Normalize()])(jnp.asarray(images), jax.random.PRNGKey(0),
                                                 False)
    got = build_device_fn([Normalize()])(torch.from_numpy(images))
    # XLA may turn the divide into a multiply by 1/std: one f32 ulp apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7, atol=0)
    got16 = Compose([Normalize()]).device_apply(torch.from_numpy(images), torch.bfloat16)
    assert got16.dtype == torch.bfloat16


def test_random_device_ops_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Compose([Normalize(), type("HorizontalFlip", (jspec.Transform,), {"stage": "device"})()])


def test_from_jax_variables_raises_on_missing_and_leftover():
    variables, _ = _jax_side(2, "single")
    module = _port(2, "single").module
    params = dict(variables["params"])
    params["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="leftover"):
        from_jax_variables({"params": params}, reference=module)
    params = dict(variables["params"])
    del params["head"]
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": params}, reference=module)


@pytest.mark.parametrize("task", ["single", "multi"])
def test_serving_pads_and_chunks(task):
    """Buckets (2, 4): 1 image pads to 2, 3 to 4, and 9 runs as 4 + 4 + 1->2;
    each request's logits match nkbx's on the same images."""
    _, predict = _jax_side(2, task)
    serving = ServingModule(_port(2, task), buckets=(2, 4))
    for n in (1, 3, 9):
        images = _images(n, seed=n)
        out = serving(images)
        shapes = ([v.shape for v in out.values()] if isinstance(out, dict) else [out.shape])
        assert all(s[0] == n for s in shapes)
        _assert_close(out, predict(images))


def test_serving_benchmark_keys_on_cpu():
    serving = ServingModule(_port(2, "single"), buckets=(2, 4), warm_up_on_load=False)
    rows = serving.benchmark_sweep(iters=2)
    assert [r["batch_size"] for r in rows] == [2, 4]
    assert {"p50_ms", "images_per_sec", "compute_p50_ms", "pipelined_ms"} <= set(rows[0])
    assert "pad_miss_vs_prev_ms" in rows[1]
    assert default_buckets(32) == [1, 2, 4, 8, 16, 32]


def test_get_model_full_width_on_cpu_is_finite():
    model = get_model({"model": "swin_tiny_patch4_window7_224"}, list("abcdefghij"),
                      device="cpu", dtype=torch.bfloat16)
    assert model.emb_size == 768
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3),
                                                           dtype=np.uint8))
    out = model(build_device_fn([Normalize()])(x, torch.bfloat16))
    assert out.shape == (1, 10) and out.dtype == torch.float32 and torch.isfinite(out).all()


def test_unported_backbone_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model({"model": "densenet121"}, list("ab"), device="cpu")


@pytest.mark.slow
def test_full_width_swin_tiny_matches_nkbx():
    from nkbx.models.swin import swin_tiny_patch4_window7_224 as jtiny

    module = JSingle(backbone=jtiny(dtype=jnp.float32), n_classes=4)
    variables = jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                           train=False))
    backbone = SwinTransformer(dtype=torch.float32)
    port = SingletaskClassifier(backbone, 4)
    port.load_state_dict(from_jax_variables(variables, reference=port))
    port.eval()
    images = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)
    x = jbuild_device_fn([jspec.Normalize()])(jnp.asarray(images), jax.random.PRNGKey(0), False)
    want = module.apply(variables, x, train=False)
    with torch.inference_mode():
        got = port(build_device_fn([Normalize()])(torch.from_numpy(images)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
