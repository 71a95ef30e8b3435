"""The port's ConvNeXt family and its MLP-only fused MLP against nkbx's, on
the CPU.

- The plain K7/K8 (``reference_mlp``, ``reference_mlp_bwd`` and the port's
  ``fused_mlp`` entry, whose halves are the plain versions on CPU tensors)
  against nkbx's ``fused_mlp(..., interpret=True)``, the Pallas kernels
  ``_fwd_kernel`` and ``_bwd_kernel`` in interpret mode, and its
  ``jax.vjp``, at a row count that tiles and one whose last tile is ragged;
  the entry's autograd against autograd through ``reference_mlp``.
- nkbx's own test model, ``ConvNeXt(depths=(1, 1), dims=(16, 32))`` on
  64x64 inputs (stage rows 512 and 128 per image pair, both tiling in
  nkbx), built on both sides, nkbx's weights carried across by
  ``from_jax_variables``: fused MLP off, on (nkbx's LN-fused Pallas kernel
  in interpret mode) and on under ``NKBX_FUSED_LN_MLP=0`` (nkbx's MLP-only
  kernel, the port's ``fused_mlp``).
- The converter's ``layer_scale`` and depthwise-kernel layouts and its key
  checks; the registry's five names; the gate's answers per width and
  dtype.
- A 3-step train lockstep of the tiny ConvNeXt against nkbx's
  ``build_train_step``, as tests/test_torch_train.py does for Swin.

nkbx initialises every ``layer_scale`` to 1e-6, which leaves every MLP
gradient ~1e6 times under the head's and so below any check's resolution;
the tests draw the layer-scales from a seeded U[0.1, 1] (trained ConvNeXts'
scales are of that order) after the usual perturbation of the other leaves.

Tolerances, float32: the fused MLP forward 1e-5, its gradients 1e-4 of each
one's largest value (the same math; what is left is the order of sums and
nkbx's rational erf with a Newton-refined reciprocal against torch's erf);
logits 5e-4 (through 2 blocks, as tests/test_torch_swin.py); bfloat16
``reference_mlp`` against nkbx's 3.2e-2 (both round u, g and y to bf16 at the
same points; one bf16 ulp of the outputs, which stay under 4); the lockstep
as tests/test_torch_train.py states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.convnext import ConvNeXt as JConvNeXt
from nkbx.ops import mlp as jmlp
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx.transforms.device import build_device_fn as jbuild_device_fn
from nkbx_torch.models import from_jax_variables, get_model, list_backbones, param_labels
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.convnext import ConvNeXt
from nkbx_torch.ops import mlp as tmlp
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize
from nkbx_torch.transforms.device import build_device_fn

# --- the MLP-only fused MLP ---------------------------------------------------------


def _mlp_inputs(r, c, f, seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.randn(r, c), rng.randn(c, f) / np.sqrt(c), 0.1 * rng.randn(f),
         rng.randn(f, c) / np.sqrt(f), 0.1 * rng.randn(c), rng.randn(r, c))
    return [v.astype(np.float32) for v in a]


@pytest.mark.parametrize("r,c,f", [(256, 32, 128), (260, 32, 128), (260, 16, 64)])
def test_mlp_matches_pallas_interpret(r, c, f):
    """Rows 256 take one 256-row tile in nkbx; 260 a 256-row tile and a
    ragged one of 4 rows. Forward: the port's entry on CPU tensors against
    the Pallas kernel; backward: the plain backward and the entry's autograd
    Function against jax.vjp of the Pallas kernel."""
    x, w0, b0, w1, b1, dy = _mlp_inputs(r, c, f)
    want, vjp = jax.vjp(lambda *a: jmlp.fused_mlp(*a, interpret=True),
                        *(jnp.asarray(t) for t in (x, w0, b0, w1, b1)))
    wants = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, w0, b0, w1, b1)]
    before = tmlp.fused_mlp.launches, tmlp.fused_mlp_bwd.launches
    got = tmlp.fused_mlp(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(dy))
    plain = tmlp.reference_mlp_bwd(*(torch.from_numpy(t) for t in (x, w0, b0, w1, b1)),
                                   torch.from_numpy(dy))
    assert (tmlp.fused_mlp.launches, tmlp.fused_mlp_bwd.launches) == before  # no kernel here
    for name, leaf, p, w in zip(("dx", "dw0", "db0", "dw1", "db1"), leaves, plain, wants):
        w = np.asarray(w)
        assert p.dtype == torch.float32 and p.shape == leaf.shape, name
        atol = 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


def test_mlp_function_backward_matches_autograd_of_plain():
    x, w0, b0, w1, b1, dy = (torch.from_numpy(t) for t in _mlp_inputs(37, 24, 96, seed=1))
    a = [t.clone().requires_grad_() for t in (x, w0, b0, w1, b1)]
    b = [t.clone().requires_grad_() for t in (x, w0, b0, w1, b1)]
    tmlp.fused_mlp(a[0].reshape(37, 1, 24), *a[1:]).backward(dy.reshape(37, 1, 24))
    tmlp.reference_mlp(*b).backward(dy)
    for name, p, q in zip(("x", "w0", "b0", "w1", "b1"), a, b):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-5 * q.grad.abs().max(),
                                   msg=name)


def test_reference_mlp_matches_nkbx_bf16():
    x, w0, b0, w1, b1, _ = _mlp_inputs(48, 32, 128, seed=2)
    jargs = [jnp.asarray(t, jnp.bfloat16) for t in (x, w0)] + [jnp.asarray(b0)]
    jargs += [jnp.asarray(w1, jnp.bfloat16), jnp.asarray(b1)]
    targs = [torch.from_numpy(t) for t in (x, w0, b0, w1, b1)]
    for i in (0, 1, 3):
        targs[i] = targs[i].to(torch.bfloat16)
    want = jmlp.reference_mlp(*jargs)
    got = tmlp.reference_mlp(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3.2e-2)


def test_plain_backward_rounds_at_the_kernels_points():
    """In bf16 the plain backward returns dx, dw0 and dw1 in bf16 and db0,
    db1 in f32, within bf16 noise of the same backward on the same values in
    f32; db1 is the f32 column sum of dy."""
    x, w0, b0, w1, b1, dy = (torch.from_numpy(t) for t in _mlp_inputs(64, 32, 128, seed=3))
    bf = [t.to(torch.bfloat16) for t in (x, w0)] + [b0, w1.to(torch.bfloat16), b1]
    dx, dw0, db0, dw1, db1 = tmlp.reference_mlp_bwd(*bf, dy.to(torch.bfloat16))
    assert (dx.dtype, dw0.dtype, dw1.dtype) == (torch.bfloat16,) * 3
    assert (db0.dtype, db1.dtype) == (torch.float32,) * 2
    f32 = tmlp.reference_mlp_bwd(*(t.float() for t in bf), dy.to(torch.bfloat16).float())
    for name, a, b in zip(("dx", "dw0", "db0", "dw1", "db1"), (dx, dw0, db0, dw1, db1), f32):
        err = (a.float() - b).abs().max() / b.abs().max()
        assert 0 <= err < 2e-2, name
    torch.testing.assert_close(db1, dy.to(torch.bfloat16).float().sum(0))


# --- the gate -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,c,env_ln,want", [
    (torch.bfloat16, 96, "", "ln"), (torch.bfloat16, 768, "", "ln"),
    (torch.bfloat16, 96, "0", "mlp"), (torch.bfloat16, 768, "0", "mlp"),
    (torch.float32, 96, "", "ln"), (torch.float32, 768, "", "ln"),
    (torch.float32, 384, "0", "mlp"), (torch.float32, 768, "0", "mlp"),
    (torch.bfloat16, 40, "0", "mlp"),  # off the tensor-core grid: the FMA kernels
    # Swin-L / ConvNeXt-L's widest stage: neither backward tile fits at 16
    # rows (K6 238,848 B in bf16, K8 238,592 B; 232,448 B is a block's most)
    (torch.bfloat16, 1536, "", None), (torch.bfloat16, 1536, "0", None),
    (torch.float32, 1536, "", None),
])
def test_gate_answers_per_width_and_dtype(monkeypatch, dtype, c, env_ln, want):
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", env_ln)
    assert tmlp.fused_mlp_mode(True, torch.zeros(1, c, dtype=dtype), 4 * c) == want


def test_gate_takes_the_mlp_kernels_where_only_they_fit(monkeypatch):
    """nkbx's order: the LN-fused kernels where they fit, else the MLP-only
    ones. No real width falls between the two rules, so K6's is shrunk."""
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.delenv("NKBX_FUSED_LN_MLP", raising=False)
    x = torch.zeros(1, 96, dtype=torch.bfloat16)
    assert tmlp.fused_mlp_mode(True, x, 384) == "ln"
    monkeypatch.setattr(tmlp, "bwd_smem_bytes", lambda tr, c, tc: tmlp._MAX_SMEM + 1)
    assert tmlp.fused_mlp_mode(True, x, 384) == "mlp"
    monkeypatch.setattr(tmlp, "mlp_bwd_smem_bytes", lambda tr, c, tc: tmlp._MAX_SMEM + 1)
    assert tmlp.fused_mlp_mode(True, x, 384) is None


def test_mlp_kernel_layouts():
    for c, tc in ((96, True), (768, True), (96, False), (768, False)):
        assert tmlp.mlp_smem_bytes(16, c, tc) == tmlp.smem_bytes(16, c, tc)
        # K8 keeps no row statistics: one 256-byte-aligned part fewer than K6
        assert tmlp.bwd_smem_bytes(16, c, tc) - tmlp.mlp_bwd_smem_bytes(16, c, tc) == 256
        assert tmlp.pick_tile_rows(c, tc, tmlp.mlp_bwd_smem_bytes) is not None


# --- the tiny ConvNeXt against nkbx's ------------------------------------------------

TINY = dict(depths=(1, 1), dims=(16, 32))
SIZE = 64


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _variables(module):
    """nkbx's variables of ``module``, every leaf perturbed by N(0, 0.05),
    then every layer_scale drawn from U[0.1, 1] (seeded)."""
    variables = jax.device_get(module.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(1)
    perturbed = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), variables)
    scales = np.random.default_rng(2)

    def fix(path, leaf):
        if path[-1].key == "layer_scale":
            return scales.uniform(0.1, 1.0, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, perturbed)


def _jax_module(fused):
    return JSingle(backbone=JConvNeXt(dtype=jnp.float32, fused_mlp=fused, **TINY), n_classes=3)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """nkbx's variables; its param tree is the same for every fused_mlp."""
    return _variables(_jax_module(False))


def _jax_predict(fused, images):
    """nkbx's logits; its fused_mlp_mode reads NKBX_FUSED_LN_MLP as it runs."""
    x = jbuild_device_fn([jspec.Normalize()])(jnp.asarray(images), jax.random.PRNGKey(0), False)
    return np.asarray(_jax_module(fused).apply(_jax_variables(), x, train=False))


def _port(fused):
    backbone = ConvNeXt(dtype=torch.float32, fused_mlp=fused, **TINY)
    module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(_jax_variables(), reference=module))
    return module.eval()


@pytest.mark.parametrize("fused,ln_off", [(False, False), (True, False), (True, True)])
def test_logits_match_nkbx(monkeypatch, fused, ln_off):
    """fused=True takes the kernels' entries, which on CPU tensors compute the
    plain versions; nkbx's runs its Pallas kernels in interpret mode: the
    LN-fused one, and under NKBX_FUSED_LN_MLP=0 the MLP-only one after
    flax's LayerNorm, in both packages. One set of weights for all three."""
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", "0" if ln_off else "")
    module = _port(fused)
    images = _images(2)
    calls = []
    real = tmlp.fused_mlp

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr("nkbx_torch.models.common.fused_mlp", spy)
    with torch.inference_mode():
        got = module(build_device_fn([Normalize()])(torch.from_numpy(images)))
    assert calls == ([(2, 16, 16, 16), (2, 8, 8, 32)] if ln_off else [])
    np.testing.assert_allclose(got.numpy(), _jax_predict(fused, images), atol=5e-4, rtol=0)


def test_converter_layouts_and_checks():
    variables = _jax_variables()
    params = variables["params"]["backbone"]
    sd = from_jax_variables(variables)
    block = "backbone.ConvNeXtBlock_0."
    np.testing.assert_array_equal(sd[block + "layer_scale"].numpy(),
                                  params["ConvNeXtBlock_0"]["layer_scale"])
    dw = params["ConvNeXtBlock_0"]["Conv_0"]["kernel"]
    assert dw.shape == (7, 7, 1, 16) and sd[block + "Conv_0.weight"].shape == (16, 1, 7, 7)
    np.testing.assert_array_equal(sd[block + "Conv_0.weight"].numpy()[5, 0], dw[:, :, 0, 5])
    np.testing.assert_array_equal(sd["backbone.Conv_1.weight"].numpy(),
                                  params["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    assert sd[block + "Dense_0.weight"].shape == (64, 16)
    assert sorted(k for k in sd if k.startswith("backbone.LayerNorm_")) == [
        "backbone.LayerNorm_0.bias", "backbone.LayerNorm_0.weight",
        "backbone.LayerNorm_1.bias", "backbone.LayerNorm_1.weight"]
    module = _port(False)
    tree = dict(variables["params"])
    tree["extra"] = {"layer_scale": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="leftover"):
        from_jax_variables({"params": tree}, reference=module)
    backbone = dict(params)
    backbone["ConvNeXtBlock_1"] = {k: v for k, v in params["ConvNeXtBlock_1"].items()
                                   if k != "layer_scale"}
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": {**variables["params"], "backbone": backbone}},
                           reference=module)


def test_registry_names_and_init():
    names = [n for n in list_backbones() if n.startswith("convnext")]
    assert names == ["convnext_base", "convnext_large", "convnext_small", "convnext_tiny",
                     "convnext_xlarge"]
    model = get_model({"model": "convnext_tiny"}, list("abcdefghij"), input_size=(32, 32),
                      device="cpu", dtype=torch.float32)
    bb = model.module.backbone
    assert model.emb_size == 768 and bb.ConvNeXtBlock_17.Dense_1.weight.shape == (768, 3072)
    assert bb.ConvNeXtBlock_3.layer_scale.eq(1e-6).all()  # flax's constant init
    assert bb.ConvNeXtBlock_0.Conv_0.weight.shape == (96, 1, 7, 7)
    assert bb.ConvNeXtBlock_0.Conv_0.weight.std().item() == pytest.approx(49 ** -0.5, rel=0.1)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3),
                                                           dtype=np.uint8))
    out = model(build_device_fn([Normalize()])(x))
    assert out.shape == (1, 10) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="A12"):
        ConvNeXt(remat_stages=(2,), **TINY)


def test_same_padding_at_odd_sizes_matches_nkbx():
    """At 70 px the stem pads (70 = 4*17 + 2: total 2, one row each side)
    and the downsample pads one row and column at the high end (9 -> 5)."""
    images = np.random.default_rng(5).integers(0, 256, (1, 70, 70, 3), dtype=np.uint8)
    want = _jax_predict(False, images)
    with torch.inference_mode():
        got = _port(False)(build_device_fn([Normalize()])(torch.from_numpy(images)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


# --- the train step against nkbx's ----------------------------------------------------

BATCH, STEPS = 4, 3
NADAM = {"type": "nadam", "backbone_lr": 1e-3, "classifier_lr": 1e-2,
         "backbone_weight_decay": 0.05, "classifier_weight_decay": 0.01}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]
NOISE = 1e-7  # f32 rounding noise of a gradient that is zero in exact arithmetic


def _batches():
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (STEPS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (STEPS, BATCH)).astype(np.int64)
    mask = np.ones(BATCH, bool)
    mask[-1] = False
    return images, labels, mask


@functools.lru_cache(maxsize=None)
def _nkbx_run():
    """(grads of step 1, losses, params after each step), nkbx's XLA path
    from the weights of ``_jax_variables()``."""
    variables = _jax_variables()
    module = _jax_module(False)
    model = JModel(module, variables, list("abc"), "single", 32)
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
    return from_jax_variables({"params": grads}), losses, params


@pytest.mark.parametrize("fused,ln_off", [(None, False), (True, False), (True, True)])
def test_train_step_lockstep_with_nkbx(monkeypatch, fused, ln_off):
    """fused=None is autograd through the plain forward; True goes through
    the LN-fused kernels' autograd Function, and under NKBX_FUSED_LN_MLP=0
    through the MLP-only one (their plain halves on the CPU). The
    tolerances are tests/test_torch_train.py's: loss per step rtol 1e-4;
    step-1 grads 1e-4 of each leaf's largest value; params after each step
    2e-6 + 1e-5 relative, plus 2 * lr of a step wherever a gradient is
    under 1e-4 of its leaf's largest (NAdam's first steps move such an
    element by about lr * sign(g))."""
    monkeypatch.delenv("NKBX_FUSED_MLP", raising=False)
    monkeypatch.setenv("NKBX_FUSED_LN_MLP", "0" if ln_off else "")
    jgrads, jlosses, jparams = _nkbx_run()
    module = _port(fused)
    model = ClassificationModel(module, list("abc"), "single", 32, (SIZE, SIZE),
                                torch.float32, torch.device("cpu"))
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
        assert metrics["loss"].item() == pytest.approx(jlosses[i], rel=1e-4)
        for name, p in model.module.named_parameters():
            g = p.grad
            assert g is not None, name
            if i == 0:
                want = jgrads[name].numpy()
                np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                           atol=1e-4 * np.abs(want).max() + NOISE, err_msg=name)
            lr = NADAM[f"{labels_of[name]}_lr"] * LR_FACTORS[i]
            lr *= FREEZE_SCALES[i] if labels_of[name] == "backbone" else 1.0
            unresolved = (g.abs() < 1e-4 * g.abs().max()) | (g.abs().max() < NOISE)
            slack[name] += 2 * lr * unresolved.float()
            want = jparams[i][name].numpy()
            bound = 2e-6 + 1e-5 * np.abs(want) + slack[name].numpy()
            assert (np.abs(p.detach().numpy() - want) <= bound).all(), name
    assert state.step == STEPS
