"""The port's ResNet family, its BatchNorm and the fused bottleneck chain
against nkbx's, on the CPU.

- The plain chain (the port's ``fused_chain``, whose halves are
  ``reference_chain`` / ``reference_chain_bwd`` on CPU tensors) against
  nkbx's ``fused_chain`` (the Pallas kernels ``_fwd_kernel`` and
  ``_bwd_kernel`` in interpret mode) and nkbx's ``reference_chain``, at
  tests/test_fused_bottleneck.py's geometry B, H, W, C, M = 4, 8, 8, 16, 8,
  g = 2, banded (th = 4) and single-band (th = H): the output, the six
  per-tile statistics and all ten gradients.
- ``stat_band`` against nkbx's ``chain_tile``.
- ``TorchBatchNorm`` exact, masked and ghost against nkbx's: outputs, the
  input gradient and the running statistics.
- Tiny ResNets of each stem and block kind, nkbx's weights and running
  statistics carried across by ``from_jax_variables``: eval and train
  forwards and the running statistics after the train forward.
- nkbx's tiny fused ResNet (``stage_sizes=(2,)``, ``stem_width=8``,
  ``ghost_bn=2``): outputs, running statistics and every gradient, its
  identity block through the chain on both sides.
- 3-step train locksteps against nkbx's ``build_train_step``: ghost BN with
  the fused chain, and ``masked_bn=True`` on a batch with a padded row.
- resnet50 at full width through the plain chain: finite.

Tolerances, float32: the chain's output and statistics 1e-5, its gradients
5e-4 relative + 5e-4 absolute (nkbx's own test); the BatchNorm 1e-5; logits
and running statistics of the tiny nets 1e-4 (through up to six BatchNorms
of batch statistics, each of which divides by a small-batch deviation); the
fused net's gradients 1e-4 of each leaf's largest value; the lockstep as
tests/test_torch_train.py states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models import common as jcommon
from nkbx.models import resnet as jresnet
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.ops import bottleneck as jbn
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx_torch.models import from_jax_variables, get_model, list_backbones, param_labels
from nkbx_torch.models import resnet as tresnet
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.common import TorchBatchNorm
from nkbx_torch.ops import bottleneck as tbn
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize

GRAD_NAMES = "x w1 w2 w3 s1 b1 s2 b2 s3 b3".split()

# --- the chain ---------------------------------------------------------------------

B, H, W, C, M, G = 4, 8, 8, 16, 8, 2


def _chain_inputs():
    """tests/test_fused_bottleneck.py's inputs, as numpy."""
    rng = np.random.default_rng(0)
    mk = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    x = mk(B, H, W, C)
    args = (mk(C, M, sc=0.2), mk(3, 3, M, M, sc=0.2), mk(M, C, sc=0.2),
            rng.uniform(0.8, 1.2, M).astype(np.float32), mk(M, sc=0.1),
            rng.uniform(0.8, 1.2, M).astype(np.float32), mk(M, sc=0.1),
            rng.uniform(0.8, 1.2, C).astype(np.float32), mk(C, sc=0.1))
    return x, args


@functools.lru_cache(maxsize=None)
def _nkbx_chain(th, which):
    """nkbx's output, statistics and the ten gradients of sum(out²)/2."""
    fn = {"pallas": jbn.fused_chain, "reference": jbn.reference_chain}[which]
    x, args = _chain_inputs()
    jx, jargs = jnp.asarray(x), [jnp.asarray(a) for a in args]

    def loss(*v):
        out, stats = fn(*v, g=G, th=th)
        return jnp.sum(out ** 2 * 0.5), (out, stats)

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(10)),
                                                          has_aux=True))(jx, *jargs)
    return np.asarray(out), [np.asarray(s) for s in stats], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("which", ["pallas", "reference"])
@pytest.mark.parametrize("th", [4, H])
def test_plain_chain_matches_nkbx(th, which):
    want_out, want_stats, want_grads = _nkbx_chain(th, which)
    x, args = _chain_inputs()
    tx = torch.from_numpy(x).requires_grad_()
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out, stats = tbn.fused_chain(tx, *targs, g=G, th=th)
    assert not any(s.requires_grad for s in stats)
    assert [tuple(s.shape) for s in stats] == [s.shape for s in want_stats]
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    for got, want in zip(stats, want_stats):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    (out * out * 0.5).sum().backward()
    for name, t, want in zip(GRAD_NAMES, [tx] + targs, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=5e-4, atol=5e-4, err_msg=name)


def test_plain_backward_is_autograd_of_the_plain_forward():
    """reference_chain_bwd (K10's plain version, explicit formulas) against
    autograd through reference_chain in f32, where no rounding point differs."""
    x, args = _chain_inputs()
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *args)]
    out, _ = tbn.reference_chain(*ts, g=G, th=4)
    dout = torch.from_numpy(np.random.default_rng(1).normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, ts, dout)
    got = tbn.reference_chain_bwd(*(t.detach() for t in ts), dout, g=G, th=4)
    for name, a, b in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_chain_in_bf16_rounds_where_nkbx_does():
    """In bf16 the plain chain against nkbx's Pallas kernel in interpret mode
    (nkbx's reference_chain rounds u1, u2, u3 to bf16 and is not the
    kernel's numbers): the output within 2 bf16 ulps of its largest value
    (both keep u1-u3 in f32 and round a1, a2, y3 and the residual sum, so a
    last-bit difference in f32 flips a rounding), the statistics within 1e-2
    relative."""
    x, args = _chain_inputs()
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    targs = [bf(a) for a in args[:3]] + [torch.from_numpy(a) for a in args[3:]]
    out, stats = tbn.reference_chain(bf(x), *targs, g=G, th=4)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:3]] + [jnp.asarray(a) for a in args[3:]]
    want, wstats = jbn.fused_chain(jnp.asarray(x, jnp.bfloat16), *jargs, g=G, th=4)
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2 * ulp, rtol=0)
    for got, w in zip(stats, wstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-2 * np.abs(w).max(),
                                   rtol=0)


@pytest.mark.parametrize("b,h,w,c,m,g", [
    (64, 56, 56, 256, 64, 2), (64, 28, 28, 512, 128, 2), (64, 14, 14, 1024, 256, 2),
    (64, 7, 7, 2048, 512, 2), (128, 56, 56, 256, 64, 2), (256, 28, 28, 512, 128, 4),
    (2, 56, 56, 256, 64, 2), (5, 8, 8, 64, 16, 2), (4, 8, 8, 64, 16, 0), (4, 8, 8, 16, 8, 2)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stat_band_is_nkbx_chain_tile(b, h, w, c, m, g, itemsize):
    assert tbn.stat_band(b, h, w, c, m, g, itemsize) == jbn.chain_tile(b, h, w, c, m, g, itemsize)


def test_stat_band_at_resnet50_stages():
    """The bands the chip run relies on: bf16 8/7/2/None, f32 4/4/None/None."""
    stages = [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]
    for itemsize, want in ((2, [8, 7, 2, None]), (4, [4, 4, None, None])):
        assert [tbn.stat_band(64, s, s, c, m, 2, itemsize) for s, c, m in stages] == want


def test_kernel_wrappers_need_the_card():
    """On CPU tensors the entry takes the plain versions and counts nothing."""
    x, args = _chain_inputs()
    before = (tbn.fused_chain.launches, tbn.fused_chain_bwd.launches)
    tbn.fused_chain(torch.from_numpy(x), *map(torch.from_numpy, args), g=G, th=4)
    assert (tbn.fused_chain.launches, tbn.fused_chain_bwd.launches) == before


# --- BatchNorm ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "masked", "ghost", "eval"])
def test_batchnorm_matches_nkbx(mode):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 5, 4, 8)) * 2 + 1).astype(np.float32)
    ghost = 2 if mode == "ghost" else 0
    mask = np.array([1, 1, 1, 1, 0, 0], bool).reshape(-1, 1, 1, 1) if mode == "masked" else None
    jmod = jcommon.TorchBatchNorm(use_running_average=mode == "eval", ghost_bn=ghost)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.zeros((6, 5, 4, 8))))
    variables = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.uniform(0.1, 0.5, p.shape).astype(np.float32), variables)
    jmask = None if mask is None else jnp.asarray(mask)

    def jfwd(v):
        return jmod.apply({**variables, "params": v}, jnp.asarray(x), mask=jmask,
                          mutable=["batch_stats"])

    (want, mutated) = jfwd(variables["params"])
    jgrad = jax.grad(lambda xx: jnp.sum(jmod.apply(variables, xx, mask=jmask,
                                                   mutable=["batch_stats"])[0] ** 2))(
        jnp.asarray(x))
    mod = TorchBatchNorm(8, ghost_bn=ghost)
    mod.load_state_dict({k.removeprefix("X."): v for k, v in from_jax_variables(
        {"params": {"X": variables["params"]}, "batch_stats": {"X": variables["batch_stats"]}}
    ).items()})
    mod.train(mode != "eval")
    tx = torch.from_numpy(x).requires_grad_()
    got = mod(tx, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-4, rtol=1e-5)
    stats = mutated.get("batch_stats", variables["batch_stats"])
    np.testing.assert_allclose(mod.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), stats["var"], atol=1e-6, rtol=1e-6)


def test_ghost_batchnorm_refuses_a_mask_and_a_ragged_batch():
    mod = TorchBatchNorm(4, ghost_bn=2).train()
    with pytest.raises(ValueError, match="masked"):
        mod(torch.zeros(4, 2, 2, 4), mask=torch.ones(4, 1, 1, 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="divide"):
        mod(torch.zeros(3, 2, 2, 4))


# --- tiny ResNets against nkbx's ------------------------------------------------------

TINY_NETS = {
    "s2d-basic": dict(stage_sizes=(1, 1), block_cls="BasicBlock", stem_width=16),
    "tiered-bottleneck": dict(stage_sizes=(1, 1), block_cls="Bottleneck", stem="tiered",
                              stem_width=16),
    "deep-avgdown-odd": dict(stage_sizes=(1, 1), block_cls="BasicBlock", stem="deep",
                             stem_width=16, avg_down=True, size=19),
    "7x7-resnext-se": dict(stage_sizes=(1, 1), block_cls="Bottleneck", s2d_stem=False,
                           stem_width=16, cardinality=4, base_width=4, se_ratio=1 / 16),
    "s2d-ghost": dict(stage_sizes=(2,), block_cls="Bottleneck", stem_width=8, ghost_bn=2,
                      size=16),
}


def _net_kwargs(name, **extra):
    kw = dict(TINY_NETS[name], **extra)
    size = kw.pop("size", 32)
    return kw, size


def _jax_net(kw, fused=False):
    kw = dict(kw, block_cls=getattr(jresnet, kw["block_cls"]))
    if fused:
        kw["fused_bottleneck"] = True
    return JSingle(backbone=jresnet.ResNet(dtype=jnp.float32, **kw), n_classes=3)


def _port_net(kw, fused=False):
    kw = dict(kw, block_cls=getattr(tresnet, kw["block_cls"]))
    if fused:
        kw["fused_bottleneck"] = True
    return SingletaskClassifier(tresnet.ResNet(dtype=torch.float32, **kw), 3)


@functools.lru_cache(maxsize=None)
def _net_variables(name):
    """nkbx's variables of a tiny net, every leaf perturbed (the running
    variances kept positive)."""
    kw, size = _net_kwargs(name)
    variables = jax.device_get(jax.jit(lambda x: _jax_net(kw).init(jax.random.PRNGKey(0), x,
                                                                   train=False))(
        jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _net_images(n, size, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, size, size, 3))).astype(np.float32)


def _port_state(name, fused=False):
    kw, _ = _net_kwargs(name)
    module = _port_net(kw, fused)
    module.load_state_dict(from_jax_variables(_net_variables(name), reference=module))
    return module


@pytest.mark.parametrize("name", sorted(TINY_NETS))
def test_tiny_resnets_match_nkbx(name):
    kw, size = _net_kwargs(name)
    variables = _net_variables(name)
    x = _net_images(4, size)
    jmod = _jax_net(kw)

    @jax.jit
    def both(v, xx):
        return (jmod.apply(v, xx, train=False),
                jmod.apply(v, xx, train=True, mutable=["batch_stats"]))

    want_eval, (want_train, mutated) = both(variables, jnp.asarray(x))
    want_eval = np.asarray(want_eval)
    module = _port_state(name)
    with torch.no_grad():
        got_eval = module.eval()(torch.from_numpy(x))
        got_train = module.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), want_eval, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=1e-4, rtol=0)
    want_sd = from_jax_variables({"params": variables["params"],
                                  "batch_stats": jax.device_get(mutated["batch_stats"])})
    for key, value in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=key)


def test_converter_carries_running_statistics_and_the_s2d_kernel():
    variables = _net_variables("s2d-basic")
    bb, st = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    sd = from_jax_variables(variables)
    k = bb["ConvBN_0"]["Conv_0"]["kernel"]
    assert k.shape == (4, 4, 12, 16) and sd["backbone.ConvBN_0.Conv_0.weight"].shape == (16, 12, 4, 4)
    np.testing.assert_array_equal(sd["backbone.ConvBN_0.Conv_0.weight"].numpy()[3, 5],
                                  k[:, :, 5, 3])
    np.testing.assert_array_equal(sd["backbone.BasicBlock_1.downsample.BatchNorm_0.running_var"],
                                  st["BasicBlock_1"]["downsample"]["BatchNorm_0"]["var"])
    module = _port_state("s2d-basic")
    stats = {k: v for k, v in variables["batch_stats"].items()}
    bad = {"backbone": {**st, "ConvBN_0": {"BatchNorm_0": {"mean": np.zeros(16, np.float32)}}}}
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": variables["params"], "batch_stats": bad}, reference=module)
    assert stats


def test_registry_names_and_construction_rules():
    names = [n for n in list_backbones() if "resne" in n]
    assert len(names) == 16 and "resnet_tiny_test" in names and "seresnext50_32x4d" in names
    model = get_model({"model": "resnet50"}, list("abcdefghij"), input_size=(32, 32),
                      device="cpu", dtype=torch.float32)
    bb = model.module.backbone
    assert model.emb_size == 2048 and bb.Bottleneck_15.ConvBN_2.Conv_0.weight.shape == (2048, 512,
                                                                                         1, 1)
    assert bb.Bottleneck_0.ConvBN_1.Conv_0.weight.std().item() == pytest.approx(
        (9 * 64) ** -0.5, rel=0.1)
    assert bb.ConvBN_0.BatchNorm_0.running_var.eq(1).all()
    with pytest.raises(NotImplementedError, match="A12"):
        tresnet.resnet50(input_norm=((0, 0, 0), (1, 1, 1)))
    with pytest.raises(NotImplementedError, match="A12"):
        tresnet.resnet50(remat_stages=(1,))
    with pytest.raises(ValueError, match="requires ghost_bn"):
        tresnet.resnet50(fused_bottleneck=True)
    with pytest.raises(ValueError, match="Bottleneck blocks only"):
        tresnet.resnet18(ghost_bn=2, fused_bottleneck=True)
    with pytest.raises(ValueError, match="even input"):
        model.module.backbone(torch.zeros(1, 33, 33, 3))


def test_a_resnet_built_directly_is_initialised():
    """Without get_model's reset_parameters every weight still holds drawn
    values: the masked s2d stem's kernel too (lecun-normal, fan-in 4*4*12)."""
    torch.manual_seed(0)
    bb = tresnet.resnet50()
    w = bb.ConvBN_0.Conv_0.weight
    assert torch.isfinite(w).all()
    assert w.std().item() == pytest.approx((16 * 12) ** -0.5, rel=0.1)
    assert all(torch.isfinite(p).all() for p in bb.parameters())


# --- nkbx's tiny fused ResNet ------------------------------------------------------


def test_fused_tiny_resnet_matches_nkbx(monkeypatch):
    """Bottleneck_1 is a stride-1 identity block: its chain runs on both sides
    (nkbx's Pallas kernels in interpret mode; the port's plain chain), with
    th = H = 4 (one band)."""
    kw, size = _net_kwargs("s2d-ghost")
    variables = _net_variables("s2d-ghost")
    x = _net_images(4, size, seed=4)
    jmod = _jax_net(kw, fused=True)

    def jloss(v):
        out, mut = jmod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut)

    (_, (want, mutated)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    module = _port_state("s2d-ghost", fused=True).train()
    calls = []
    real = tresnet.fused_chain

    def spy(*a, **k):
        calls.append((tuple(a[0].shape), k["th"]))
        return real(*a, **k)

    monkeypatch.setattr(tresnet, "fused_chain", spy)
    out = module(torch.from_numpy(x))
    assert calls == [((4, 4, 4, 256), 4)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    (out ** 2).sum().backward()
    want_sd = from_jax_variables({"params": jgrads["params"],
                                  "batch_stats": jax.device_get(mutated["batch_stats"])})
    for name, p in module.named_parameters():
        want = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-7, err_msg=name)
    for key, value in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def test_chain_refuses_a_mask():
    module = _port_state("s2d-ghost", fused=True).train()
    with pytest.raises(ValueError, match="masked|drop_last"):
        module(torch.zeros(4, 16, 16, 3), mask=torch.ones(4, 1, 1, 1, dtype=torch.bool))


# --- the train step against nkbx's ----------------------------------------------------

BATCH, STEPS = 4, 3
# SGD: an update is lr * (g + wd * p), so a gradient element that moves moves its
# parameter in proportion (NAdam's first steps move each element by about lr *
# sign(g), whatever its size)
SGD = {"type": "sgd", "backbone_lr": 1e-2, "classifier_lr": 1e-2,
       "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-4}
LR_FACTORS = [get_scheduler({"type": "cosine", "n_epochs": STEPS})(e) for e in range(STEPS)]
FREEZE_SCALES = [0.0, 1.0, 1.0]
GATE_FLIP = 3e-2  # of a leaf's largest gradient: one relu gate on the other side
LOCKSTEPS = {"ghost-fused": ("s2d-ghost", True, False), "masked-bn": ("tiered-bottleneck", False,
                                                                      True)}


def _batches(masked, size):
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (STEPS, BATCH, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (STEPS, BATCH)).astype(np.int64)
    mask = np.ones(BATCH, bool)
    if masked:
        mask[-1] = False
        images[:, -1] = 0  # the loader's padded row
    return images, labels, mask


@functools.lru_cache(maxsize=None)
def _nkbx_run(case):
    """(losses, state dict after each step) of nkbx's build_train_step."""
    name, fused, masked = LOCKSTEPS[case]
    kw, size = _net_kwargs(name)
    variables = _net_variables(name)
    module = _jax_net(kw, fused)
    model = JModel(module, variables, list("abc"), "single", module.backbone.num_features)
    criterion = jget_loss({"type": "CrossEntropyLoss"})
    bundle = jget_optimizer(variables["params"], SGD)
    pipe = jspec.Compose([jspec.Normalize()])
    step = jbuild_train_step(model, criterion, bundle, augment_fn=pipe.device_apply,
                             masked_bn=masked)
    state = JState.create(variables["params"], variables["batch_stats"], bundle.tx)
    images, labels, mask = _batches(masked, size)
    losses, states = [], []
    for i in range(STEPS):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                              jnp.asarray(mask), jax.random.PRNGKey(0),
                              jnp.asarray(LR_FACTORS[i], jnp.float32),
                              jnp.asarray(FREEZE_SCALES[i], jnp.float32))
        losses.append(float(metrics["loss"]))
        states.append(from_jax_variables(jax.device_get({"params": state.params,
                                                         "batch_stats": state.batch_stats})))
    return losses, states


@pytest.mark.parametrize("case", sorted(LOCKSTEPS))
def test_train_step_lockstep_with_nkbx(case):
    """ghost-fused: ghost_bn=2 with the fused chain on both sides (the port's
    plain chain; nkbx's Pallas kernels in interpret mode), every row valid.
    masked-bn: exact BatchNorm, masked_bn=True, the last row padded. Loss per
    step rtol 1e-4; running statistics 1e-5 + 1e-4 relative; parameters 2e-6 +
    1e-5 relative, plus lr * 3e-2 of the leaf's largest gradient for each step
    taken. A relu whose input lies within f32 noise of 0 may fall on the other
    side in the two programs (these nets have ~4e4 gates a step), which moves
    the gradient of the elements behind it by up to ~10% of the leaf's largest
    and the loss of later steps by ~1e-4: with the batches of seed 7 or 9 one
    gate does so; the batches here (seed 8) have none."""
    name, fused, masked = LOCKSTEPS[case]
    jlosses, jstates = _nkbx_run(case)
    _, size = _net_kwargs(name)
    module = _port_state(name, fused)
    model = ClassificationModel(module, list("abc"), "single", module.backbone.num_features,
                                (size, size), torch.float32, torch.device("cpu"))
    state = TrainState.create(model)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=masked)
    images, labels, mask = _batches(masked, size)
    labels_of = param_labels(model.module)
    slack = dict.fromkeys(labels_of, 0.0)
    for i in range(STEPS):
        state, metrics = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                              torch.from_numpy(mask), LR_FACTORS[i], FREEZE_SCALES[i])
        assert metrics["loss"].item() == pytest.approx(jlosses[i], rel=1e-4)
        params = dict(model.module.named_parameters())
        for key, value in model.module.state_dict().items():
            want = jstates[i][key].numpy()
            if key in params:
                lr = SGD[f"{labels_of[key]}_lr"] * LR_FACTORS[i]
                lr *= FREEZE_SCALES[i] if labels_of[key] == "backbone" else 1.0
                slack[key] += lr * GATE_FLIP * params[key].grad.abs().max().item()
                bound = 2e-6 + 1e-5 * np.abs(want) + slack[key]
            else:
                bound = 1e-5 + 1e-4 * np.abs(want)
            err = np.abs(value.numpy() - want)
            assert (err <= bound).all(), (key, i, float(err.max()), float((err - bound).max()))


def test_masked_bn_option_is_ported_and_the_others_still_raise():
    model = get_model({"model": "resnet_tiny_test"}, list("ab"), input_size=(32, 32),
                      device="cpu", dtype=torch.float32)
    loss, bundle = get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD)
    build_train_step(model, loss, bundle, masked_bn=True)
    # nkbx's other step options are ported too (tests/test_torch_train_options.py);
    # an option nkbx does not have is refused
    assert callable(build_train_step(model, loss, bundle, grad_accum_steps=2))
    with pytest.raises(TypeError):
        build_train_step(model, loss, bundle, ghost_accum=2)


# --- full width --------------------------------------------------------------------


def test_resnet50_ghost_fused_full_width_on_cpu(monkeypatch):
    """resnet50 with ghost_bn=2 and the fused chain at 224 px, batch 2, train
    mode: stages 1-3's identity blocks go through the plain chain (2 + 3 + 5
    blocks, bands 8/7/2 in bf16), and the logits and every gradient are
    finite."""
    model = get_model({"model": "resnet50", "backbone_opts": {"ghost_bn": 2,
                                                              "fused_bottleneck": True}},
                      list("abcdefghij"), device="cpu", dtype=torch.bfloat16)
    bands = []
    real = tresnet.fused_chain

    def spy(*a, **k):
        bands.append(k["th"])
        return real(*a, **k)

    monkeypatch.setattr(tresnet, "fused_chain", spy)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 224, 224, 3))
                         .astype(np.float32)).to(torch.bfloat16)
    module = model.module.train()
    out = module(x)
    assert bands == [8] * 2 + [7] * 3 + [2] * 5
    assert out.shape == (2, 10) and out.dtype == torch.float32 and torch.isfinite(out).all()
    out.float().square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in module.parameters())
