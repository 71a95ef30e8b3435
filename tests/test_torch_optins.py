"""nkbx's max-throughput opt-ins in the port (``remat_stages``,
``input_norm``, ``bf16_master_weights``) against the runs without them and
against nkbx, on the CPU.

- ``remat_stages``: a train-mode forward and backward of a tiny ResNet
  (ghost BN with the fused chain, its plain version here) and a tiny
  ConvNeXt (fused MLP on, its plain version here) with every stage under
  remat gives the logits, the gradients and the BatchNorm running
  statistics of the run without it, bit for bit (f32): the replay updates
  no running statistics. Against nkbx's own remat models (nkbx's tiny
  tiered-bottleneck ResNet with exact BN, its tiny ConvNeXt with the plain
  MLP): logits 1e-4, gradients 1e-4 of the leaf's largest plus 1e-4
  relative, running statistics 1e-5 + 1e-4 relative. Parameter names do not
  change, so a checkpoint loads across the settings.
- ``input_norm=(mean, std)``: the s2d stem folds Normalize; logits on the
  raw [0, 255] batch equal nkbx's folded model's (f32, 5e-4) and the port's
  unfolded model's on the Normalize'd batch (5e-4), at 32 and 48 px;
  without the s2d stem it raises nkbx's ValueError.
- ``bf16_master_weights``: 3 steps of nkbx's ``build_train_step`` with
  ``TrainState.create(master_dtype=bfloat16)`` against the port's
  ``TrainState.create(master_dtype=torch.bfloat16)``, adam with coupled wd,
  EMA 0.9, ``masked_bn=True``, the lr factor and freeze scale passed to
  nkbx as f32 arrays, as nkbx's trainer passes them (engine.py:648-649).
  Parameters, the port's moments and the EMA shadow are bf16, running
  statistics f32. Two differences remain (ROADMAP.md section C): the f32
  freeze scale turns nkbx's backbone gradients, and so its backbone
  moments, f32; and nkbx's compiled step takes Adam's last division
  unrounded into its f32 step, where the port rounds the ratio to bf16.
  Both then add ``-lr * u`` to the bf16 parameter in f32 and round once.
  The bound: loss per step rtol 1e-3 (1.8e-4 seen on the CPU); at most 5% of the
  bf16 elements of the weights, and of the shadow, differ at all (3.8%
  and 0.7% seen after step 3), each by at most 2 Adam steps of its group
  (2·lr·lr_factor summed over the steps) plus one bf16 ulp of nkbx's value
  (the sum rounded the other way); running statistics 1e-4 + 1e-3
  relative (the activations move with the weights that differ).
- A checkpoint of a bf16-master state saves and restores bf16 (moments and
  shadow too), and the trainer's ``bf16_master_weights = True`` trains a
  CPU epoch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models import resnet as jresnet
from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.convnext import ConvNeXt as JConvNeXt
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx_torch.models import from_jax_variables
from nkbx_torch.models import resnet as tresnet
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.convnext import ConvNeXt
from nkbx_torch.ops import bottleneck as tbn
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
from nkbx_torch.train.checkpoint import restore_train_state, save_checkpoint
from nkbx_torch.transforms import Compose, Normalize
from nkbx_torch.transforms.device import build_device_fn

RESNET = dict(stage_sizes=(1, 1), block_cls="Bottleneck", stem="tiered", stem_width=16)
GHOST = dict(stage_sizes=(2,), block_cls="Bottleneck", stem_width=8, ghost_bn=2)
CONVNEXT = dict(depths=(1, 1), dims=(16, 32))
MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def _perturbed(variables, seed=1):
    rng = np.random.default_rng(seed)

    def perturb(path, p):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return (np.asarray(p) * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        if key.endswith("['layer_scale']"):
            return rng.uniform(0.1, 1.0, p.shape).astype(np.float32)
        return (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _jax_backbone(family, **opts):
    if family == "convnext":
        return JConvNeXt(dtype=jnp.float32, fused_mlp=False, **CONVNEXT, **opts)
    kw = dict(RESNET if family == "resnet" else GHOST, **opts)
    return jresnet.ResNet(dtype=jnp.float32, **dict(kw, block_cls=getattr(jresnet,
                                                                          kw["block_cls"])))


def _port_backbone(family, **opts):
    if family == "convnext":
        return ConvNeXt(dtype=torch.float32, fused_mlp=True, **CONVNEXT, **opts)
    kw = dict(RESNET if family == "resnet" else GHOST, **opts)
    if family == "ghost":
        kw["fused_bottleneck"] = True
    return tresnet.ResNet(dtype=torch.float32, **dict(kw, block_cls=getattr(tresnet,
                                                                            kw["block_cls"])))


SIZES = {"resnet": 32, "ghost": 16, "convnext": 64}


@functools.lru_cache(maxsize=None)
def _variables(family, **opts):
    size = SIZES[family]
    module = JSingle(backbone=_jax_backbone(family, **opts), n_classes=3)
    return _perturbed(jax.device_get(jax.jit(lambda x: module.init(
        jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, size, size, 3)))))


def _port(family, **opts):
    module = SingletaskClassifier(_port_backbone(family, **opts), 3)
    module.load_state_dict(from_jax_variables(_variables(family), reference=module))
    return module


def _images(family, n=4, seed=0):
    s = SIZES[family]
    return np.random.default_rng(seed).normal(size=(n, s, s, 3)).astype(np.float32)


def _train_pass(module, x):
    """Logits, gradients of sum(logits²) and buffers after one train pass."""
    module.train()
    out = module(torch.from_numpy(x))
    out.square().sum().backward()
    return (out.detach(), {n: p.grad.clone() for n, p in module.named_parameters()},
            {n: b.clone() for n, b in module.named_buffers()})


REMAT = {"ghost": (0,), "resnet": (0, 1), "convnext": (0, 1)}


@pytest.mark.parametrize("family", sorted(REMAT))
def test_remat_changes_no_numbers(family):
    x = _images(family)
    plain = _port(family)
    remat = _port(family, remat_stages=REMAT[family])
    assert list(plain.state_dict()) == list(remat.state_dict())
    if family == "ghost":  # the chain runs in the remat stage
        assert remat.backbone.Bottleneck_1.train().chain_band(
            torch.zeros(4, 4, 4, 256)) is not None
    want, got = _train_pass(plain, x), _train_pass(remat, x)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in b)
    moved = [k for k in want[2] if k.endswith("running_mean") and want[2][k].abs().sum() > 0]
    assert moved or family == "convnext"


def test_remat_recomputes_the_blocks_once_more(monkeypatch):
    calls = []
    real = tbn.reference_chain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tbn, "reference_chain", spy)
    for stages, n in (((), 1), ((0,), 2)):
        calls.clear()
        _train_pass(_port("ghost", remat_stages=stages), _images("ghost"))
        assert len(calls) == n
    with torch.no_grad():  # no gradients: remat just runs the block
        calls.clear()
        _port("ghost", remat_stages=(0,)).train()(torch.from_numpy(_images("ghost")))
        assert len(calls) == 1


def _grads_tree_to_port(grads):
    return from_jax_variables({"params": jax.device_get(grads)})


@pytest.mark.parametrize("family", ["resnet", "convnext"])
def test_remat_matches_nkbx_remat(family):
    stages = REMAT[family]
    module = JSingle(backbone=_jax_backbone(family, remat_stages=stages), n_classes=3)
    variables = _variables(family)
    x = _images(family)

    def loss(params):
        out, mutated = module.apply({"params": params,
                                     "batch_stats": variables.get("batch_stats", {})},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mutated)

    (_, (want_out, mutated)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    out, got_grads, buffers = _train_pass(_port(family, remat_stages=stages), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4, rtol=0)
    want_grads = _grads_tree_to_port(grads)
    for k, g in got_grads.items():
        w = want_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    if family == "resnet":
        stats = from_jax_variables({"params": {}, "batch_stats": jax.device_get(
            mutated["batch_stats"])})
        for k, w in stats.items():
            np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


# --- input_norm -----------------------------------------------------------------------

NORM_NET = dict(stage_sizes=(1, 1), block_cls="BasicBlock", stem_width=16)


@functools.lru_cache(maxsize=None)
def _norm_variables():
    module = JSingle(backbone=jresnet.ResNet(dtype=jnp.float32, block_cls=jresnet.BasicBlock,
                                             **{k: v for k, v in NORM_NET.items()
                                                if k != "block_cls"}), n_classes=3)
    return _perturbed(jax.device_get(module.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 32, 32, 3)), train=False)))


def _norm_port(input_norm):
    module = SingletaskClassifier(tresnet.ResNet(
        dtype=torch.float32, block_cls=tresnet.BasicBlock, input_norm=input_norm,
        **{k: v for k, v in NORM_NET.items() if k != "block_cls"}), 3)
    module.load_state_dict(from_jax_variables(_norm_variables(), reference=module))
    return module.eval()


@pytest.mark.parametrize("size", [32, 48])
def test_input_norm_matches_nkbx_and_the_unfolded_model(size):
    raw = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    jmod = JSingle(backbone=jresnet.ResNet(dtype=jnp.float32, block_cls=jresnet.BasicBlock,
                                           input_norm=(MEAN, STD),
                                           **{k: v for k, v in NORM_NET.items()
                                              if k != "block_cls"}), n_classes=3)
    want = np.asarray(jmod.apply(_norm_variables(), jnp.asarray(raw, jnp.float32), train=False))
    with torch.no_grad():
        folded = _norm_port((MEAN, STD))(torch.from_numpy(raw).float()).numpy()
        normalized = build_device_fn([Normalize()])(torch.from_numpy(raw), torch.float32)
        unfolded = _norm_port(None)(normalized).numpy()
    np.testing.assert_allclose(folded, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(folded, unfolded, atol=5e-4, rtol=0)


def test_input_norm_needs_the_s2d_stem():
    for kw in ({"s2d_stem": False}, {"stem": "tiered"}):
        with pytest.raises(ValueError, match="requires the s2d stem"):
            tresnet.resnet50(input_norm=(MEAN, STD), **kw)
    assert tresnet.resnet50(input_norm=(MEAN, STD)).ConvBN_0.Conv_0.norm_inv.shape == (12,)


# --- bf16 master weights -----------------------------------------------------------------

ADAM = {"type": "adam", "backbone_lr": 1e-3, "classifier_lr": 1e-2,
        "backbone_weight_decay": 1e-4, "classifier_weight_decay": 1e-3}
LR_FACTORS, FREEZE = [1.0, 0.75, 0.25], [0.0, 1.0, 1.0]
CE = {"type": "CrossEntropyLoss"}


def _batches(steps=3, b=4, size=32):
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (steps, b, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (steps, b)).astype(np.int64)
    mask = np.ones((steps, b), bool)
    mask[:, -1] = False
    images[:, -1] = 0
    return images, labels, mask


def _bf16_port_model():
    module = _port("resnet")
    return ClassificationModel(module.eval(), list("abc"), "single", 256, (32, 32),
                               torch.float32, torch.device("cpu"))


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def test_bf16_master_weights_lockstep_with_nkbx():
    variables = _variables("resnet")
    jmodel = JModel(JSingle(backbone=_jax_backbone("resnet"), n_classes=3), variables,
                    list("abc"), "single", 256)
    bundle = jget_optimizer(variables["params"], ADAM)
    jstep = jbuild_train_step(jmodel, jget_loss(CE), bundle,
                              augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                              masked_bn=True, ema_decay=0.9)
    jstate = JState.create(variables["params"], variables["batch_stats"], bundle.tx, ema=True,
                           master_dtype=jnp.bfloat16)
    model = _bf16_port_model()
    state = TrainState.create(model, ema=True, master_dtype=torch.bfloat16)
    step = build_train_step(model, get_loss(CE), get_optimizer(ADAM),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=True,
                            ema_decay=0.9)
    images, labels, mask = _batches()
    module = model.module
    labels_of = {n: "backbone" if n.startswith("backbone") else "classifier"
                 for n, _ in module.named_parameters()}
    moved = dict.fromkeys(labels_of, 0.0)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                           jnp.asarray(mask[i]), jax.random.PRNGKey(0),
                           jnp.asarray(LR_FACTORS[i], jnp.float32),
                           jnp.asarray(FREEZE[i], jnp.float32))
        state, m = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                        torch.from_numpy(mask[i]), LR_FACTORS[i], FREEZE[i])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        for n, g in labels_of.items():
            moved[n] += 2 * ADAM[f"{g}_lr"] * LR_FACTORS[i] * (FREEZE[i] if g == "backbone"
                                                                 else 1.0)
        for shadow, (params, stats) in ((module, (jstate.params, jstate.batch_stats)),
                                        (state.ema_module, (jstate.ema_params,
                                                            jstate.ema_batch_stats))):
            want = from_jax_variables({"params": _f32(params), "batch_stats": _f32(stats)})
            n_off = n_all = 0
            for k, v in shadow.state_dict().items():
                w, g = want[k].numpy(), v.float().numpy()
                if k.endswith(("running_mean", "running_var")):
                    assert v.dtype == torch.float32
                    np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4, err_msg=k)
                    continue
                assert v.dtype == torch.bfloat16, k
                err = np.abs(g - w)
                ulp = np.spacing(np.abs(w).astype(jnp.bfloat16)).astype(np.float32)
                assert np.all(err <= moved[k] + ulp), (i, k, err.max())
                n_off, n_all = n_off + int((err > 0).sum()), n_all + err.size
            assert n_off <= 0.05 * n_all, (i, n_off, n_all)
    assert all(t.dtype == torch.bfloat16 for st in state.opt_state.values()
               for t in st.mu + st.nu)
    assert {a.dtype for a in jax.tree_util.tree_leaves(jstate.params)} == {jnp.dtype("bfloat16")}


def test_bf16_checkpoint_round_trip(tmp_path):
    model = _bf16_port_model()
    state = TrainState.create(model, ema=True, master_dtype=torch.bfloat16)
    step = build_train_step(model, get_loss(CE), get_optimizer(ADAM),
                            augment_fn=Compose([Normalize()]).device_apply, ema_decay=0.9)
    images, labels, mask = _batches(steps=1)
    state, _ = step(state, *(torch.from_numpy(a[0]) for a in (images, labels, mask)), 1.0, 1.0)
    save_checkpoint(tmp_path / "last", state, epoch=2, best_val_acc=0.5)
    other = _bf16_port_model()
    fresh = TrainState.create(other, ema=True, master_dtype=torch.bfloat16)
    fresh, epoch, best = restore_train_state(tmp_path / "last", fresh)
    assert (epoch, best, fresh.step) == (2, 0.5, 1)
    for a, b in ((model.module, other.module), (state.ema_module, fresh.ema_module)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
            assert sa[k].dtype == (torch.float32 if "running" in k else torch.bfloat16), k
    for label, st in state.opt_state.items():
        for x, y in zip(st.mu + st.nu, fresh.opt_state[label].mu + fresh.opt_state[label].nu):
            assert y.dtype == torch.bfloat16 and torch.equal(x, y)
    payload = torch.load(tmp_path / "last" / "train_state.pt", weights_only=True)
    assert payload["module"]["head.weight"].dtype == torch.bfloat16


def test_trainer_cli_runs_the_three_opt_ins(tmp_path):
    """``bf16_master_weights = True`` and ``backbone_opts`` with
    ``remat_stages`` and ``input_norm`` (no Normalize in the pipelines, as
    nkbx's recipe drops it) train a CPU epoch; the saved state is bf16."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    from nkbx_torch.logging.experiment import write_png

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(2):
            d = tmp_path / "data" / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(4):
                write_png(d / f"{i}.png", rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    run = tmp_path / "run"
    config = tmp_path / "config.py"
    config.write_text(textwrap.dedent(f"""
        import nkbx.transforms as T

        task = "single"
        n_epochs = 1
        enable_mixed_precision = False
        bf16_master_weights = True
        train_data = {{"type": "ImageFolder", "root": "{tmp_path / 'data' / 'train'}",
                      "batch_size": 4, "shuffle": True, "num_workers": 0, "drop_last": True}}
        val_data = {{"type": "ImageFolder", "root": "{tmp_path / 'data' / 'val'}",
                    "batch_size": 4}}
        train_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32),
                                    T.HorizontalFlip()])
        val_pipeline = T.Compose([T.LongestMaxSize(32), T.PadIfNeeded(32, 32)])
        model = {{"task": "single", "model": "resnet_tiny_test",
                  "backbone_opts": {{"remat_stages": (0, 1),
                                    "input_norm": ({MEAN.tolist()}, {STD.tolist()})}}}}
        optimizer = {{"type": "adam", "backbone_lr": 1e-3, "classifier_lr": 1e-3}}
        lr_policy = {{"type": "cosine", "n_epochs": 1}}
        criterion = {{"task": "single", "type": "CrossEntropyLoss"}}
        experiment = {{"comet": None, "local": {{"path": "{run}"}}}}
    """))
    r = subprocess.run([sys.executable, "-m", "nkbx_torch.train", "-cfg", str(config),
                        "--device", "cpu"], cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:{r.stdout[-1500:]}\nSTDERR:{r.stderr[-2500:]}"
    payload = torch.load(run / "weights" / "last" / "train_state.pt", weights_only=True)
    sd = payload["module"]
    assert sd["head.weight"].dtype == torch.bfloat16
    assert sd["backbone.ConvBN_0.BatchNorm_0.running_mean"].dtype == torch.float32
    assert payload["opt_state"]["backbone"]["mu"][0].dtype == torch.bfloat16
    best = torch.load(run / "weights" / "best.pt", weights_only=True)
    assert best["backbone.ConvBN_0.Conv_0.weight"].dtype == torch.bfloat16
