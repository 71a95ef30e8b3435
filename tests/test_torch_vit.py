"""The port's ViT family and its separate-q/k/v attention against nkbx's, on
the CPU.

- The plain K3/K4 (``reference_attention``, ``reference_attention_sep_bwd``
  and the port's ``fused_attention`` entry, whose halves are the plain
  versions on CPU tensors) against nkbx's ``fused_attention(...,
  interpret=True)``, the Pallas kernels ``_fwd_kernel_sep`` and
  ``_bwd_kernel_sep`` in interpret mode, and its ``jax.vjp``: at ViT-B/16's
  N = 197, D = 64 with two groups and two heads, with a (1, N, N) and an (H,
  N, N) bias and a mask of M = 2.
- A tiny ViT (patch 16, dim 128, depth 2, 2 heads of width 64, 64 px: N =
  17 tokens) built on both sides, nkbx's perturbed weights carried across by
  ``from_jax_variables``, the same uint8 batch through both: fused attention
  and MLP off, on (nkbx's fused path in Pallas interpret mode) and auto.
- The converter's flax DenseGeneral layouts and its key and shape checks;
  ``fused_mlp=None`` and ``fused_attention=None`` take the plain versions
  even on a CUDA tensor (nkbx's ViT default), and the mid-MLP dropout turns
  the fused MLP off in training.
- A 3-step train lockstep of the tiny ViT against nkbx's
  ``build_train_step``, as tests/test_torch_train.py does for Swin.

Tolerances, float32: attention forward 1e-5 and backward 1e-4 (the same
math; what is left is the order of sums and nkbx's Newton-refined
reciprocal), dbias 1e-4 of its largest value (a sum over groups); logits 5e-4
(through 2 blocks; nkbx's MLP kernel needs 128 rows, so at 3 x 17 rows it
takes its XLA path on both flags); the lockstep as tests/test_torch_train.py
states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.models.classifier import ClassificationModel as JModel
from nkbx.models.classifier import SingletaskClassifier as JSingle
from nkbx.models.vit import ViT as JViT
from nkbx.ops import attention as jattn
from nkbx.train import TrainState as JState
from nkbx.train import build_train_step as jbuild_train_step
from nkbx.train import get_loss as jget_loss
from nkbx.train import get_optimizer as jget_optimizer
from nkbx.transforms import spec as jspec
from nkbx.transforms.device import build_device_fn as jbuild_device_fn
from nkbx_torch.models import common as tcommon
from nkbx_torch.models import from_jax_variables, get_model, param_labels
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.common import Dense, LayerNorm, mlp_tail
from nkbx_torch.models.vit import ViT
from nkbx_torch.ops import attention as tattn
from nkbx_torch.ops import mlp as tmlp
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer, get_scheduler
from nkbx_torch.transforms import Compose, Normalize
from nkbx_torch.transforms.device import build_device_fn

# --- separate-q/k/v attention ------------------------------------------------------

ATTN_CASES = [
    # (G, N, heads, M, bias heads): ViT-B/16's N, its (1, N, N) zeros-shaped bias
    (2, 197, 2, 1, 1),
    (2, 197, 2, 2, 2),  # a learned (H, N, N) bias and a mask of M = 2
    (4, 50, 2, 2, 1),  # patch 32 at 224 px; the shared bias sums over heads
]
D = 64


def _attn_inputs(g, n, heads, m, bh, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, go = (rng.randn(g, n, heads * D).astype(np.float32) for _ in range(4))
    bias = (rng.randn(bh, n, n) * 0.1).astype(np.float32)
    mask = np.where(rng.rand(m, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask, go


@pytest.mark.parametrize("g,n,heads,m,bh", ATTN_CASES + [(2, 197, 2, None, None)])
def test_attention_matches_pallas_interpret(g, n, heads, m, bh):
    """Forward: the port's entry on CPU tensors (the plain version) against
    nkbx's Pallas kernel; backward: the plain backward and the port's
    autograd Function against jax.vjp of the Pallas kernel. ``m`` and ``bh``
    None: the port gets None for the bias and the mask (the ViT's path), and
    nkbx the constant (1, N, N) zeros its hook passes; no dbias."""
    q, k, v, bias, mask, go = _attn_inputs(g, n, heads, m or 1, bh or 1)
    if bh is None:
        bias, mask = np.zeros_like(bias), np.zeros_like(mask)
    scale = D ** -0.5
    jbias, jmask = jnp.asarray(bias), jnp.asarray(mask)
    leaves_np = (q, k, v, bias) if bh else (q, k, v)
    want, vjp = jax.vjp(lambda a, b, c, d=jbias: jattn.fused_attention(a, b, c, d, jmask, scale,
                                                                       heads, interpret=True),
                        *(jnp.asarray(t) for t in leaves_np))
    wants = vjp(jnp.asarray(go))
    leaves = [torch.from_numpy(t).requires_grad_() for t in leaves_np]
    tbias, tmask = (leaves[3], torch.from_numpy(mask)) if bh else (None, None)
    before = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
    got = tattn.fused_attention(*leaves[:3], tbias, tmask, scale, heads)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(go))
    plain = tattn.reference_attention_sep_bwd(*(torch.from_numpy(t) for t in (q, k, v)),
                                              None if tbias is None else torch.from_numpy(bias),
                                              tmask, torch.from_numpy(go), scale, heads)
    assert (tattn.fused_attention.launches, tattn.fused_attention_bwd.launches) == before
    assert (plain[3] is None) is (bh is None)
    for name, leaf, p, w in zip(("dq", "dk", "dv", "dbias"), leaves, plain, wants):
        w = np.asarray(w)
        atol = 1e-4 * np.abs(w).max() if name == "dbias" else 1e-4
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


def test_attention_bwd_skips_dbias_for_a_constant_bias():
    q, k, v, bias, mask, go = (torch.from_numpy(t) for t in _attn_inputs(2, 17, 2, 1, 1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.fused_attention(*leaves, bias, mask, D ** -0.5, 2).backward(go)
    assert bias.grad is None and all(t.grad is not None for t in leaves)
    out = tattn.fused_attention_bwd(q, k, v, bias, mask, go, D ** -0.5, 2, need_dbias=False)
    assert out[3] is None
    ref = tattn.reference_attention_sep_bwd(q, k, v, bias, mask, go, D ** -0.5, 2)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_takes_none_for_bias_and_mask(dtype):
    """``fused_attention_bwd`` with None for the bias and the mask (what the
    ViT's backward passes): no dbias, even when asked for, and dq, dk, dv
    equal to the call with explicit (1, N, N) zeros."""
    q, k, v, bias, mask, go = (torch.from_numpy(t) for t in _attn_inputs(2, 50, 2, 1, 1, seed=7))
    q, k, v, go = (t.to(dtype) for t in (q, k, v, go))
    zero = torch.zeros_like(bias)
    none = tattn.fused_attention_bwd(q, k, v, None, None, go, D ** -0.5, 2)
    zeros = tattn.fused_attention_bwd(q, k, v, zero, zero, go, D ** -0.5, 2, need_dbias=False)
    assert none[3] is None and zeros[3] is None
    for a, b in zip(none[:3], zeros[:3]):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("mask_given", [False, True])
def test_none_bias_leaves_no_gradient(monkeypatch, mask_given):
    """Through ``_Attention`` a None bias reaches the backward as None, which
    returns no dbias; q, k and v get theirs."""
    q, k, v, _, mask, go = (torch.from_numpy(t) for t in _attn_inputs(2, 17, 2, 1, 1, seed=8))
    mask = mask if mask_given else None
    seen = []

    def recording(*args, **kwargs):
        out = bwd(*args, **kwargs)
        seen.append((args[3], args[4], kwargs.get("need_dbias"), out[3]))
        return out

    bwd = tattn.fused_attention_bwd
    monkeypatch.setattr(tattn, "fused_attention_bwd", recording)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.fused_attention(*leaves, None, mask, D ** -0.5, 2).backward(go)
    assert len(seen) == 1
    bias_seen, mask_seen, need_dbias, dbias = seen[0]
    assert bias_seen is None and dbias is None and need_dbias is False
    assert mask_seen is mask
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


def test_packed_backward_is_the_shared_core():
    """The packed entry's plain backward and the separate one agree exactly
    on the same q, k, v (one core, factored)."""
    q, k, v, bias, mask, go = (torch.from_numpy(t) for t in _attn_inputs(4, 9, 2, 2, 2, seed=3))
    dqkv, dbias = tattn.reference_attention_bwd(torch.cat([q, k, v], -1), bias, mask, go,
                                                0.3, 2)
    dq, dk, dv, dbias_sep = tattn.reference_attention_sep_bwd(q, k, v, bias, mask, go, 0.3, 2)
    assert torch.equal(dqkv, torch.cat([dq, dk, dv], -1)) and torch.equal(dbias, dbias_sep)


@pytest.mark.parametrize("n,fits", [(50, True), (145, True), (197, True), (577, True),
                                    (2000, False)])
def test_smem_gate_takes_every_vit_sequence(n, fits):
    """The bf16 forward streams keys, so it takes any N; the f32 forward
    (score rows in shared memory) and the backward hold rows of N."""
    assert tattn.sep_smem_bytes(n, 2) <= tattn._MAX_SMEM
    assert (tattn.sep_smem_bytes(n, 4) <= tattn._MAX_SMEM) is fits
    for itemsize in (2, 4):
        assert (tattn.sep_bwd_smem_bytes(n, itemsize) <= tattn._MAX_SMEM) is fits


def test_bf16_forward_smem_does_not_grow_with_n():
    """The streaming forward's shared memory is its 4 (64, 72) key/value
    tiles and 8 warps' (16, 68) f32 bias and mask staging rows, which cover
    its (128, 72) q tile, at every N; the backward's gate still refuses what
    K4 cannot hold."""
    sizes = {tattn.sep_smem_bytes(n, 2) for n in (1, 17, 64, 65, 197, 577, 2000, 10_000)}
    assert sizes == {4 * 64 * 72 * 2 + 8 * 2 * 16 * 68 * 4}
    q = torch.zeros(1, 2000, D, dtype=torch.bfloat16)
    tattn._check_sep(q, q, q, None, None, 1, tattn.sep_smem_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        tattn._check_sep(q, q, q, None, None, 1, tattn.sep_bwd_smem_bytes)


def test_bf16_backward_smem_without_bias_or_mask_does_not_grow_with_n():
    """K4's tensor-core pair (bf16, None for the bias and the mask) streams
    both q and keys: its shared memory is the cols kernel's k and v tiles
    and 3 ring slots of q and go tiles and 64 rows of three statistics at
    every N, so its gate takes any N; f32 and a given bias keep the first
    design's gate."""
    tile = 64 * 72 * 2
    sizes = {tattn.sep_bwd_smem_bytes(n, 2, streaming=True) for n in (1, 65, 197, 577, 10_000)}
    assert sizes == {2 * tile + 3 * (2 * tile + 3 * 64 * 4)}
    assert sizes.pop() <= tattn._MAX_SMEM
    assert tattn.sep_bwd_smem_bytes(2000, 2) > tattn._MAX_SMEM


@pytest.mark.parametrize("dtype,atol", [(np.float32, 5e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("none_bias,none_mask", [(True, True), (True, False), (False, True)])
def test_absent_bias_or_mask_matches_nkbx_zeros(dtype, atol, none_bias, none_mask):
    """``None`` for the bias or the mask (what the ViT passes) against
    nkbx's Pallas kernel (interpret mode) given zeros in its place: the
    plain version and the entry on CPU tensors, f32 and bf16."""
    g, n, heads, m = 2, 197, 2, 2
    q, k, v, bias, mask, _ = _attn_inputs(g, n, heads, m, heads, seed=4)
    if none_bias:
        bias = np.zeros((1, n, n), np.float32)
    if none_mask:
        mask = np.zeros((1, n, n), np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    scale = D ** -0.5
    want = np.asarray(jattn.fused_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                                            jnp.asarray(bias), jnp.asarray(mask), scale, heads,
                                            interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    tb = None if none_bias else torch.from_numpy(bias)
    tm = None if none_mask else torch.from_numpy(mask)
    for fn in (tattn.reference_attention, tattn.fused_attention):
        got = fn(tq, tk, tv, tb, tm, scale, heads)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0,
                                   err_msg=fn.__name__)


def test_absent_bias_and_mask_train_like_zeros():
    """The autograd entry with None: its gradients equal those with (1, N, N)
    zeros (the backward passes None on, and the plain version adds
    nothing)."""
    q, k, v, _, _, go = (torch.from_numpy(t) for t in _attn_inputs(2, 50, 2, 1, 1, seed=6))
    zero = torch.zeros(1, 50, 50)
    grads = []
    for bias, mask in ((None, None), (zero, zero)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.fused_attention(*leaves, bias, mask, D ** -0.5, 2)
        out.backward(go)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --- the tiny ViT against nkbx's ---------------------------------------------------

TINY = dict(patch_size=16, dim=128, depth=2, n_heads=2)
SIZE = 64


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _perturbed(variables, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        jax.device_get(variables))


@functools.lru_cache(maxsize=None)
def _jax_side(fused):
    """(variables, predict) of nkbx's classifier, params perturbed."""
    backbone = JViT(dtype=jnp.float32, fused_attention=fused, fused_mlp=fused, **TINY)
    module = JSingle(backbone=backbone, n_classes=3)
    variables = _perturbed(module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                       train=False))
    norm = jbuild_device_fn([jspec.Normalize()])

    def predict(images):
        x = norm(jnp.asarray(images), jax.random.PRNGKey(0), False)
        return np.asarray(jax.device_get(module.apply(variables, x, train=False)))

    return variables, predict


def _port(fused):
    backbone = ViT(dtype=torch.float32, img_size=(SIZE, SIZE), fused_attention=fused,
                   fused_mlp=fused, **TINY)
    module = SingletaskClassifier(backbone, 3)
    variables, _ = _jax_side(fused)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    return module.eval()


def test_fused_vit_passes_no_bias_or_mask(monkeypatch):
    """The ViT's fused path hands the kernel None for nkbx's zero bias and
    mask (so the kernel reads neither), and its f32 logits match nkbx's
    fused ViT within 5e-4."""
    from nkbx_torch.models import vit as tvit

    seen = []

    def recording(q, k, v, bias, mask, scale, heads):
        seen.append((bias, mask))
        return tattn.fused_attention(q, k, v, bias, mask, scale, heads)

    monkeypatch.setattr(tvit, "fused_attention", recording)
    _, predict = _jax_side(True)
    module = _port(True)
    images = _images(2, seed=5)
    with torch.inference_mode():
        got = module(build_device_fn([Normalize()])(torch.from_numpy(images)))
    assert seen == [(None, None)] * TINY["depth"]
    np.testing.assert_allclose(got.numpy(), predict(images), atol=5e-4, rtol=0)


@pytest.mark.parametrize("fused", [False, True, None])
def test_logits_match_nkbx(fused):
    """fused=True takes the kernels' entries, which on CPU tensors compute
    the plain versions; nkbx's fused path runs Pallas in interpret mode.
    None is the family's default, the plain versions on both sides."""
    _, predict = _jax_side(fused)
    module = _port(fused)
    images = _images(3)
    with torch.inference_mode():
        got = module(build_device_fn([Normalize()])(torch.from_numpy(images)))
    np.testing.assert_allclose(got.numpy(), predict(images), atol=5e-4, rtol=0)


def test_converter_layouts_and_checks():
    variables, _ = _jax_side(False)
    params = variables["params"]["backbone"]["TransformerBlock_0"][
        "MultiHeadDotProductAttention_0"]
    sd = from_jax_variables(variables)
    pre = "backbone.TransformerBlock_0.MultiHeadDotProductAttention_0."
    np.testing.assert_array_equal(sd[pre + "query.weight"].numpy(),
                                  params["query"]["kernel"].reshape(128, 128).T)
    np.testing.assert_array_equal(sd[pre + "out.weight"].numpy(),
                                  params["out"]["kernel"].reshape(128, 128).T)
    np.testing.assert_array_equal(sd[pre + "key.bias"].numpy(),
                                  params["key"]["bias"].reshape(-1))
    assert sd["backbone.pos_embed"].shape == (1, 17, 128)
    assert sd["backbone.cls_token"].shape == (1, 1, 128)
    module = _port(False)
    tree = dict(variables["params"])
    tree["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="leftover"):
        from_jax_variables({"params": tree}, reference=module)
    backbone = dict(variables["params"]["backbone"])
    del backbone["cls_token"]
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": {**variables["params"], "backbone": backbone}},
                           reference=module)
    wide = SingletaskClassifier(ViT(dtype=torch.float32, img_size=(96, 96), **TINY), 3)
    with pytest.raises(ValueError, match="pos_embed"):
        from_jax_variables(variables, reference=wide)


class _CudaLike:
    """What the gates read of a tensor on the card."""
    is_cuda = True
    shape = (1, 128)
    dtype = torch.bfloat16


def test_vit_defaults_take_the_plain_versions(monkeypatch):
    """nkbx's ViT default (auto False): fused_attention=None and
    fused_mlp=None take the plain versions even on the card; an explicit
    True and the env override take the kernels."""
    for k in ("NKBX_FUSED_ATTENTION", "NKBX_FUSED_MLP", "NKBX_FUSED_LN_MLP"):
        monkeypatch.delenv(k, raising=False)
    t = _CudaLike()
    assert tattn.resolve_fused(None, t, auto=False) is False
    assert tattn.resolve_fused(None, t) is True  # Swin's default
    assert tattn.resolve_fused(True, t, auto=False) is True
    assert tmlp.fused_mlp_mode(None, t, 512, auto=False) is None
    assert tmlp.fused_mlp_mode(None, t, 512) == "ln"
    assert tmlp.fused_mlp_mode(True, t, 512, auto=False) == "ln"
    monkeypatch.setenv("NKBX_FUSED_MLP", "1")
    assert tmlp.fused_mlp_mode(None, t, 512, auto=False) == "ln"


def test_vit_block_passes_its_default_to_the_gates(monkeypatch):
    calls = []
    real_mode = tcommon.fused_mlp_mode

    def spy(flag, x, f, auto=True):
        calls.append((flag, auto))
        return real_mode(flag, x, f, auto)

    monkeypatch.setattr(tcommon, "fused_mlp_mode", spy)
    module = _port(None)
    with torch.inference_mode():
        module(torch.zeros(1, SIZE, SIZE, 3))
    assert calls == [(None, False)] * TINY["depth"]


def test_mid_mlp_dropout_turns_the_fused_mlp_off(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the fused LN-MLP ran with dropout active")

    monkeypatch.setattr(tcommon, "fused_ln_mlp", boom)
    torch.manual_seed(0)
    norm, fc1, fc2 = LayerNorm(16, 1e-6), Dense(16, 64), Dense(64, 16)
    x = torch.randn(5, 16)
    a = mlp_tail(x, x, norm, fc1, fc2, flag=True, drop_rate=0.5, train=True)
    b = mlp_tail(x, x, norm, fc1, fc2, flag=True, drop_rate=0.5, train=True)
    assert not torch.equal(a, b)  # a fresh dropout mask each call
    with pytest.raises(AssertionError, match="dropout active"):
        mlp_tail(x, x, norm, fc1, fc2, flag=True, drop_rate=0.5, train=False)


def test_registry_names_and_unicom():
    from nkbx_torch.models import create_backbone, list_backbones

    names = list_backbones()
    assert sum(n.startswith(("vit_", "deit_")) for n in names) == 16
    model = get_model({"model": "vit_small_patch32_384"}, list("ab"), input_size=(384, 384),
                      device="cpu", dtype=torch.float32)
    assert model.module.backbone.pos_embed.shape == (1, 145, 384) and model.emb_size == 384
    with torch.device("meta"):
        unicom = create_backbone("unicom ViT-B/32", dtype=torch.float32)
    assert unicom.num_features == 512 and unicom.pos_embed.shape == (1, 49, 768)
    assert not hasattr(unicom, "cls_token")


# --- the train step against nkbx's -------------------------------------------------

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
    """(initial variables, grads of step 1, losses, params after each step)."""
    module = JSingle(backbone=JViT(dtype=jnp.float32, fused_attention=False, fused_mlp=False,
                                   **TINY), n_classes=3)
    variables = _perturbed(module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                       train=False))
    model = JModel(module, variables, list("abc"), "single", 128)
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


@pytest.mark.parametrize("fused", [None, True])
def test_train_step_lockstep_with_nkbx(fused):
    """fused=None is autograd through the plain forward; True goes through
    the kernels' autograd Functions (their plain halves on the CPU). The
    tolerances are tests/test_torch_train.py's: loss per step rtol 1e-4;
    step-1 grads 1e-4 of each leaf's largest value; params after each step
    2e-6 + 1e-5 relative, plus 2 * lr of a step wherever a gradient is under
    1e-4 of its leaf's largest (NAdam's first steps move such an element by
    about lr * sign(g)). The key Dense's bias gets no gradient in exact
    arithmetic (it shifts a whole score row, and softmax ignores a shift):
    both sides give rounding noise under 1e-7 there, which NOISE bounds and
    which counts as unresolved."""
    variables, jgrads, jlosses_, jparams = _nkbx_run()
    backbone = ViT(dtype=torch.float32, img_size=(SIZE, SIZE), fused_attention=fused,
                   fused_mlp=fused, **TINY)
    module = SingletaskClassifier(backbone, 3)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    model = ClassificationModel(module.eval(), list("abc"), "single", backbone.num_features,
                                (SIZE, SIZE), torch.float32, torch.device("cpu"))
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
