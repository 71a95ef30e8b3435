"""The port's dropout masks come from the train state's generator, on the
CPU.

- Every dropout of the port (the classifier's, each backbone family's
  embedding or head dropout, the ViTs' attention mask and mid-MLP dropout)
  is a :class:`~nkbx_torch.models.common.Dropout` or goes through
  :func:`~nkbx_torch.models.common.keep_mask`, and no model source draws a
  mask any other way.
- In a train step every mask is drawn from ``state.generator``: two runs
  of 2 steps of a tiny net of each family, with ``classifier_dropout`` and
  the backbone's ``drop_rate`` at 0.1, from one state seed, are bit-equal
  however torch's global generator was seeded; another state seed gives
  other losses (the masks are active).
- torch's dropout arithmetic: at p = 0.1 over 10^6 draws the kept share is
  within 0.5% of 0.9 and every kept value is x times f32(1/0.9) exactly;
  outside a train step the port's Dropout draws what ``torch.nn.Dropout``
  draws from torch's global generator; eval mode is the identity.
- A ``scan_steps=2`` call equals two single calls bit for bit, with flips
  and dropout drawn from one generator; ``remat_stages`` with dropout is
  bit-equal to the step without it, and a mask drawn inside a remat'd
  region is drawn again the same in the replay, which leaves the
  generator where the forward left it.

The runs of the trainer (one seed, one process and two fresh processes;
preempted and resumed) are in tests/test_torch_trainer.py, a world of 2
against a world of 1 in tests/test_torch_dist.py.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from nkbx_torch.models import convnext as C
from nkbx_torch.models import densenet as D
from nkbx_torch.models import efficientnet as E
from nkbx_torch.models import mobilenetv3 as M
from nkbx_torch.models import resnet as R
from nkbx_torch.models import swin as S
from nkbx_torch.models import vit as V
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.common import Dropout, dropout, dropout_source, remat
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
from nkbx_torch.transforms import Compose, HorizontalFlip, Normalize

ROOT = Path(__file__).resolve().parents[1]
P = 0.1
SIZE, BATCH, STEPS = 32, 4, 2
SGD = {"type": "sgd", "backbone_lr": 0.05, "classifier_lr": 0.05}
MNV3_SPEC = ((3, 16, 16, True, "re", 2), (3, 16, 16, False, "re", 1),
             (3, 48, 24, False, "hs", 2), (5, 72, 24, True, "hs", 1))
V2_SPEC = (("fused", 1, 3, 1, 1, 8, 0.0), ("fused", 4, 3, 2, 2, 16, 0.0),
           ("mb", 4, 3, 2, 2, 24, 0.25))
IMG = (SIZE, SIZE)
# a tiny backbone of each family with its dropout at P
FAMILIES = {
    "resnet": lambda **kw: R.resnet_tiny_test(drop_rate=P, img_size=IMG, **kw),
    "vit": lambda: V.ViT(patch_size=8, dim=32, depth=2, n_heads=2, drop_rate=P, img_size=IMG),
    "unicom": lambda: V.UnicomViT(patch_size=8, dim=32, depth=1, n_heads=2, embedding_size=16,
                                  drop_rate=P, img_size=IMG),
    "swin": lambda: S.SwinTransformer(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2,
                                      drop_rate=P, img_size=IMG),
    "convnext": lambda: C.ConvNeXt(depths=(1, 1), dims=(16, 32), drop_rate=P, img_size=IMG),
    "densenet": lambda: D.DenseNet(block_config=(1, 2), growth_rate=8, init_features=16,
                                   drop_rate=P, img_size=IMG),
    "mobilenetv3": lambda: M.MobileNetV3(spec=MNV3_SPEC, width_mult=0.75, last_conv=96,
                                         head_features=40, drop_rate=P, img_size=IMG),
    "efficientnet": lambda: E.EfficientNet(width_mult=0.25, depth_mult=0.25, drop_rate=P,
                                           img_size=IMG),
    "efficientnetv2": lambda: E.EfficientNetV2(spec=V2_SPEC, stem_width=8, drop_rate=P,
                                               img_size=IMG),
}


def _module(family, **kw):
    torch.manual_seed(0)
    return SingletaskClassifier(FAMILIES[family](**kw), 3, classifier_dropout=P)


def _model(module):
    return ClassificationModel(module, list("abc"), "single", module.backbone.num_features, IMG,
                               torch.float32, torch.device("cpu"))


def _batches(steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (steps, BATCH, SIZE, SIZE, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 3, (steps, BATCH))),
            torch.ones(steps, BATCH, dtype=torch.bool))


def _steps(module, state_seed=0, torch_seed=0, scan=1, flips=False):
    """(losses, state dict) after STEPS sgd steps of ``module`` (a copy),
    torch's global generator seeded ``torch_seed`` first."""
    module = copy.deepcopy(module)
    model = _model(module)
    state = TrainState.create(model, seed=state_seed)
    pipe = Compose(([HorizontalFlip(p=0.5)] if flips else []) + [Normalize()])
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=pipe.device_apply, scan_steps=scan)
    images, labels, masks = _batches()
    torch.manual_seed(torch_seed)
    losses = []
    for i in range(0, STEPS, scan):
        cut = slice(i, i + scan) if scan > 1 else i
        state, m = step(state, images[cut], labels[cut], masks[cut], 1.0, 1.0)
        losses.extend(np.ravel(m["loss"].numpy()).tolist())
    return losses, {k: v.clone() for k, v in module.state_dict().items()}, state


def _equal(a, b):
    return a[0] == b[0] and a[1].keys() == b[1].keys() and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_no_model_draws_a_mask_but_through_common():
    """The model sources reach no ``nn.Dropout``, ``F.dropout`` or
    ``torch.rand``: every mask is :func:`keep_mask`'s."""
    for path in sorted((ROOT / "nkbx_torch" / "models").glob("*.py")):
        if path.name == "common.py":
            continue
        src = path.read_text()
        for word in ("nn.Dropout(", "F.dropout(", "torch.rand(", "bernoulli", "torch.rand_like"):
            assert word not in src, (path.name, word)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_dropout_draws_from_the_state_generator(family):
    module = _module(family)
    rates = [m.p for m in module.modules() if isinstance(m, Dropout)]
    assert len(rates) >= 2 and set(rates) == {P}, rates  # the classifier's and the backbone's
    assert not any(isinstance(m, nn.Dropout) for m in module.modules())
    a = _steps(module, state_seed=0, torch_seed=1)
    b = _steps(module, state_seed=0, torch_seed=2)
    assert _equal(a, b), family
    other = _steps(module, state_seed=1, torch_seed=1)
    assert other[0][0] != a[0][0], family  # the masks are active in step 0
    assert all(np.isfinite(a[0]))


def test_kept_share_and_scale():
    x = torch.rand(1000, 1000) + 0.5  # no zero to hide a dropped element
    with dropout_source(torch.Generator().manual_seed(0)):
        y = dropout(x, P)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - P)) <= 0.005 * (1 - P), share
    assert torch.equal(y[kept], x[kept] * torch.tensor(1 / (1 - P), dtype=torch.float32))


def test_outside_a_step_it_draws_as_torch_dropout():
    x = torch.randn(64, 32)
    torch.manual_seed(5)
    ours = Dropout(0.3).train()(x)
    torch.manual_seed(5)
    want = nn.Dropout(0.3).train()(x)
    assert torch.equal(ours, want)
    assert torch.equal(Dropout(0.3).eval()(x), x)


def test_scan_steps_call_equals_single_calls_with_dropout():
    module = _module("vit")
    one = _steps(module, state_seed=3, scan=1, flips=True)
    two = _steps(module, state_seed=3, scan=2, flips=True)
    assert _equal(one, two)
    assert torch.equal(one[2].generator.get_state(), two[2].generator.get_state())


def test_remat_stages_with_dropout_equal_the_step_without():
    plain = _module("resnet")
    rematted = _module("resnet", remat_stages=(0, 1))
    rematted.load_state_dict(plain.state_dict())
    a, b = _steps(plain, state_seed=2), _steps(rematted, state_seed=2)
    assert _equal(a, b)
    assert torch.equal(a[2].generator.get_state(), b[2].generator.get_state())


def test_a_mask_drawn_inside_remat_is_replayed():
    """A Dropout inside the remat'd region: the replay draws the forward's
    mask again (the gradients equal the run without remat) and leaves the
    generator where the forward left it."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 64), Dropout(0.5), nn.Linear(64, 4))
    x = torch.randn(6, 8)

    def run(use_remat):
        net.zero_grad()
        gen = torch.Generator().manual_seed(3)
        with dropout_source(gen):
            out = remat(net, x) if use_remat else net(x)
            after_forward = gen.get_state()
            out.square().sum().backward()
        assert torch.equal(gen.get_state(), after_forward)
        return out.detach(), [p.grad.clone() for p in net.parameters()], gen.get_state()

    want, got = run(False), run(True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
