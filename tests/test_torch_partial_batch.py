"""The port's partial-batch warning. nkbx warns of a padded batch in a train
step without masked BatchNorm for any model (``nkbx/train/engine.py:671-685``),
also one with no BatchNorm; the port warns only where the step's model has a
BatchNorm, whose batch statistics the padding would reach (port-only tests:
nkbx's own warning stays pinned in tests/test_torch_trainer.py)."""

import warnings

import numpy as np
import pytest
import torch

from nkbx_torch.models import get_model
from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
from nkbx_torch.models.swin import SwinTransformer
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
from nkbx_torch.train.engine import has_batchnorm, train_epoch
from nkbx_torch.transforms import Compose, Normalize

TINY = dict(embed_dim=16, depths=(2, 2), n_heads=(1, 2), window=2)
SIZE, BATCH = 32, 4
SGD = {"type": "sgd", "lr": 0.01, "weight_decay": 0.0}


class _Loader:
    """Two host batches of BATCH seeded uint8 images, the last with only
    ``valid`` real rows."""

    drop_last = False

    def __init__(self, valid):
        rng = np.random.default_rng(0)
        self.batches = []
        for i in range(2):
            mask = np.arange(BATCH) < (valid if i == 1 else BATCH)
            self.batches.append({
                "image": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
                "label": rng.integers(0, 3, BATCH), "mask": mask})

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch, start=0):
        return iter(self.batches[start:])


def _swin():
    backbone = SwinTransformer(dtype=torch.float32, img_size=(SIZE, SIZE), **TINY)
    return ClassificationModel(SingletaskClassifier(backbone, 3), list("abc"), "single",
                               backbone.num_features, (SIZE, SIZE), torch.float32,
                               torch.device("cpu"))


def _resnet():
    return get_model({"model": "resnet_tiny_test"}, list("abc"), input_size=(SIZE, SIZE),
                     seed=0, device="cpu", dtype=torch.float32)


def _epoch(model, masked_bn, monkeypatch):
    """One epoch over a loader whose last batch is padded; the warnings it
    raised. The warning fires once a process: the flag is reset first."""
    monkeypatch.setattr(train_epoch, "_warned_partial", False, raising=False)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=masked_bn)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train_epoch(TrainState.create(model, seed=0), _Loader(valid=1), step, 0, 1.0, 1.0,
                    progress=False)
    return step, [str(w.message) for w in caught]


def test_an_epoch_without_batchnorm_and_a_ragged_last_batch_does_not_warn(monkeypatch):
    step, caught = _epoch(_swin(), False, monkeypatch)
    assert step.has_batchnorm is False and step.masked_bn is False
    assert not [m for m in caught if "Partial" in m]


@pytest.mark.parametrize("masked_bn", [False, True])
def test_a_resnet_step_warns_of_a_padded_batch_unless_masked(monkeypatch, masked_bn):
    step, caught = _epoch(_resnet(), masked_bn, monkeypatch)
    assert step.has_batchnorm is True
    assert len([m for m in caught if "Partial" in m]) == (0 if masked_bn else 1)


def test_has_batchnorm_finds_the_models_with_batchnorm():
    assert has_batchnorm(_resnet().module) and not has_batchnorm(_swin().module)
