"""Single/multi-task classifiers and the model factory (counterpart of
``nkbx/models/classifier.py``).

The backbone computes in its compute dtype (bf16 on the card) with f32
parameters; the heads compute in f32. ``forward(x, mask=None)`` hands
``mask`` (B, 1, 1, 1) to the backbone, whose BatchNorms weight padded rows
out of their statistics in training (the families without BatchNorm ignore
it), as nkbx's classifiers do.
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch
import torch.nn.functional as F
from torch import nn

from nkbx_torch.core.runtime import resolve_device
from nkbx_torch.models.pretrained import load_checkpoint
from nkbx_torch.models.registry import create_backbone

# same strategy names as nkbx's INIT_STRATEGIES (reference model.py:45-57);
# torch's own functions are the distributions nkbx reproduces
INIT_STRATEGIES = {
    "kaiming_normal_": lambda w, g: nn.init.kaiming_normal_(w, nonlinearity="relu",
                                                            generator=g),
    "kaiming_uniform_": lambda w, g: nn.init.kaiming_uniform_(w, nonlinearity="relu",
                                                              generator=g),
    "xavier_normal_": lambda w, g: nn.init.xavier_normal_(w, generator=g),
    "xavier_uniform_": lambda w, g: nn.init.xavier_uniform_(w, generator=g),
}


class Head(nn.Linear):
    """A classifier head: ``nn.Linear`` computing in f32 whatever its
    parameters' dtype (nkbx's ``nn.Dense(dtype=float32)``; bf16 under
    ``bf16_master_weights``)."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


def _head(emb_size: int, n: int, init: str, generator: torch.Generator) -> nn.Linear:
    head = Head(emb_size, n)
    INIT_STRATEGIES[init](head.weight.data, generator)
    head.bias.data.zero_()
    return head


class SingletaskClassifier(nn.Module):
    def __init__(self, backbone: nn.Module, n_classes: int, classifier_dropout: float = 0.0,
                 classifier_initialization: str = "kaiming_normal_", generator=None):
        super().__init__()
        self.backbone = backbone
        self.dropout = nn.Dropout(classifier_dropout)
        self.head = _head(backbone.num_features, n_classes, classifier_initialization,
                          generator)

    def forward(self, x, mask=None):
        return self.head(self.dropout(self.backbone(x, mask=mask).float()))


class MultitaskClassifier(nn.Module):
    def __init__(self, backbone: nn.Module, classes: Dict[str, List],
                 classifier_dropout: float = 0.0,
                 classifier_initialization: str = "kaiming_normal_", generator=None):
        super().__init__()
        self.backbone = backbone
        self.dropout = nn.Dropout(classifier_dropout)
        self.targets = sorted(classes)
        for t in self.targets:
            self.add_module(f"head_{t}", _head(backbone.num_features, len(classes[t]),
                                               classifier_initialization, generator))

    def forward(self, x, mask=None):
        emb = self.dropout(self.backbone(x, mask=mask).float())
        return {t: getattr(self, f"head_{t}")(emb) for t in self.targets}


def is_backbone_param(name: str) -> bool:
    """True if a parameter name (``module.named_parameters()``) belongs to
    the backbone, False for a classifier head (``head``, ``head_<target>``):
    nkbx's rule (classifier.py:75-84), on dotted names."""
    for part in name.split("."):
        if part == "backbone":
            return True
        if part.startswith("head"):
            return False
    return False


def param_labels(module: nn.Module) -> Dict[str, str]:
    """{parameter name: 'backbone' | 'classifier'}, the two optimizer groups
    (nkbx ``param_labels``, classifier.py:87-91)."""
    return {name: "backbone" if is_backbone_param(name) else "classifier"
            for name, _ in module.named_parameters()}


class ClassificationModel:
    """Module plus metadata (what :func:`get_model` returns).

    Attributes: module (the classifier with f32 parameters, handed back in
    eval mode; the train step puts it in train mode, where dropout with a
    rate above 0 is active), classes (list, or {target: list}), task
    ('single' | 'multi'), emb_size, input_size, dtype (compute dtype),
    device. Calling the model is inference only."""

    def __init__(self, module, classes, task, emb_size, input_size, dtype, device):
        self.module = module
        self.classes = classes
        self.task = task
        self.emb_size = emb_size
        self.input_size = tuple(input_size)
        self.dtype = dtype
        self.device = device

    def __call__(self, x):
        with torch.inference_mode():
            return self.module(x)


def get_model(cfg_model: dict, classes: Union[list, dict], input_size=(224, 224),
              seed: int = 0, dtype=torch.bfloat16, device=None) -> ClassificationModel:
    """Build a classifier from a config dict (nkbx's keys: task, model,
    backbone_dropout, classifier_dropout, classifier_initialization,
    backbone_opts, pretrained, checkpoint). Weights come from a
    ``torch.Generator`` seeded with ``seed``; then, as in nkbx, with
    ``pretrained`` the backbone's converted file (nkbx's rule, see
    :mod:`nkbx_torch.models.pretrained`), and ``checkpoint``: a nkbx
    ``.msgpack``, a port ``state_dict`` file or a port checkpoint directory.
    ``scripted: True`` (nkbx's surface, reference model.py:163-164) returns
    an :class:`~nkbx_torch.export.ExportedModel` of the ``checkpoint``, a
    ``.nkbx`` bundle (its classes, task and dtype are the bundle's).
    ``device`` defaults to ``cuda`` and raises without a card."""
    if cfg_model.get("scripted", False):
        from nkbx_torch.export.serving import ExportedModel

        return ExportedModel(cfg_model["checkpoint"], device=device)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    backbone = create_backbone(
        cfg_model["model"], pretrained=cfg_model.get("pretrained", False),
        drop_rate=cfg_model.get("backbone_dropout", 0.0) or 0.0, dtype=dtype,
        img_size=input_size, generator=gen, **(cfg_model.get("backbone_opts") or {}))
    task = cfg_model.get("task", "single")
    common = dict(classifier_dropout=cfg_model.get("classifier_dropout", 0.0) or 0.0,
                  classifier_initialization=cfg_model.get("classifier_initialization",
                                                          "kaiming_normal_"),
                  generator=gen)
    if task == "single":
        module = SingletaskClassifier(backbone, len(classes), **common)
    elif task == "multi":
        module = MultitaskClassifier(backbone, classes, **common)
    else:
        raise ValueError(f"Unknown task {task!r}")
    ckpt = cfg_model.get("checkpoint")
    if ckpt:
        load_checkpoint(module, ckpt)
    module.to(dev).eval()
    return ClassificationModel(module, classes, task, backbone.num_features, input_size,
                               dtype, dev)
