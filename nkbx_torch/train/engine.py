"""Forward-only engine pieces of the port (counterpart of
``nkbx/train/engine.py``). Only the predict function is ported so far; the
train and eval steps come with the training slice (ROADMAP.md)."""

from __future__ import annotations

import torch


def build_predict_fn(model, augment_fn=None):
    """``image_u8 -> logits`` (a tensor, or {target: tensor}): the device
    stage ``augment_fn`` (for serving, Normalize to the compute dtype) and
    then the model in eval mode, without autograd."""
    module = model.module

    @torch.inference_mode()
    def predict(image):
        x = augment_fn(image) if augment_fn is not None else image
        return module(x)

    return predict
