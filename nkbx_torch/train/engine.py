"""The train, eval and predict steps of the port (counterpart of
``nkbx/train/engine.py``).

One train step is nkbx's ``build_train_step`` program, run eagerly: the
uint8 batch through the device augment (flips, Normalize to the compute
dtype), the forward in the compute dtype over f32 master parameters, the
masked loss, the backward (through the kernels' autograd Functions on the
card), and the two-group optimizer update scaled by ``lr_factor`` and
``freeze_scale``. Metrics stay on the device: nothing in a step waits for
the host.
"""

from __future__ import annotations

import torch

from nkbx_torch.train.optim import OptimizerBundle, apply_updates


def _iter_metrics(preds, label, mask, loss_out):
    """Per-batch metric payload (nkbx ``_iter_metrics``, engine.py:36-57):
    softmax confidences, argmax predictions, ground truth, loss and mask, as
    device tensors."""
    def one(p, lab, loss):
        return {"confidences": torch.softmax(p.float(), dim=-1),
                "predictions": p.argmax(-1), "ground_truth": lab, "loss": loss}

    if isinstance(preds, dict):
        out = {t: one(preds[t], label[t], loss_out[t]) for t in preds}
        out["loss"] = loss_out["loss"]
        out["mask"] = mask
        return out
    return {**one(preds, label, loss_out), "mask": mask}


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


_UNPORTED = {"grad_accum_steps": 1, "scan_steps": 1, "ema_decay": 0.0, "mixup": None,
             "masked_bn": False, "log_gradients": False}


def build_train_step(model, criterion, bundle: OptimizerBundle, augment_fn=None,
                     freeze_semantics: str = "decay", **options):
    """Returns ``step(state, image_u8, label, mask, lr_factor, freeze_scale)
    -> (state, metrics)``, nkbx's train step (engine.py:83).

    ``augment_fn(image_u8, out_dtype=..., generator=...)`` is the device
    stage (``Compose.device_apply``): it receives the model's compute dtype
    and the state's generator. ``freeze_semantics`` is ``"decay"`` or
    ``"torch"`` (see :mod:`nkbx_torch.train.optim`). The step advances
    ``state`` in place and leaves each parameter's raw gradient in
    ``.grad``. nkbx's other options (``grad_accum_steps``, ``scan_steps``,
    ``ema_decay``, ``mixup``, ``masked_bn``, ``log_gradients``) are not
    ported: any value but the default raises."""
    for name, value in options.items():
        if name not in _UNPORTED:
            raise TypeError(f"build_train_step got an unexpected option {name!r}")
        if value != _UNPORTED[name]:
            raise NotImplementedError(f"build_train_step option {name}={value!r} is not ported "
                                      "to nkbx_torch yet (ROADMAP.md)")
    if freeze_semantics not in ("decay", "torch"):
        raise ValueError(f"freeze_semantics must be 'decay' or 'torch', got {freeze_semantics!r}")
    module, dtype = model.module, model.dtype

    def step(state, image, label, mask, lr_factor, freeze_scale):
        module.train()
        x = (augment_fn(image, out_dtype=dtype, generator=state.generator)
             if augment_fn is not None else image)
        module.zero_grad(set_to_none=True)
        preds = module(x)
        loss_out = criterion(preds, label, mask=mask)
        (loss_out["loss"] if isinstance(loss_out, dict) else loss_out).backward()
        apply_updates(bundle, state.opt_state, state.groups, lr_factor, freeze_scale,
                      freeze_semantics)
        state.step += 1
        with torch.no_grad():
            return state, _iter_metrics(_detach(preds), label, mask, _detach(loss_out))

    return step


def build_eval_step(model, criterion, augment_fn=None):
    """Returns ``eval_step(state, image_u8, label, mask) -> metrics``: the
    device stage without random ops, the model in eval mode, the loss, and
    no gradients."""
    module, dtype = model.module, model.dtype

    @torch.inference_mode()
    def eval_step(state, image, label, mask):
        module.eval()
        x = augment_fn(image, out_dtype=dtype) if augment_fn is not None else image
        preds = module(x)
        return _iter_metrics(preds, label, mask, criterion(preds, label, mask=mask))

    return eval_step


def build_predict_fn(model, augment_fn=None):
    """``image_u8 -> logits`` (a tensor, or {target: tensor}): the device
    stage ``augment_fn`` (for serving, Normalize to the compute dtype) and
    then the model in eval mode, without autograd."""
    module = model.module

    @torch.inference_mode()
    def predict(image):
        module.eval()
        x = augment_fn(image) if augment_fn is not None else image
        return module(x)

    return predict
