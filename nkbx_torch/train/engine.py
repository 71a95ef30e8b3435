"""The train, eval and predict steps of the port (counterpart of
``nkbx/train/engine.py``).

One train step is nkbx's ``build_train_step`` program, run eagerly: the
uint8 batch through the device augment (flips, Normalize to the compute
dtype), the forward in the compute dtype over f32 master parameters, the
masked loss, the backward (through the kernels' autograd Functions on the
card), and the two-group optimizer update scaled by ``lr_factor`` and
``freeze_scale``. Metrics stay on the device: nothing in a step waits for
the host.

The epoch half (nkbx ``engine.py:374-810``): :class:`EpochCollector`
gathers each step's metrics (exact per-sample, or bounded counts on the
card), :func:`train_epoch` runs an epoch of steps from a loader, from a
preemption cursor on, and :func:`val_epoch` one of evaluation.
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np
import torch

from nkbx_torch.core.runtime import Throughput
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
             "log_gradients": False}


def build_train_step(model, criterion, bundle: OptimizerBundle, augment_fn=None,
                     freeze_semantics: str = "decay", masked_bn: bool = False, **options):
    """Returns ``step(state, image_u8, label, mask, lr_factor, freeze_scale)
    -> (state, metrics)``, nkbx's train step (engine.py:83).

    ``augment_fn(image_u8, out_dtype=..., generator=...)`` is the device
    stage (``Compose.device_apply``): it receives the model's compute dtype
    and the state's generator. ``freeze_semantics`` is ``"decay"`` or
    ``"torch"`` (see :mod:`nkbx_torch.train.optim`). ``masked_bn=True``
    weights padded batch rows out of the BatchNorm statistics: the model
    gets ``mask.reshape(-1, 1, 1, 1)`` in training (nkbx engine.py:150-159).
    The step advances ``state`` in place (BatchNorm running statistics
    included) and leaves each parameter's raw gradient in ``.grad``. nkbx's
    other options (``grad_accum_steps``, ``scan_steps``, ``ema_decay``,
    ``mixup``, ``log_gradients``) are not ported: any value but the default
    raises."""
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
        preds = module(x, mask=mask.reshape(-1, 1, 1, 1)) if masked_bn else module(x)
        loss_out = criterion(preds, label, mask=mask)
        (loss_out["loss"] if isinstance(loss_out, dict) else loss_out).backward()
        apply_updates(bundle, state.opt_state, state.groups, lr_factor, freeze_scale,
                      freeze_semantics)
        state.step += 1
        with torch.no_grad():
            return state, _iter_metrics(_detach(preds), label, mask, _detach(loss_out))

    step.masked_bn = masked_bn
    step.has_batchnorm = has_batchnorm(module)
    return step


def has_batchnorm(module) -> bool:
    """Whether the module holds a BatchNorm (whose batch statistics a padded
    batch would reach)."""
    from nkbx_torch.models.common import TorchBatchNorm

    return any(isinstance(m, TorchBatchNorm) for m in module.modules())


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


# --- epoch collection -----------------------------------------------------------------


def _to_host(tree):
    """Tensors of a nest of dicts and lists as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


class EpochCollector:
    """Gathers each step's metrics and turns them into the epoch's results.

    ``mode="exact"`` keeps every step's per-sample tensors on the card and
    copies them to the host at the epoch's end: running_loss (per-step
    floats), confidences, predictions and ground_truth (lists, or per-target
    dicts of lists for multi-task), padded rows removed. O(N·C) memory.

    ``mode="bounded"`` folds every step into O(C^2 + C·N_BINS) counts on the
    card (:func:`nkbx_torch.metrics.bounded_update`): balanced accuracy exact,
    ROC-AUC within ~1/N_BINS. Config key ``metrics_accumulation``."""

    def __init__(self, task: str = "single", mode: str = "exact"):
        if mode not in ("exact", "bounded"):
            raise ValueError(f"Unknown metrics accumulation mode {mode!r}")
        self.task = task
        self.mode = mode
        self.init_iter_logs()

    def init_iter_logs(self):
        self._batches = []
        self._bounded = {}
        self._losses = defaultdict(list)
        self.epoch_images_example = None

    def log_iter(self, metrics):
        if self.mode == "exact":
            self._batches.append(metrics)
        elif self.task == "multi":
            for t, tm in metrics.items():
                if isinstance(tm, dict) and "confidences" in tm:
                    self._fold_one(t, tm, metrics["mask"])
            self._losses["loss"].append(metrics["loss"])
        else:
            self._fold_one(None, metrics, metrics["mask"])

    def _fold_one(self, key, m, mask):
        from nkbx_torch.metrics import bounded_update, make_bounded_state

        if key not in self._bounded:
            self._bounded[key] = make_bounded_state(m["confidences"].shape[-1],
                                                    m["confidences"].device)
        bounded_update(self._bounded[key], m["confidences"], m["predictions"],
                       m["ground_truth"], mask, m["loss"])
        self._losses[key].append(m["loss"])

    def log_images_if_needed(self, images):
        if self.epoch_images_example is None:
            self.epoch_images_example = np.asarray(images)

    def _bounded_results(self):
        from nkbx_torch.metrics import bounded_targetwise_metrics

        def flat_losses(v):
            return [float(f) for x in _to_host(v) for f in np.ravel(x)]

        results = {"images": self.epoch_images_example}
        if self.task == "multi":
            results["running_loss"] = {k: flat_losses(v) for k, v in self._losses.items()}
            results["bounded_metrics"] = {t: bounded_targetwise_metrics(s)
                                          for t, s in self._bounded.items()}
            results["confusion_counts"] = {t: s["counts"].cpu().numpy()
                                           for t, s in self._bounded.items()}
        else:
            results["running_loss"] = flat_losses(self._losses.get(None, []))
            state = self._bounded[None]
            results["bounded_metrics"] = bounded_targetwise_metrics(state)
            results["confusion_counts"] = state["counts"].cpu().numpy()
        return results

    def get_epoch_results(self):
        if self.mode == "bounded":
            return self._bounded_results()
        batches = _to_host(self._batches)
        if self.task == "multi":
            running_loss, confidences = defaultdict(list), defaultdict(list)
            predictions, ground_truth = defaultdict(list), defaultdict(list)
            for m in batches:
                valid = m["mask"]
                for t, tm in m.items():
                    if t in ("mask", "loss"):
                        continue
                    running_loss[t].extend(np.ravel(tm["loss"]).tolist())
                    confidences[t].extend(tm["confidences"][valid].tolist())
                    predictions[t].extend(tm["predictions"][valid].tolist())
                    ground_truth[t].extend(tm["ground_truth"][valid].tolist())
                running_loss["loss"].extend(np.ravel(m["loss"]).tolist())
        else:
            running_loss, confidences, predictions, ground_truth = [], [], [], []
            for m in batches:
                valid = m["mask"]
                running_loss.extend(np.ravel(m["loss"]).tolist())
                confidences.extend(m["confidences"][valid].tolist())
                predictions.extend(m["predictions"][valid].tolist())
                ground_truth.extend(m["ground_truth"][valid].tolist())
        return {"running_loss": running_loss, "confidences": confidences,
                "predictions": predictions, "ground_truth": ground_truth,
                "images": self.epoch_images_example}


# --- epoch loops ----------------------------------------------------------------------


def _put_batch(batch, device):
    """A host batch's image, label and mask as tensors on ``device``."""
    def put(v):
        if isinstance(v, dict):
            return {k: put(x) for k, x in v.items()}
        return torch.from_numpy(np.asarray(v)).to(device)

    return {k: put(v) for k, v in batch.items() if k in ("image", "label", "mask")}


def _progress(it, desc, total, on):
    """``it`` under a tqdm bar where tqdm is installed and ``on``."""
    if not on:
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, leave=False, desc=desc, total=total)


def train_epoch(state, train_loader, train_step, epoch: int, lr_factor: float,
                freeze_scale: float, epoch_logger=None, progress: bool = True, cfg=None,
                start_batch: int = 0, device=None):
    """One training epoch of ``train_step`` (:func:`build_train_step`) over
    ``train_loader.epoch(epoch)``; returns (state, epoch_results).

    ``start_batch > 0`` continues a preempted epoch from its cursor. A
    SIGTERM (:mod:`nkbx_torch.train.preempt`) breaks the loop before the
    next batch; ``epoch_results`` then has ``preempted`` True, and
    ``consumed_batches`` counts the epoch's batches stepped so far
    (``start_batch`` included), the cursor the trainer saves. Metrics of a
    resumed epoch cover the remaining batches. ``device`` defaults to the
    module's."""
    from nkbx_torch.train import preempt

    device = next(state.module.parameters()).device if device is None else device
    task = getattr(cfg, "task", "single") if cfg is not None else "single"
    logger = epoch_logger if epoch_logger is not None else EpochCollector(task)
    logger.init_iter_logs()
    tp = Throughput()
    it = train_loader.epoch(epoch, start_batch) if start_batch else train_loader.epoch(epoch)
    it = _progress(it, "Training", len(train_loader) - start_batch, progress)
    steps, metrics, preempted = 0, None, False
    for batch in it:
        if preempt.requested():
            preempted = True
            break
        dev = _put_batch(batch, device)
        state, metrics = train_step(state, dev["image"], dev["label"], dev["mask"], lr_factor,
                                    freeze_scale)
        logger.log_iter(metrics)
        tp.step(int(batch["mask"].sum()))
        # nkbx warns here for any unmasked step; only a BatchNorm sees the padding
        if (not batch["mask"].all() and not getattr(train_step, "masked_bn", False)
                and getattr(train_step, "has_batchnorm", True)):
            _warn_unmasked_partial()
        if steps == 0:
            logger.log_images_if_needed(batch["image"])
        steps += 1
        if progress and hasattr(it, "set_postfix_str") and steps % 10 == 1:
            it.set_postfix_str(f"Loss: {float(_loss_of(metrics)):.4f}")
    if metrics is not None:
        float(_loss_of(metrics))  # wait for the last step, so the throughput is honest
    results = logger.get_epoch_results()
    results["throughput"] = tp.snapshot()
    results["preempted"] = preempted
    results["consumed_batches"] = start_batch + steps
    return state, results


def _loss_of(metrics):
    return metrics["loss"].reshape(-1)[-1]


def _warn_unmasked_partial():
    if not getattr(train_epoch, "_warned_partial", False):
        warnings.warn("Partial (padded) batch in TRAIN mode with an unmasked-BN train step: "
                      "BatchNorm batch statistics include the zero padding rows. Build the "
                      "step with masked_bn=True (the trainer does this when drop_last=False) "
                      "or use drop_last=True.")
        train_epoch._warned_partial = True


def val_epoch(state, val_loader, eval_step, epoch: int = 0, epoch_logger=None,
              progress: bool = True, task: str = "single", device=None):
    """One evaluation epoch of ``eval_step`` (:func:`build_eval_step`);
    returns the epoch's results."""
    device = next(state.module.parameters()).device if device is None else device
    logger = epoch_logger if epoch_logger is not None else EpochCollector(task)
    logger.init_iter_logs()
    it = _progress(val_loader.epoch(epoch), "Evaluating", len(val_loader), progress)
    for i, batch in enumerate(it):
        dev = _put_batch(batch, device)
        logger.log_iter(eval_step(state, dev["image"], dev["label"], dev["mask"]))
        if i == 0:
            logger.log_images_if_needed(batch["image"])
    return logger.get_epoch_results()
