"""The train, eval and predict steps of the port (counterpart of
``nkbx/train/engine.py``).

One train step is nkbx's ``build_train_step`` program, run eagerly: the
uint8 batch through the device augment (Normalize to the compute dtype
last), mixup/CutMix, the forward in the compute dtype over f32 master
parameters, the masked loss, the backward (through the kernels' autograd
Functions on the card), optionally over microbatches, the two-group
optimizer update scaled by ``lr_factor`` and ``freeze_scale``, and the EMA
of the weights. Metrics stay on the device: nothing in a step waits for the
host.

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


def _tree_map(fn, *trees):
    """``fn`` over the tensors of one or more nests of dicts of the same
    keys (a label or a metrics dict)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _detach(tree):
    return _tree_map(lambda t: t.detach(), tree)


def _stack(trees):
    """A list of metrics dicts as one dict of tensors stacked on a new first
    dimension (nkbx's ``lax.scan`` outputs)."""
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _scalar(loss_out):
    return loss_out["loss"] if isinstance(loss_out, dict) else loss_out


def build_train_step(model, criterion, bundle: OptimizerBundle, augment_fn=None,
                     log_gradients: bool = False, masked_bn: bool = False, scan_steps: int = 1,
                     grad_accum_steps: int = 1, ema_decay: float = 0.0, mixup: dict = None,
                     freeze_semantics: str = "decay", debug_nans: bool = False):
    """Returns ``step(state, image_u8, label, mask, lr_factor, freeze_scale)
    -> (state, metrics)``, nkbx's train step (engine.py:83-295).

    ``augment_fn(image_u8, out_dtype=..., generator=...)`` is the device
    stage (``Compose.device_apply``): it receives the model's compute dtype
    and the state's generator. ``freeze_semantics`` is ``"decay"`` or
    ``"torch"`` (see :mod:`nkbx_torch.train.optim`). ``masked_bn=True``
    weights padded batch rows out of the BatchNorm statistics: the model
    gets ``mask.reshape(-1, 1, 1, 1)`` in training (nkbx engine.py:150-159).
    The step advances ``state`` in place (BatchNorm running statistics
    included) and leaves each parameter's gradient in ``.grad``.

    nkbx's options:

    - ``mixup`` (a config dict, :mod:`nkbx_torch.train.mixup`): the batch is
      mixed after the device stage, from the state's generator, and the loss
      is ``lam * loss(label) + (1 - lam) * loss(label[partner])``, per entry
      of a multi-task loss dict. ``step.mixup`` is the op (its ``draw`` can
      be replaced to feed given draws).
    - ``grad_accum_steps`` = A: the batch splits into A microbatches run one
      after the other (the BatchNorm running statistics advance microbatch by
      microbatch); each microbatch's gradient is weighted by its mass
      (``criterion.batch_mass``, the valid rows otherwise) and their sum
      divided by the total mass (clamped at 1e-12); one update. Mixup draws
      once for the whole batch. Metrics come back stacked (A, ...).
    - ``scan_steps`` = K: the step takes (K, B, ...) image, label and mask
      and runs K steps in one call, metrics stacked (K, ...), as nkbx's
      ``multi_step``; here a loop of K steps.
    - ``ema_decay`` > 0 with a state made with ``ema=True``: after the update
      the shadow moves as ``e <- e * d + p * (1 - d)`` over the parameters
      and the BatchNorm running statistics.
    - ``log_gradients``: ``metrics["grad_norms"]`` holds the f32 L2 norm of
      each parameter's gradient after the coupled weight decay and the
      freeze mask (the accumulated gradient under A > 1), keyed by nkbx's
      flax path (``backbone/.../kernel``).
    - ``debug_nans`` (nkbx's ``jax_debug_nans``): after the backward, one
      fused finiteness check over the loss and every gradient, read by the
      host, raises FloatingPointError naming the step (``state.step``, 0 for
      the first) before the update; with ``scan_steps`` each of the K steps
      is checked. Off, the step is unchanged.

    Without ``debug_nans`` nothing in a step waits on a host value. nkbx's errors are raised where
    nkbx raises them: ``scan_steps`` with accumulation; A not dividing the
    batch; accumulation with a multi-task criterion that normalises by mass;
    mixup with accumulation and a criterion of non-uniform mass."""
    from nkbx_torch.models.convert import flax_param_path
    from nkbx_torch.train.mixup import Mixup

    scan_steps, accum = int(scan_steps), int(grad_accum_steps)
    if scan_steps > 1 and accum > 1:
        raise ValueError("steps_per_dispatch and grad_accum_steps are mutually "
                         "exclusive (unvalidated metric-stacking interaction)")
    if freeze_semantics not in ("decay", "torch"):
        raise ValueError(f"freeze_semantics must be 'decay' or 'torch', got {freeze_semantics!r}")
    inner_mass = getattr(getattr(criterion, "criterion", None), "_mass_fn", None)
    if accum > 1 and inner_mass is not None:
        raise ValueError(
            "multi-task grad_accum_steps with a mass-normalized criterion "
            "(class-weighted CE / focal): per-target normalizers differ per "
            "microbatch and a single per-microbatch weight cannot reproduce "
            "the full-batch gradient (single-task stays exact via "
            "criterion.batch_mass) — use an unweighted loss or no accumulation")
    mix = None
    if mixup is not None:
        mix = Mixup(mixup)
        nonuniform_mass = getattr(criterion, "_mass_fn", None) is not None or inner_mass is not None
        if accum > 1 and nonuniform_mass:
            raise ValueError(
                "mixup + grad_accum_steps with a mass-normalized criterion "
                "(class-weighted CE / focal): the primary and partner label "
                "masses differ per microbatch, so a single per-microbatch "
                "weight cannot reproduce the full-batch gradient — drop one "
                "of the three (unweighted loss, no accumulation, or no mixup)")
    module, dtype = model.module, model.dtype
    grad_keys = ({p: flax_param_path(n, p) for n, p in module.named_parameters()}
                 if log_gradients else None)

    def forward_loss(x, label, mask, label_b, lam):
        preds = module(x, mask=mask.reshape(-1, 1, 1, 1)) if masked_bn else module(x)
        loss_out = criterion(preds, label, mask=mask)
        if label_b is not None:
            loss_b = criterion(preds, label_b, mask=mask)
            loss_out = _tree_map(lambda a, b: lam * a + (1.0 - lam) * b, loss_out, loss_b)
        return preds, loss_out

    def accumulate(x, label, mask, label_b, lam):
        """The A microbatches' mass-weighted gradients into ``.grad``; their
        metrics stacked (nkbx engine.py:188-236)."""
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"grad_accum_steps={accum} must divide batch {b}")

        def split(v):
            return v.reshape((accum, b // accum) + tuple(v.shape[1:]))

        xs, ls, ms = split(x), _tree_map(split, label), split(mask)
        lbs = _tree_map(split, label_b) if label_b is not None else None
        params = list(module.parameters())
        gsum, nsum, per = None, 0.0, []
        for i in range(accum):
            l_i = _tree_map(lambda v: v[i], ls)
            lb_i = _tree_map(lambda v: v[i], lbs) if lbs is not None else None
            module.zero_grad(set_to_none=True)
            preds, loss_out = forward_loss(xs[i], l_i, ms[i], lb_i, lam)
            _scalar(loss_out).backward()
            with torch.no_grad():
                n = (criterion.batch_mass(l_i, ms[i]) if hasattr(criterion, "batch_mass")
                     else ms[i].float().sum())
                # this microbatch's .grad tensors are scaled in place: the next
                # zero_grad(set_to_none=True) leaves them to gsum
                g = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                torch._foreach_mul_(g, n)
                if gsum is None:
                    gsum = g
                else:
                    torch._foreach_add_(gsum, g)
                nsum = nsum + n
                per.append(_iter_metrics(_detach(preds), l_i, ms[i], _detach(loss_out)))
        with torch.no_grad():
            torch._foreach_div_(gsum, torch.clamp(nsum, min=1e-12))
            for p, g in zip(params, gsum):
                p.grad = g
        return _stack(per)

    def one_step(state, image, label, mask, lr_factor, freeze_scale):
        module.train()
        x = (augment_fn(image, out_dtype=dtype, generator=state.generator)
             if augment_fn is not None else image)
        label_b = lam = None
        if mix is not None:
            # a padded row's partner is itself, which leaves the row unmixed
            x, lam, partner = mix(x, mask, generator=state.generator)
            label_b = _tree_map(lambda v: v[partner], label)
        module.zero_grad(set_to_none=True)
        metrics = None
        if accum > 1:
            metrics = accumulate(x, label, mask, label_b, lam)
        else:
            preds, loss_out = forward_loss(x, label, mask, label_b, lam)
            _scalar(loss_out).backward()
        if debug_nans:
            check_finite(state.step, metrics["loss"] if metrics is not None
                         else _scalar(loss_out), module.parameters())
        grads = apply_updates(bundle, state.opt_state, state.groups, lr_factor, freeze_scale,
                              freeze_semantics)
        with torch.no_grad():
            if ema_decay > 0 and state.ema_module is not None:
                state.update_ema(ema_decay)
            state.step += 1
            if metrics is None:
                metrics = _iter_metrics(_detach(preds), label, mask, _detach(loss_out))
            if log_gradients:
                norms = {}
                for label_, params in state.groups.items():
                    if label_ in grads:
                        gs = [g.float() for g in grads[label_]]
                        norms.update(zip((grad_keys[p] for p in params), torch._foreach_norm(gs)))
                metrics["grad_norms"] = dict(sorted(norms.items()))
        return state, metrics

    if scan_steps > 1:
        def step(state, images, labels, masks, lr_factor, freeze_scale):
            """K steps, one per leading row of the stacked batch."""
            out = []
            for k in range(images.shape[0]):
                state, m = one_step(state, images[k], _tree_map(lambda v: v[k], labels),
                                    masks[k], lr_factor, freeze_scale)
                out.append(m)
            return state, _stack(out)
    else:
        step = one_step

    step.masked_bn = masked_bn
    step.has_batchnorm = has_batchnorm(module)
    step.scan_steps = scan_steps
    step.mixup = mix
    return step


def check_finite(step: int, loss, params):
    """Raise FloatingPointError unless ``loss`` and every gradient of
    ``params`` are finite: one fused non-finite check a (device, dtype)
    group of tensors (``torch._amp_foreach_non_finite_check_and_unscale_``
    with a scale of 1, the loss in the gradients' group), then one read on
    the host."""
    groups = {}
    for t in [p.grad for p in params if p.grad is not None] + [loss.detach().float().reshape(-1)]:
        groups.setdefault((t.device, t.dtype), []).append(t)
    found = None
    for (dev, _), ts in groups.items():
        inf = torch.zeros(1, device=dev)
        # the loss and the gradients are multiplied by 1 in place: unchanged
        torch._amp_foreach_non_finite_check_and_unscale_(ts, inf, torch.ones(1, device=dev))
        found = inf if found is None else found + inf.to(found.device)
    if found is not None and float(found) > 0:
        raise FloatingPointError(f"debug_nans: the loss or a gradient is not finite at train "
                                 f"step {step}")


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
    ROC-AUC within ~1/N_BINS. Config key ``metrics_accumulation``.

    Both take a step's metrics as (B, ...) or stacked (K, B, ...) (scan
    steps, accumulation). Gradient norms (``log_gradients``) come back in
    ``metrics_grad_log``: ``Gradients/<path>`` per parameter and
    ``Gradients/Total``, the sum of a step's norms, one value per step."""

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
        self._grad_norms = []
        self.epoch_images_example = None

    def log_iter(self, metrics):
        if self.mode == "exact":
            self._batches.append(metrics)
            return
        if "grad_norms" in metrics:
            self._grad_norms.append(metrics["grad_norms"])
        if self.task == "multi":
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

    @staticmethod
    def _aggregate_grads(grad_logs):
        """nkbx's ``_aggregate_grads`` (engine.py:471-481) over host arrays."""
        grad_log = defaultdict(list)
        for g in grad_logs:
            totals = None
            for k, v in g.items():
                vals = np.ravel(np.asarray(v)).tolist()  # a scalar, or (K,) stacked
                grad_log[f"Gradients/{k}"].extend(vals)
                totals = vals if totals is None else [a + b for a, b in zip(totals, vals)]
            grad_log["Gradients/Total"].extend(totals or [])
        return dict(grad_log)

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
        if self._grad_norms:
            results["metrics_grad_log"] = self._aggregate_grads(_to_host(self._grad_norms))
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
                    if t in ("mask", "loss", "grad_norms"):
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
        results = {"running_loss": running_loss, "confidences": confidences,
                   "predictions": predictions, "ground_truth": ground_truth,
                   "images": self.epoch_images_example}
        grad_logs = [m["grad_norms"] for m in batches if "grad_norms" in m]
        if grad_logs:
            results["metrics_grad_log"] = self._aggregate_grads(grad_logs)
        return results


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


def _stack_batches(batches):
    """K loader batches' image, label and mask stacked as (K, B, ...) arrays
    for a call of a ``scan_steps`` step."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    return {k: stack(*(b[k] for b in batches)) for k in ("image", "label", "mask")}


def train_epoch(state, train_loader, train_step, epoch: int, lr_factor: float,
                freeze_scale: float, epoch_logger=None, progress: bool = True, cfg=None,
                start_batch: int = 0, device=None):
    """One training epoch of ``train_step`` (:func:`build_train_step`) over
    ``train_loader.epoch(epoch)``; returns (state, epoch_results).

    A step built with ``scan_steps`` = K takes K loader batches a call,
    stacked, and the epoch's last, shorter chunk in a smaller call (nkbx
    engine.py:686-770). ``start_batch > 0`` continues a preempted epoch from
    its cursor. A SIGTERM (:mod:`nkbx_torch.train.preempt`) breaks the loop
    before the next batch; ``epoch_results`` then has ``preempted`` True, and
    ``consumed_batches`` counts the epoch's batches stepped so far
    (``start_batch`` included), the cursor the trainer saves: batches still
    buffered for an unfinished chunk were not stepped and do not count, so a
    resumed run reads them again. Metrics of a resumed epoch cover the
    remaining batches. ``device`` defaults to the module's."""
    from nkbx_torch.train import preempt

    device = next(state.module.parameters()).device if device is None else device
    task = getattr(cfg, "task", "single") if cfg is not None else "single"
    logger = epoch_logger if epoch_logger is not None else EpochCollector(task)
    logger.init_iter_logs()
    tp = Throughput()
    spd = getattr(train_step, "scan_steps", 1)
    it = train_loader.epoch(epoch, start_batch) if start_batch else train_loader.epoch(epoch)
    it = _progress(it, "Training", len(train_loader) - start_batch, progress)
    steps, calls, metrics, preempted, buf = 0, 0, None, False, []

    def dispatch(batches):
        nonlocal state, metrics, steps, calls
        dev = _put_batch(_stack_batches(batches) if spd > 1 else batches[0], device)
        state, metrics = train_step(state, dev["image"], dev["label"], dev["mask"], lr_factor,
                                    freeze_scale)
        logger.log_iter(metrics)
        tp.step(int(sum(b["mask"].sum() for b in batches)))
        # nkbx warns here for any unmasked step; only a BatchNorm sees the padding
        if (not all(b["mask"].all() for b in batches) and not getattr(train_step, "masked_bn",
                                                                       False)
                and getattr(train_step, "has_batchnorm", True)):
            _warn_unmasked_partial()
        if calls == 0:
            logger.log_images_if_needed(batches[0]["image"])
        steps += len(batches)
        calls += 1

    for batch in it:
        if preempt.requested():
            preempted = True
            break
        buf.append(batch)
        if len(buf) < spd:
            continue
        dispatch(buf)
        buf = []
        if progress and spd == 1 and hasattr(it, "set_postfix_str") and calls % 10 == 1:
            it.set_postfix_str(f"Loss: {float(_loss_of(metrics)):.4f}")
    if buf and not preempted:
        dispatch(buf)
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
