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

Under a data-parallel ``mesh`` (:mod:`nkbx_torch.parallel`; one process a
GPU, each with its rows of the global batch) the step keeps nkbx's
global-batch semantics with explicit collectives: BatchNorm's statistics,
the device stage's draws and mixup's partners cover the global batch; each
normaliser of the loss is the global one, so each rank's loss is its rows'
share of the global loss; after the backward one sum of the gradients over
the ranks (:func:`~nkbx_torch.parallel.collectives.all_reduce_grads`); the
metrics' losses are the global ones on every rank, and the collectors
gather the per-sample metrics in nkbx's global row order. Every rank then
takes the same update. On a scattered state (``TrainState.create(...,
fsdp=True)``, :mod:`nkbx_torch.parallel.fsdp`) the step gathers the whole
parameters first, reduce-scatters the gradients in place of the
all-reduce, updates its shards and frees the whole parameters; the eval
step evaluates on gathered weights.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict

import numpy as np
import torch

from nkbx_torch.core.runtime import Throughput
from nkbx_torch.models.common import dropout_source
from nkbx_torch.parallel import collectives
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


def _masses(criterion, label, mask):
    """The normaliser of each term of the loss, (T,): the criterion's
    ``batch_mass``, per target for a multi-task loss (targets sorted)."""
    if isinstance(label, dict):
        inner = getattr(criterion, "criterion", None)
        fn = getattr(inner, "batch_mass", None)
        return torch.stack([(fn(label[t], mask) if fn is not None else mask.float().sum())
                            for t in sorted(label)]).float()
    fn = getattr(criterion, "batch_mass", None)
    return (fn(label, mask) if fn is not None else mask.float().sum()).reshape(1).float()


def _terms(loss_out, fn):
    """``loss_out`` with each term (the loss, or each target's, in sorted
    order) replaced by ``fn(i, term)``; a multi-task ``"loss"`` summed again
    in the criterion's order."""
    if not isinstance(loss_out, dict):
        return fn(0, loss_out)
    out, total = {}, 0.0
    for i, t in enumerate(sorted(k for k in loss_out if k != "loss")):
        out[t] = fn(i, loss_out[t])
        total = total + out[t]
    out["loss"] = total
    return out


def _rescale(loss_out, scale):
    """Each term of ``loss_out`` times its ``scale`` (T,)."""
    return _terms(loss_out, lambda i, term: term * scale[i])


def _global_scales(local):
    """local masses (..., T) -> this rank's share of each global mass: the
    factor that turns a rank's loss, normalised by its own mass, into its
    rows' share of the global batch's loss."""
    return local / torch.clamp(collectives.all_reduce_(local.clone()), min=1e-12)


def _loss_paths(metrics):
    return [(t,) for t in metrics if isinstance(metrics[t], dict) and "loss" in metrics[t]] \
        + [()]


def _sum_losses_(metrics):
    """The metrics' losses (each rank's share) summed over the ranks in
    place: the global batch's losses on every rank."""
    paths = _loss_paths(metrics)
    vals = [metrics[p[0]]["loss"] if p else metrics["loss"] for p in paths]
    flat = collectives.all_reduce_(torch.cat([v.reshape(-1).float() for v in vals]))
    for p, v, part in zip(paths, vals, flat.split([v.numel() for v in vals])):
        part = part.reshape(v.shape).to(v.dtype)
        if p:
            metrics[p[0]]["loss"] = part
        else:
            metrics["loss"] = part


def build_train_step(model, criterion, bundle: OptimizerBundle, augment_fn=None,
                     log_gradients: bool = False, masked_bn: bool = False, scan_steps: int = 1,
                     grad_accum_steps: int = 1, ema_decay: float = 0.0, mixup: dict = None,
                     freeze_semantics: str = "decay", debug_nans: bool = False, mesh=None):
    """Returns ``step(state, image_u8, label, mask, lr_factor, freeze_scale)
    -> (state, metrics)``, nkbx's train step (engine.py:83-295).

    ``augment_fn(image_u8, out_dtype=..., generator=...)`` is the device
    stage (``Compose.device_apply``): it receives the model's compute dtype
    and the state's generator. Every dropout mask of the forward is drawn
    from that generator too, after the device stage and mixup
    (:func:`~nkbx_torch.models.common.dropout_source`), so that a run is
    fixed by the state's seed. ``freeze_semantics`` is ``"decay"`` or
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

    ``mesh`` (a :class:`~nkbx_torch.parallel.Mesh`, in a process group of
    any size; without a group the step is the one-process step): the step
    is one rank's part of nkbx's step over the global batch (the
    module's docstring); the gradients in ``.grad`` are the global ones,
    the same on every rank, and so are the update, the running statistics,
    the EMA shadow, ``grad_norms`` and the metrics' losses. With
    ``grad_accum_steps`` the rows are first exchanged so that each rank
    holds its share of every global microbatch (nkbx's microbatch i is rows
    [i·B/A, (i+1)·B/A) of the global batch). ``debug_nans`` reads the summed
    gradients, so every rank raises together.

    Without ``debug_nans`` nothing in a step waits on a host value. nkbx's errors are raised where
    nkbx raises them: ``scan_steps`` with accumulation; A not dividing the
    batch; accumulation with a multi-task criterion that normalises by mass;
    mixup with accumulation and a criterion of non-uniform mass."""
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
    dp = mesh is not None and collectives.grouped()

    def forward_loss(x, label, mask, label_b, lam, scales=None):
        """``scales`` (2, T), data-parallel: each term's share of its global
        normaliser, for the labels and the partners' labels."""
        preds = module(x, mask=mask.reshape(-1, 1, 1, 1)) if masked_bn else module(x)
        loss_out = criterion(preds, label, mask=mask)
        if scales is not None:
            loss_out = _rescale(loss_out, scales[0])
        if label_b is not None:
            loss_b = criterion(preds, label_b, mask=mask)
            if scales is not None:
                loss_b = _rescale(loss_b, scales[1])
            loss_out = _tree_map(lambda a, b: lam * a + (1.0 - lam) * b, loss_out, loss_b)
        return preds, loss_out

    def step_scales(label, mask, label_b):
        """(2, T) shares of the global normalisers of a (micro)batch."""
        lb = label if label_b is None else label_b
        return _global_scales(torch.stack([_masses(criterion, label, mask),
                                           _masses(criterion, lb, mask)]))

    def relayout(x, label, mask, label_b):
        """Data-parallel accumulation: the rows exchanged so that this rank
        holds, for each microbatch i, rows i·B/A + r·b/A + [0, b/A) of the
        global batch (B = N·b), its share of nkbx's microbatch i."""
        b, n = x.shape[0], mesh.data
        if b % accum:
            raise ValueError(f"grad_accum_steps={accum} must divide each rank's batch of {b} "
                             f"rows ({n} ranks: each takes an equal share of every microbatch)")
        per, big = b // accum, n * b // accum
        idx = torch.cat([torch.arange(i * big + mesh.rank * per, i * big + (mesh.rank + 1) * per)
                         for i in range(accum)]).to(x.device)

        def move(v):
            return collectives.all_gather_rows(v)[idx]

        return (move(x), _tree_map(move, label), move(mask),
                _tree_map(move, label_b) if label_b is not None else None)

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
        scales = weights = None
        if dp:  # every microbatch's global normalisers and weight, in one all-reduce
            local = torch.stack([torch.stack([
                _masses(criterion, _tree_map(lambda v: v[i], ls), ms[i]),
                _masses(criterion, _tree_map(lambda v: v[i], lbs if lbs is not None else ls),
                        ms[i])]) for i in range(accum)])
            w = torch.stack([(criterion.batch_mass(_tree_map(lambda v: v[i], ls), ms[i])
                              if hasattr(criterion, "batch_mass") else ms[i].float().sum())
                             for i in range(accum)]).float()
            both = torch.cat([local.reshape(-1), w])
            glob = collectives.all_reduce_(both.clone())
            scales = local / torch.clamp(glob[:local.numel()].reshape(local.shape), min=1e-12)
            weights = glob[local.numel():]
        gsum, nsum, per = None, 0.0, []
        for i in range(accum):
            l_i = _tree_map(lambda v: v[i], ls)
            lb_i = _tree_map(lambda v: v[i], lbs) if lbs is not None else None
            module.zero_grad(set_to_none=True)
            preds, loss_out = forward_loss(xs[i], l_i, ms[i], lb_i, lam,
                                           scales[i] if dp else None)
            _scalar(loss_out).backward()
            with torch.no_grad():
                if dp:
                    n = weights[i]
                else:
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
        with collectives.data_parallel(mesh), state.gathered(module):
            return rank_step(state, image, label, mask, lr_factor, freeze_scale)

    def rank_step(state, image, label, mask, lr_factor, freeze_scale):
        module.train()
        x = (augment_fn(image, out_dtype=dtype, generator=state.generator)
             if augment_fn is not None else image)
        label_b = lam = None
        if mix is not None:
            # a padded row's partner is itself, which leaves the row unmixed
            if dp:  # the partners of this rank's rows: rank N-1-r's rows, reversed
                b, src = x.shape[0], mesh.data - 1 - mesh.rank

                def peer(v):
                    return collectives.all_gather_rows(v)[src * b:(src + 1) * b]

                x, lam, partner = mix(x, mask, generator=state.generator,
                                      peer=(peer(x), peer(mask)))
                label_b = _tree_map(lambda v: torch.cat([v, peer(v)])[partner], label)
            else:
                x, lam, partner = mix(x, mask, generator=state.generator)
                label_b = _tree_map(lambda v: v[partner], label)
        if dp and accum > 1:
            x, label, mask, label_b = relayout(x, label, mask, label_b)
        module.zero_grad(set_to_none=True)
        metrics = None
        # the dropout masks, drawn after the device stage's and mixup's draws
        with dropout_source(state.generator):
            if accum > 1:
                metrics = accumulate(x, label, mask, label_b, lam)
            else:
                scales = step_scales(label, mask, label_b) if dp else None
                preds, loss_out = forward_loss(x, label, mask, label_b, lam, scales)
                _scalar(loss_out).backward()
                with torch.no_grad():
                    metrics = _iter_metrics(_detach(preds), label, mask, _detach(loss_out))
        scat = state.scatter_of(module)
        if dp:
            with torch.no_grad():
                collectives.flush()  # the ghost groups' running statistics
                if scat is not None:
                    scat.scatter_grads()
                else:
                    collectives.all_reduce_grads(module.parameters())
                _sum_losses_(metrics)
        if debug_nans:
            check_finite(state.step, metrics["loss"], state.tensors())
        grads = apply_updates(bundle, state.opt_state, state.groups, lr_factor, freeze_scale,
                              freeze_semantics)
        with torch.no_grad():
            if ema_decay > 0 and state.ema_module is not None:
                state.update_ema(ema_decay)
            state.step += 1
            if log_gradients:
                metrics["grad_norms"] = grad_norms(state, grads)
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
    step.mesh = mesh
    return step


def grad_norms(state, grads) -> dict:
    """{flax path: f32 L2 norm} of ``grads`` ({label: [gradient]}, parallel
    to ``state.groups``), sorted by path: each norm taken in f64 and rounded
    once to f32. A shard's square is summed over the ranks, so that a
    scattered gradient's norm is its whole gradient's."""
    from nkbx_torch.models.convert import flax_param_path

    scat = state.scatter_of(state.module)
    keys, gs, shard = [], [], []
    for label, ts in state.groups.items():
        for name, t, g in zip(state.names[label], ts, grads.get(label, ())):
            keys.append(flax_param_path(name, t))
            gs.append(g)
            shard.append(scat is not None and scat.dim_of(t) is not None)
    if not gs:
        return {}
    norms = torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float64))
    if any(shard):
        mask = torch.tensor(shard, device=norms.device)
        sq = collectives.all_reduce_(torch.where(mask, norms.square(), 0.0))
        norms = torch.where(mask, sq.sqrt(), norms)
    return dict(sorted(zip(keys, norms.float().unbind())))


def check_finite(step: int, loss, params):
    """Raise FloatingPointError unless ``loss`` and every gradient of
    ``params`` are finite: one fused non-finite check a (device, dtype)
    group of tensors (``torch._amp_foreach_non_finite_check_and_unscale_``
    with a scale of 1, the loss in the gradients' group), then one read on
    the host, agreed over the ranks (each may check other shards)."""
    groups = {}
    for t in [p.grad for p in params if p.grad is not None] + [loss.detach().float().reshape(-1)]:
        groups.setdefault((t.device, t.dtype), []).append(t)
    found = None
    for (dev, _), ts in groups.items():
        inf = torch.zeros(1, device=dev)
        # the loss and the gradients are multiplied by 1 in place: unchanged
        torch._amp_foreach_non_finite_check_and_unscale_(ts, inf, torch.ones(1, device=dev))
        found = inf if found is None else found + inf.to(found.device)
    if collectives.agreed_any(found is not None and float(found) > 0):
        raise FloatingPointError(f"debug_nans: the loss or a gradient is not finite at train "
                                 f"step {step}")


def has_batchnorm(module) -> bool:
    """Whether the module holds a BatchNorm (whose batch statistics a padded
    batch would reach)."""
    from nkbx_torch.models.common import TorchBatchNorm

    return any(isinstance(m, TorchBatchNorm) for m in module.modules())


def build_eval_step(model, criterion, augment_fn=None, mesh=None):
    """Returns ``eval_step(state, image_u8, label, mask) -> metrics``: the
    device stage without random ops, the model in eval mode, the loss, and
    no gradients. Under a ``mesh`` (in a process group) the loss is the
    global batch's (one all-reduce of each term's mass-weighted loss and
    mass), the same on every rank."""
    module, dtype = model.module, model.dtype
    dp = mesh is not None and collectives.grouped()

    def eval_step(state, image, label, mask):
        with _gathered(state, module):
            return evaluate(image, label, mask)

    @torch.inference_mode()
    def evaluate(image, label, mask):
        module.eval()
        x = augment_fn(image, out_dtype=dtype) if augment_fn is not None else image
        preds = module(x)
        loss_out = criterion(preds, label, mask=mask)
        if dp:
            m = _masses(criterion, label, mask)
            terms = ([loss_out[t] for t in sorted(k for k in loss_out if k != "loss")]
                     if isinstance(loss_out, dict) else [loss_out])
            tot = collectives.all_reduce_(torch.cat([torch.stack(terms).float() * m, m]))
            glob = tot[:len(terms)] / torch.clamp(tot[len(terms):], min=1e-12)
            loss_out = _terms(loss_out, lambda i, term: glob[i])
        return _iter_metrics(preds, label, mask, loss_out)

    eval_step.module = module
    return eval_step


def _gathered(state, module):
    """``state.gathered(module)`` for a :class:`TrainState`; nothing for a
    state without scattered modules (the eval CLI's)."""
    gathered = getattr(state, "gathered", None)
    return gathered(module) if gathered is not None else contextlib.nullcontext()


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
    ``Gradients/Total``, the sum of a step's norms, one value per step.

    Under a ``mesh`` in a process group (each rank's steps hold its rows)
    the exact mode all-gathers the per-sample tensors at the epoch's end in
    nkbx's global row order, and the bounded mode sums the folded counts
    over the ranks: every rank computes the same metrics. Every rank must
    log the same number of steps (the loader pads every rank to it)."""

    def __init__(self, task: str = "single", mode: str = "exact", mesh=None):
        if mode not in ("exact", "bounded"):
            raise ValueError(f"Unknown metrics accumulation mode {mode!r}")
        self.task = task
        self.mode = mode
        self.mesh = mesh if mesh is not None and collectives.grouped() else None
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

    @staticmethod
    def _per_sample_paths(m):
        """The paths of a step's per-sample tensors (not its losses or
        gradient norms)."""
        keys = ("confidences", "predictions", "ground_truth")
        paths = [(t, k) for t, v in m.items() if isinstance(v, dict) and "confidences" in v
                 for k in keys]
        return paths + [(k,) for k in keys if k in m] + [("mask",)]

    def _gather_global(self, batches):
        """Every rank's per-sample tensors of each step, in the global batch's
        row order: this rank's rows hold rows ``rank·b + [0, b)`` of their
        axis (the mask's last), so a gather puts the ranks just before it.
        Tensors of one (path, shape, dtype) go in one all-gather."""
        def get(m, p):
            return m[p[0]][p[1]] if len(p) == 2 else m[p[0]]

        out = [{k: dict(v) if isinstance(v, dict) else v for k, v in m.items()}
               for m in batches]
        groups = defaultdict(list)
        for i, m in enumerate(batches):
            for p in self._per_sample_paths(m):
                t = get(m, p)
                groups[(p, tuple(t.shape), t.dtype)].append(i)
        n = self.mesh.data
        for (p, shape, _), idxs in groups.items():
            g = collectives.all_gather_rows(torch.stack([get(batches[i], p) for i in idxs])[None])
            axis = batches[idxs[0]]["mask"].dim() - 1
            for j, i in enumerate(idxs):
                v = g[:, j].movedim(0, axis)
                v = v.reshape(shape[:axis] + (n * shape[axis],) + shape[axis + 1:])
                if len(p) == 2:
                    out[i][p[0]][p[1]] = v
                else:
                    out[i][p[0]] = v
        return out

    def _bounded_results(self):
        from nkbx_torch.metrics import bounded_targetwise_metrics

        if self.mesh is not None:  # the counts of every rank's rows
            for st in self._bounded.values():
                for k in ("counts", "pos_hist", "neg_hist"):
                    collectives.all_reduce_(st[k])

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
        if self.mesh is not None:
            self._batches = self._gather_global(self._batches)
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
    remaining batches. ``device`` defaults to the module's.

    Under the step's data-parallel ``mesh`` (more than one rank) the ranks
    agree on preemption every ``cfg.preempt_sync_every`` batches (default 8;
    0: at the epoch's end only) with :func:`preempt.agreed`, so a SIGTERM to
    any rank stops every rank at the same batch, and the throughput counts
    the images of every rank over the ranks' cards."""
    from nkbx_torch.train import preempt

    device = next(state.module.parameters()).device if device is None else device
    task = getattr(cfg, "task", "single") if cfg is not None else "single"
    mesh = getattr(train_step, "mesh", None)
    multi = mesh is not None and mesh.data > 1
    logger = epoch_logger if epoch_logger is not None else EpochCollector(task, mesh=mesh)
    logger.init_iter_logs()
    tp = Throughput(n_chips=mesh.data if multi else 1)
    sync_every = int(getattr(cfg, "preempt_sync_every", 8) or 0) if cfg is not None else 8
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

    for bi, batch in enumerate(it):
        if (sync_every and bi % sync_every == 0 and preempt.agreed()) if multi \
                else preempt.requested():
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
    if multi:  # the images of every rank
        tp.add_images(collectives.sum_count(tp.images) - tp.images)
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
    returns the epoch's results. Under a mesh, give an ``epoch_logger``
    made with it, so that the results cover every rank's rows. A scattered
    model is gathered once for the epoch and freed after it."""
    device = next(state.module.parameters()).device if device is None else device
    logger = epoch_logger if epoch_logger is not None else EpochCollector(task)
    logger.init_iter_logs()
    it = _progress(val_loader.epoch(epoch), "Evaluating", len(val_loader), progress)
    with _gathered(state, getattr(eval_step, "module", None)):
        for i, batch in enumerate(it):
            dev = _put_batch(batch, device)
            logger.log_iter(eval_step(state, dev["image"], dev["label"], dev["mask"]))
            if i == 0:
                logger.log_images_if_needed(batch["image"])
    return logger.get_epoch_results()
