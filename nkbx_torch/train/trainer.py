"""The training loop (counterpart of ``nkbx/train/trainer.py``), on one
card.

Each epoch: the backbone's freeze scale from ``backbone_state_policy`` and
the schedule's lr factor, a train epoch and a validation epoch, the epoch
metrics, ``metrics.csv``; then the best checkpoint by validation balanced
accuracy and the last one, full train state each, beside weights-only
``best.pt``/``last.pt``. A SIGTERM (:mod:`nkbx_torch.train.preempt`) saves
``last`` with a batch cursor and stops; ``resume_from`` continues from a
checkpoint, from the cursor's batch where it matches the checkpoint.

nkbx's train-step options come from the config as nkbx takes them
(trainer.py:121-141): ``mixup``, ``steps_per_dispatch`` (K steps a call),
``grad_accum_steps``, ``log_gradients`` and ``model_ema_decay``. With EMA,
validation, the choice of the best epoch and ``best.pt``/``last.pt`` use the
EMA shadow. nkbx's other trainer options raise, naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import warnings

from nkbx_torch.logging import TrainLogger
from nkbx_torch.metrics import compute_metrics
from nkbx_torch.models.classifier import ClassificationModel
from nkbx_torch.train import preempt
from nkbx_torch.train.checkpoint import (load_cursor, restore_train_state, save_checkpoint,
                                         save_weights)
from nkbx_torch.train.engine import (EpochCollector, build_eval_step, build_train_step,
                                     has_batchnorm, train_epoch, val_epoch)
from nkbx_torch.train.optim import backbone_state_factor, get_optimizer, get_scheduler
from nkbx_torch.train.state import TrainState

# config keys of nkbx's trainer that the port does not run yet: (default, ROADMAP item)
UNPORTED = {
    "mesh": (None, "A10"),
    "fsdp": (False, "A10"),
    "distributed": (False, "A10"),
    "export_serving": (False, "A11"),
    "bf16_master_weights": (False, "A12"),
}


def check_options(cfg):
    """Raise for a config option the port's trainer does not run."""
    for key, (default, item) in UNPORTED.items():
        value = cfg.get(key, None)
        if value and value != default:
            raise NotImplementedError(f"config option {key}={value!r} is not ported to "
                                      f"nkbx_torch yet (ROADMAP.md, {item})")


def train(model, train_loader, val_loader, criterion, comet_experiment, local_experiment, cfg,
          resume_from=None):
    """Run the training loop on the model's device; returns the final
    :class:`TrainState`."""
    check_options(cfg)
    model_path = local_experiment.path / "weights"
    classes = train_loader.dataset.classes
    train_logger = TrainLogger(cfg, comet_experiment, local_experiment, classes)
    train_logger.log_images_at_start(train_loader)

    bundle = get_optimizer(cfg.optimizer)
    schedule = get_scheduler(cfg.lr_policy)
    ema_decay = float(cfg.get("model_ema_decay", 0.0) or 0.0)
    state = TrainState.create(model, seed=cfg.get("seed", 0), ema=ema_decay > 0)

    start_epoch, best_val_acc, resume_batch = 0, 0.0, 0
    if resume_from is not None:
        state, last_epoch, best_val_acc = restore_train_state(resume_from, state)
        start_epoch = last_epoch + 1
        cur = load_cursor(resume_from)
        if cur is not None:
            if (cur.get("step") == state.step and cur.get("epoch") == start_epoch
                    and cur.get("batch_size") == train_loader.batch_size
                    and cur.get("process_count") == 1):
                resume_batch = int(cur["batch"])
                print(f"[nkbx_torch] mid-epoch resume: epoch {start_epoch} continues at batch "
                      f"{resume_batch} (metrics for this epoch cover the remaining batches)")
            else:
                warnings.warn(f"preemption cursor at {resume_from} does not match the "
                              f"checkpoint or loader geometry ({cur}); replaying epoch "
                              f"{start_epoch} from its beginning")

    augment_train = train_loader.pipeline.device_apply if train_loader.pipeline else None
    augment_val = val_loader.pipeline.device_apply if val_loader.pipeline else None
    train_step = build_train_step(
        model, criterion, bundle, augment_fn=augment_train,
        log_gradients=bool(cfg.get("log_gradients", False)),
        # a padded last batch must not reach the BatchNorm statistics
        masked_bn=(not train_loader.drop_last) and has_batchnorm(model.module),
        scan_steps=int(cfg.get("steps_per_dispatch", 1) or 1),
        grad_accum_steps=int(cfg.get("grad_accum_steps", 1) or 1),
        ema_decay=ema_decay, mixup=cfg.get("mixup", None),
        freeze_semantics=cfg.get("freeze_semantics", "decay"))
    # with EMA, validation and the saved weights are the shadow's
    eval_model = (ClassificationModel(state.ema_module, model.classes, model.task,
                                      model.emb_size, model.input_size, model.dtype,
                                      model.device)
                  if state.ema_module is not None else model)
    eval_step = build_eval_step(eval_model, criterion, augment_fn=augment_val)
    weights = state.ema_module if state.ema_module is not None else state.module

    freeze_scale = 1.0
    task = cfg.task
    policy = cfg.get("backbone_state_policy", {}) or {}
    metrics_mode = cfg.get("metrics_accumulation", "exact")
    for epoch in range(start_epoch, cfg.n_epochs):
        freeze_scale = backbone_state_factor(policy, epoch, prev=freeze_scale)
        state, train_results = train_epoch(
            state, train_loader, train_step, epoch, schedule(epoch), freeze_scale,
            epoch_logger=EpochCollector(task, metrics_mode), cfg=cfg,
            start_batch=resume_batch if epoch == start_epoch else 0)
        if train_results["preempted"]:
            save_checkpoint(model_path / "last", state, epoch - 1, best_val_acc, cursor={
                "epoch": epoch, "batch": int(train_results["consumed_batches"]),
                "step": state.step, "batch_size": train_loader.batch_size, "process_count": 1})
            save_weights(model_path / "last.pt", weights)
            print(f"[nkbx_torch] preemption signal received during epoch {epoch}: full train "
                  f"state saved; resume with --resume {model_path / 'last'}")
            break
        val_results = val_epoch(state, val_loader, eval_step, epoch,
                                epoch_logger=EpochCollector(task, metrics_mode))
        train_results["metrics"] = compute_metrics(cfg, train_results)
        val_results["metrics"] = compute_metrics(cfg, val_results)
        epoch_val_acc = val_results["metrics"]["epoch_acc"]
        train_logger.log_epoch(epoch, train_results, val_results)
        local_experiment.log_metric("train images/sec/chip",
                                    train_results["throughput"]["images_per_sec_per_chip"],
                                    epoch=epoch)
        if epoch_val_acc is not None and epoch_val_acc > best_val_acc:
            best_val_acc = epoch_val_acc
            save_checkpoint(model_path / "best", state, epoch, best_val_acc)
            save_weights(model_path / "best.pt", weights)
        save_checkpoint(model_path / "last", state, epoch, best_val_acc)
        save_weights(model_path / "last.pt", weights)
        if preempt.agreed():
            print(f"[nkbx_torch] preemption signal received: stopping after epoch {epoch}; "
                  f"resume with --resume {model_path / 'last'}")
            break
    return state
