"""The training loop (counterpart of ``nkbx/train/trainer.py``), on one
card or data-parallel over ranks.

Each epoch: the backbone's freeze scale from ``backbone_state_policy`` and
the schedule's lr factor, a train epoch and a validation epoch, the epoch
metrics, ``metrics.csv``; then the best checkpoint by validation balanced
accuracy and the last one, full train state each, beside weights-only
``best.pt``/``last.pt``. A SIGTERM (:mod:`nkbx_torch.train.preempt`) saves
``last`` with a batch cursor and stops; ``resume_from`` continues from a
checkpoint, from the cursor's batch where it matches the checkpoint.

nkbx's train-step options come from the config as nkbx takes them
(trainer.py:121-141): ``mixup``, ``steps_per_dispatch`` (K steps a call),
``grad_accum_steps``, ``log_gradients``, ``model_ema_decay`` and
``bf16_master_weights`` (bf16 master parameters, moments and EMA shadow,
the checkpoints saving and restoring them as bf16). With EMA,
validation, the choice of the best epoch and ``best.pt``/``last.pt`` use the
EMA shadow. ``debug_nans`` raises FloatingPointError at the first step
whose loss or gradients are not finite (nkbx's ``jax_debug_nans``, which
``train.py`` turns on for this key). ``export_serving`` writes
``weights/best.nkbx`` and ``weights/last.nkbx`` at the end
(:func:`export_serving`).

Training spans every rank of the process group (nkbx's ``train.py``
spans every chip): a config's ``mesh = {"data": N}`` must name them all
(:mod:`nkbx_torch.parallel`), and one process trains alone. Under several
ranks the step keeps nkbx's global-batch semantics
(:mod:`nkbx_torch.train.engine`); rank 0's resume cursor and validation
accuracy are broadcast, the cursor records the rank count (a cursor of
another count replays its epoch), and rank 0 alone writes ``metrics.csv``,
the image grids, the checkpoints and the serving bundles. ``fsdp = True``
scatters the parameters, their moments and the EMA shadow over the mesh's
data ranks (:mod:`nkbx_torch.parallel.fsdp`; nkbx's ``state_shardings``),
every rank joining the gathers of validation, the checkpoints and the
serving bundles; it needs a mesh, as nkbx's does. A mesh ``model`` axis
larger than 1 raises by design (ROADMAP.md, A10b).
"""

from __future__ import annotations

import warnings

import torch

from nkbx_torch.logging import TrainLogger
from nkbx_torch.metrics import compute_metrics
from nkbx_torch.models.classifier import ClassificationModel
from nkbx_torch.parallel import A10B, collectives, mesh_from_cfg
from nkbx_torch.train import preempt
from nkbx_torch.train.checkpoint import (load_cursor, restore_train_state, save_checkpoint,
                                         save_weights)
from nkbx_torch.train.engine import (EpochCollector, build_eval_step, build_train_step,
                                     has_batchnorm, train_epoch, val_epoch)
from nkbx_torch.train.optim import backbone_state_factor, get_optimizer, get_scheduler
from nkbx_torch.train.state import FSDP_NEEDS_MESH, TrainState

def check_options(cfg):
    """Raise for a config option the port's trainer does not run: a mesh
    ``model`` axis larger than 1 (by design, A10b)."""
    mesh = cfg.get("mesh", None) or {}
    if int(mesh.get("model", 1) or 1) != 1:
        raise NotImplementedError(f"config option mesh={mesh!r}: {A10B}")


def train(model, train_loader, val_loader, criterion, comet_experiment, local_experiment, cfg,
          resume_from=None, mesh=None):
    """Run the training loop on the model's device; returns the final
    :class:`TrainState`. ``mesh`` defaults to every rank of the process
    group (the config's ``mesh`` must agree); the loaders must read the
    mesh's shares (``get_dataset(..., mesh=mesh)``), and every rank passes
    the same run directory."""
    check_options(cfg)
    fsdp = bool(cfg.get("fsdp", False))
    if mesh is None and fsdp:  # nkbx's rule (trainer.py:101-102)
        raise ValueError(FSDP_NEEDS_MESH)
    mesh = mesh if mesh is not None else mesh_from_cfg(cfg, default_all_devices=True)
    for name, loader in (("train", train_loader), ("val", val_loader)):
        shares = getattr(loader, "process_count", 1) * getattr(loader, "local_world", 1)
        if shares != mesh.data:
            raise ValueError(f"the {name} loader reads {shares} shares of each epoch, the mesh "
                             f"has {mesh.data} ranks: build it with get_dataset(..., mesh=mesh)")
    writer = collectives.rank() == 0  # rank 0 alone writes files
    model_path = local_experiment.path / "weights"
    classes = train_loader.dataset.classes
    train_logger = None
    if writer:
        train_logger = TrainLogger(cfg, comet_experiment, local_experiment, classes)
        train_logger.log_images_at_start(train_loader)

    bundle = get_optimizer(cfg.optimizer)
    schedule = get_scheduler(cfg.lr_policy)
    ema_decay = float(cfg.get("model_ema_decay", 0.0) or 0.0)
    # bf16_master_weights (nkbx's max-throughput opt-in): bf16 master
    # parameters, moments and EMA shadow; the running statistics stay f32
    master_dtype = torch.bfloat16 if cfg.get("bf16_master_weights", False) else None
    state = TrainState.create(model, seed=cfg.get("seed", 0), ema=ema_decay > 0,
                              master_dtype=master_dtype, mesh=mesh, fsdp=fsdp)
    if state.scattered and writer:
        scat = state.scattered[0]
        print(f"[nkbx_torch] fsdp: {len(scat.params)} of {len(scat.shapes)} parameters "
              f"scattered over {mesh.data} ranks; the state at rest {state.nbytes() / 2**20:.1f} "
              "MiB a rank", flush=True)

    start_epoch, best_val_acc, resume_batch = 0, 0.0, 0
    if resume_from is not None:
        state, last_epoch, best_val_acc = restore_train_state(resume_from, state)
        start_epoch = last_epoch + 1
        cur = load_cursor(resume_from)
        if cur is not None:
            if (cur.get("step") == state.step and cur.get("epoch") == start_epoch
                    and cur.get("batch_size") == train_loader.batch_size
                    and cur.get("process_count") == mesh.data):
                resume_batch = int(cur["batch"])
            else:
                warnings.warn(f"preemption cursor at {resume_from} does not match the "
                              f"checkpoint or loader geometry ({cur}); replaying epoch "
                              f"{start_epoch} from its beginning")
        # every rank skips rank 0's prefix, whatever it read of the sidecar
        resume_batch = int(collectives.broadcast_object(resume_batch))
        if resume_batch and writer:
            print(f"[nkbx_torch] mid-epoch resume: epoch {start_epoch} continues at batch "
                  f"{resume_batch} (metrics for this epoch cover the remaining batches)")

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
        freeze_semantics=cfg.get("freeze_semantics", "decay"),
        debug_nans=bool(cfg.get("debug_nans", False)), mesh=mesh)
    # with EMA, validation and the saved weights are the shadow's
    eval_model = (ClassificationModel(state.ema_module, model.classes, model.task,
                                      model.emb_size, model.input_size, model.dtype,
                                      model.device)
                  if state.ema_module is not None else model)
    eval_step = build_eval_step(eval_model, criterion, augment_fn=augment_val, mesh=mesh)
    weights = state.ema_module if state.ema_module is not None else state.module

    freeze_scale = 1.0
    task = cfg.task
    policy = cfg.get("backbone_state_policy", {}) or {}
    metrics_mode = cfg.get("metrics_accumulation", "exact")
    for epoch in range(start_epoch, cfg.n_epochs):
        freeze_scale = backbone_state_factor(policy, epoch, prev=freeze_scale)
        state, train_results = train_epoch(
            state, train_loader, train_step, epoch, schedule(epoch), freeze_scale,
            epoch_logger=EpochCollector(task, metrics_mode, mesh), cfg=cfg,
            start_batch=resume_batch if epoch == start_epoch else 0)
        if train_results["preempted"]:
            save_checkpoint(model_path / "last", state, epoch - 1, best_val_acc, cursor={
                "epoch": epoch, "batch": int(train_results["consumed_batches"]),
                "step": state.step, "batch_size": train_loader.batch_size,
                "process_count": mesh.data})
            save_weights(model_path / "last.pt", weights, state)
            print(f"[nkbx_torch] preemption signal received during epoch {epoch}: full train "
                  f"state saved; resume with --resume {model_path / 'last'}")
            break
        val_results = val_epoch(state, val_loader, eval_step, epoch,
                                epoch_logger=EpochCollector(task, metrics_mode, mesh))
        train_results["metrics"] = compute_metrics(cfg, train_results)
        val_results["metrics"] = compute_metrics(cfg, val_results)
        # every rank computed the same metrics; the best-checkpoint decision
        # takes rank 0's, so that no rounding can part the ranks
        epoch_val_acc = collectives.broadcast_object(val_results["metrics"]["epoch_acc"])
        if writer:
            train_logger.log_epoch(epoch, train_results, val_results)
            local_experiment.log_metric("train images/sec/chip",
                                        train_results["throughput"]["images_per_sec_per_chip"],
                                        epoch=epoch)
        if epoch_val_acc is not None and epoch_val_acc > best_val_acc:
            best_val_acc = epoch_val_acc
            save_checkpoint(model_path / "best", state, epoch, best_val_acc)
            save_weights(model_path / "best.pt", weights, state)
        save_checkpoint(model_path / "last", state, epoch, best_val_acc)
        save_weights(model_path / "last.pt", weights, state)
        if preempt.agreed():
            print(f"[nkbx_torch] preemption signal received: stopping after epoch {epoch}; "
                  f"resume with --resume {model_path / 'last'}")
            break
    if cfg.get("export_serving", False):
        with state.gathered(weights):  # every rank joins; rank 0 exports
            if writer:
                export_serving(weights, model, val_loader, model_path)
    return state


def export_serving(weights, model, val_loader, model_path):
    """nkbx's ``export_serving`` (trainer.py:251-280): ``best.nkbx`` and
    ``last.nkbx`` under ``model_path``, at the val pipeline's static size
    and batch size, with a dynamic batch.

    Which weights: exactly those of ``best.pt`` and ``last.pt``, the EMA
    shadow when ``model_ema_decay > 0``, the weights that validation chose.
    (nkbx's ``best.nkbx`` restores the raw ``params`` of ``best/`` even with
    EMA on, while its ``best.msgpack`` holds the shadow; the port does not
    keep that asymmetry here.) ``weights`` is the module ``last.pt`` was
    saved from; without a ``best.pt`` a warning skips ``best.nkbx``."""
    import copy

    from nkbx_torch.export.bundle import export_model

    size = val_loader._out_hw
    if size is None:
        raise ValueError("export_serving requires a val pipeline with a static output size "
                         "(the exported program has static H, W)")
    shape = (val_loader.batch_size, *size, 3)

    def bundle(module, path):
        export_model(ClassificationModel(module, model.classes, model.task, model.emb_size,
                                         model.input_size, model.dtype, model.device),
                     shape, path)

    if (model_path / "best.pt").is_file():
        best = copy.deepcopy(weights)
        best.load_state_dict(torch.load(model_path / "best.pt", map_location=model.device))
        bundle(best, model_path / "best.nkbx")
    else:
        warnings.warn("export_serving: no best.pt in this run dir; skipping best.nkbx")
    bundle(weights, model_path / "last.nkbx")
