"""The port's training CLI, nkbx's ``train.py`` surface:

    python -m nkbx_torch.train -cfg CONFIG [--resume RUN/weights/last] [--device cpu]

The config is one of nkbx's Python config files (``import nkbx.transforms
as T`` builds the port's transforms). Training runs on the CUDA card unless
the config's ``device`` or ``--device`` names the CPU. A SIGTERM saves the
full train state with a batch cursor; ``--resume`` continues from it.

Data parallel, one rank a GPU (a config with ``distributed = True``; its
``mesh``, where given, must say ``{"data": N}``):

    python -m torch.distributed.run --nproc_per_node=N -m nkbx_torch.train -cfg CONFIG

Each rank takes ``cuda:LOCAL_RANK`` over NCCL; ``--device cpu`` (or
``cuda:0``, ranks sharing one card) runs the group over gloo
(:func:`nkbx_torch.core.runtime.initialize`). Rank 0 makes the run
directory and writes every file.

A config's ``experiment["comet"]`` section logs to Comet ML as nkbx does
(:func:`nkbx_torch.logging.get_comet_experiment`: without ``comet_ml``, a
warning and local logging only), with the config's, the classifier's and
the backbone's source files through ``log_code``. Under data parallelism
rank 0 alone builds the experiment, as it alone writes the files.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train arguments")
    parser.add_argument("-cfg", "--config", help="Config file path", type=str, required=True)
    parser.add_argument("--resume", type=str, default=None,
                        help="a checkpoint directory (weights/last) to resume from")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu; overrides the config's device")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[nkbx_torch] %(message)s")

    import torch

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging import get_comet_experiment, get_local_experiment
    from nkbx_torch.logging.experiment import LocalExperiment
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import collectives, mesh_from_cfg
    from nkbx_torch.train import get_loss, preempt
    from nkbx_torch.train.trainer import check_options, train
    from nkbx_torch.utils import load_config

    cfg = load_config(args.config)
    check_options(cfg)
    distributed = bool(cfg.get("distributed", False))
    if not distributed and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(f"launched as one of {os.environ['WORLD_SIZE']} ranks, but the "
                           "config does not say distributed = True")
    info = initialize(distributed, args.device or cfg.device)
    device = info["device"]
    mesh = mesh_from_cfg(cfg, default_all_devices=True)  # training spans every rank
    if cfg.get("preempt_checkpoint", True):
        preempt.install()

    train_loader = get_dataset(cfg.train_data, cfg.train_pipeline, mesh=mesh)
    classes = train_loader.dataset.classes
    if "classes" not in cfg.val_data:
        cfg.val_data = {**cfg.val_data, "classes": classes}
    val_loader = get_dataset(cfg.val_data, cfg.val_pipeline, mesh=mesh)
    print(f"[nkbx_torch] rank {info['rank']} of {mesh.data}: backend {info['backend']}, "
          f"device {device}; loader decoder: {train_loader.decoder}", flush=True)

    dtype = torch.bfloat16 if cfg.enable_mixed_precision else torch.float32
    input_size = cfg.train_pipeline.output_size() or (224, 224)
    model = get_model(cfg.model, classes, input_size=input_size, seed=cfg.get("seed", 0),
                      dtype=dtype, device=device)
    criterion = get_loss(cfg.criterion, device=device)
    comet_experiment = (get_comet_experiment(cfg.experiment.get("comet"))
                        if collectives.rank() == 0 else None)
    if comet_experiment is not None:  # the model's source beside the config (train.py:73-83)
        import importlib

        import nkbx_torch.models.classifier as classifier_mod

        comet_experiment.log_code(args.config)
        comet_experiment.log_code(classifier_mod.__file__)
        backbone_mod = type(model.module.backbone).__module__
        comet_experiment.log_code(importlib.import_module(backbone_mod).__file__)
    # rank 0 makes the run directory; every rank works in it
    local_experiment = (get_local_experiment(cfg.experiment["local"])
                        if collectives.rank() == 0 else None)
    path = collectives.broadcast_object(str(local_experiment.path) if local_experiment else None)
    if local_experiment is None:
        local_experiment = LocalExperiment(path)
    else:
        print(f"Run dir: {local_experiment.path}", flush=True)
    try:
        train(model, train_loader, val_loader, criterion, comet_experiment, local_experiment,
              cfg, resume_from=args.resume, mesh=mesh)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
