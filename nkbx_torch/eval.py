"""The port's evaluation CLI, nkbx's ``eval.py`` surface:

    python -m nkbx_torch.eval -cfg CONFIG [--device cpu]

Evaluates the model of the config's ``model`` on ``val_data`` /
``val_pipeline`` and writes ``save_path/metrics.json`` with nkbx's keys.
The model is built from its name with its ``checkpoint`` (a port
``best.pt``, a port checkpoint directory or a nkbx ``.msgpack``), or, with
``scripted: True``, is the ``.nkbx`` serving bundle named by
``checkpoint`` (:class:`~nkbx_torch.export.ExportedModel`: the pipeline's
normalised batch in the bundle's dtype, padded to its buckets). It runs on
the CUDA card unless the config's ``device`` or ``--device`` names the CPU.

With ``mesh = {"data": N}`` (opt-in, as in nkbx) the set spreads over N
ranks launched by torchrun (``python -m torch.distributed.run
--nproc_per_node=N -m nkbx_torch.eval -cfg CONFIG``): each rank evaluates
its rows of every batch, the metrics are gathered exactly, and rank 0
writes ``metrics.json``. Several ranks without a ``mesh`` raise; a mesh
``model`` axis larger than 1 raises by design (ROADMAP.md A10b).
"""

from __future__ import annotations

import argparse
import json
import os
import types
from pathlib import Path


def check_options(cfg):
    """Raise for the config options of nkbx's eval and inference CLIs that
    the port does not run: a mesh ``model`` axis larger than 1 (by design, A10b)."""
    from nkbx_torch.parallel.mesh import A10B

    mesh = cfg.get("mesh") or {}
    if int(mesh.get("model", 1) or 1) != 1:
        raise NotImplementedError(f"config option mesh={mesh!r}: {A10B}")


def start(cfg, device):
    """(device, mesh) of an eval or inference CLI: with a ``mesh`` this
    process's rank of torchrun's group (:func:`initialize`), else one
    process; several ranks without a ``mesh`` raise."""
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import mesh_from_cfg

    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if not cfg.get("mesh"):
        if ranks > 1:
            raise RuntimeError(f"launched as one of {ranks} ranks without a mesh: eval and "
                               "inference spread over ranks only with mesh = {'data': N}")
        return initialize(False, device)["device"], None
    info = initialize(ranks > 1, device)
    return info["device"], mesh_from_cfg(cfg)


def finish(mesh):
    """Leave the process group a CLI joined."""
    import torch.distributed as dist

    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def evaluate(model, val_loader, criterion, cfg, mesh=None):
    """One evaluation epoch of ``model`` over ``val_loader`` and its metrics
    (nkbx ``eval.evaluate``, eval.py:11-23); under a ``mesh`` over every
    rank's rows, the same on every rank."""
    from nkbx_torch.metrics import compute_metrics
    from nkbx_torch.train.engine import EpochCollector, build_eval_step, val_epoch

    augment = val_loader.pipeline.device_apply if val_loader.pipeline else None
    eval_step = build_eval_step(model, criterion, augment_fn=augment, mesh=mesh)
    mode = cfg.get("metrics_accumulation", "exact")
    state = types.SimpleNamespace(module=model.module)  # what val_epoch reads of a train state
    results = val_epoch(state, val_loader, eval_step,
                        epoch_logger=EpochCollector(cfg.task, mode, mesh))
    return compute_metrics(cfg, results)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Eval arguments")
    parser.add_argument("-cfg", "--config", help="Config file path", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu; overrides the config's device")
    args = parser.parse_args(argv)

    import torch

    from nkbx_torch.data import get_dataset
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import collectives
    from nkbx_torch.train import get_loss
    from nkbx_torch.utils import convert_dict_types_recursive, load_config

    cfg = load_config(args.config)
    check_options(cfg)
    if "classes" not in cfg.val_data and cfg.val_data.get("type", "ImageFolder") != "ImageFolder":
        raise ValueError("val_data needs its classes (a list or a classes.json path) unless it "
                         "is an ImageFolder")
    device, mesh = start(cfg, args.device or cfg.device)
    val_loader = get_dataset(cfg.val_data, cfg.val_pipeline, mesh=mesh)
    classes = val_loader.dataset.classes
    dtype = torch.bfloat16 if cfg.enable_mixed_precision else torch.float32
    input_size = cfg.val_pipeline.output_size() or (224, 224)
    model = get_model(cfg.model, classes, input_size=input_size, seed=cfg.get("seed", 0),
                      dtype=dtype, device=device)
    metrics = evaluate(model, val_loader, get_loss(cfg.criterion, device=device), cfg, mesh)

    if collectives.rank() == 0:
        save_path = Path(cfg.save_path)
        save_path.mkdir(exist_ok=True, parents=True)
        with open(save_path / "metrics.json", "w") as f:
            json.dump(convert_dict_types_recursive(metrics), f)
        print(f"Wrote {save_path / 'metrics.json'}")
    finish(mesh)


if __name__ == "__main__":
    main()
