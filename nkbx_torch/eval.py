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
A ``mesh`` raises (ROADMAP.md A10).
"""

from __future__ import annotations

import argparse
import json
import types
from pathlib import Path


def check_options(cfg):
    """Raise for the config options of nkbx's eval and inference CLIs that
    the port does not run."""
    if cfg.get("mesh"):
        raise NotImplementedError(f"config option mesh={cfg.get('mesh')!r} is not ported to "
                                  "nkbx_torch yet (ROADMAP.md, A10)")


def evaluate(model, val_loader, criterion, cfg):
    """One evaluation epoch of ``model`` over ``val_loader`` and its metrics
    (nkbx ``eval.evaluate``, eval.py:11-23)."""
    from nkbx_torch.metrics import compute_metrics
    from nkbx_torch.train.engine import EpochCollector, build_eval_step, val_epoch

    augment = val_loader.pipeline.device_apply if val_loader.pipeline else None
    eval_step = build_eval_step(model, criterion, augment_fn=augment)
    mode = cfg.get("metrics_accumulation", "exact")
    state = types.SimpleNamespace(module=model.module)  # what val_epoch reads of a train state
    results = val_epoch(state, val_loader, eval_step, epoch_logger=EpochCollector(cfg.task, mode))
    return compute_metrics(cfg, results)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Eval arguments")
    parser.add_argument("-cfg", "--config", help="Config file path", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu; overrides the config's device")
    args = parser.parse_args(argv)

    import torch

    from nkbx_torch.core.runtime import resolve_device
    from nkbx_torch.data import get_dataset
    from nkbx_torch.models import get_model
    from nkbx_torch.train import get_loss
    from nkbx_torch.utils import convert_dict_types_recursive, load_config

    cfg = load_config(args.config)
    check_options(cfg)
    device = resolve_device(args.device or cfg.device)
    if "classes" not in cfg.val_data and cfg.val_data.get("type", "ImageFolder") != "ImageFolder":
        raise ValueError("val_data needs its classes (a list or a classes.json path) unless it "
                         "is an ImageFolder")
    val_loader = get_dataset(cfg.val_data, cfg.val_pipeline)
    classes = val_loader.dataset.classes
    dtype = torch.bfloat16 if cfg.enable_mixed_precision else torch.float32
    input_size = cfg.val_pipeline.output_size() or (224, 224)
    model = get_model(cfg.model, classes, input_size=input_size, seed=cfg.get("seed", 0),
                      dtype=dtype, device=device)
    metrics = evaluate(model, val_loader, get_loss(cfg.criterion, device=device), cfg)

    save_path = Path(cfg.save_path)
    save_path.mkdir(exist_ok=True, parents=True)
    with open(save_path / "metrics.json", "w") as f:
        json.dump(convert_dict_types_recursive(metrics), f)
    print(f"Wrote {save_path / 'metrics.json'}")


if __name__ == "__main__":
    main()
