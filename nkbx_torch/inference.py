"""The port's folder-inference CLI, nkbx's ``inference.py`` surface:

    python -m nkbx_torch.inference -cfg CONFIG [--device cpu]

Labels every image of ``inference_data["folder_path"]`` (a flat folder)
with the config's model and writes ``save_path/inference_annotations.csv``:
a column per target (``target_column``, or ``target_names`` for ``task ==
"multi"``) holding class names from ``classes`` (a list, a per-target dict
or a ``classes.json`` path), then ``path``. Padded rows of the last batch
are dropped by the batch mask. The model is built as in
:mod:`nkbx_torch.eval`: from its name and ``checkpoint``, or with
``scripted: True`` the ``.nkbx`` bundle of ``checkpoint``. It runs on the
CUDA card unless the config's ``device`` or ``--device`` names the CPU.
With ``mesh = {"data": N}`` under torchrun every batch splits over the N
ranks, the predictions and paths are gathered, and rank 0 writes the CSV
(:mod:`nkbx_torch.eval` says how to launch it).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def inference(model, loader, classes, save_path, cfg, mesh=None):
    """Predict every batch of ``loader`` and write the annotations CSV (nkbx
    ``inference.inference``, inference.py:11-66). Under a ``mesh`` each
    rank predicts its rows of every batch; rank 0 gathers the predictions
    (rows) and paths (objects) in batch order and writes the CSV."""
    import torch

    from nkbx_torch.parallel import collectives
    from nkbx_torch.train.engine import build_predict_fn
    from nkbx_torch.utils import get_classes_configs

    _, idx_to_class = get_classes_configs(classes)
    task = cfg.task
    if task == "single":
        columns = [cfg.target_column]
    elif task == "multi":
        columns = list(cfg.target_names)
        if set(columns) != set(classes):
            raise ValueError(f"target_names {columns} and the classes' targets {sorted(classes)} "
                             "differ")
    else:
        raise ValueError(f"Unknown task {task!r}")
    augment = loader.pipeline.device_apply if loader.pipeline else None
    forward = build_predict_fn(model, augment_fn=augment)
    multi = mesh is not None and collectives.grouped()
    rows = []
    for batch in loader.epoch(0):
        preds = forward(torch.from_numpy(batch["image"]).to(model.device))
        valid, paths = batch["mask"], list(batch["path"])
        labels = ({t: preds[t].argmax(-1) for t in columns} if task == "multi"
                  else {None: preds.argmax(-1)})
        if multi:  # every rank's rows, in rank order
            labels = {t: collectives.all_gather_rows(v) for t, v in labels.items()}
            valid = collectives.all_gather_rows(torch.from_numpy(valid)).numpy()
            paths = [p for part in collectives.all_gather_object(paths) for p in part]
        if task == "single":
            cols = [[idx_to_class[int(i)] for i in labels[None].cpu().numpy()[valid]]]
        else:
            cols = [[idx_to_class[t][int(i)] for i in labels[t].cpu().numpy()[valid]]
                    for t in columns]
        cols.append([p for p, v in zip(paths, valid) if v])
        rows.extend(zip(*cols))
    if collectives.rank() != 0:
        return
    with open(Path(save_path, "inference_annotations.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns + ["path"])
        writer.writerows(rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inference arguments")
    parser.add_argument("-cfg", "--config", help="Config file path", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu; overrides the config's device")
    args = parser.parse_args(argv)

    import torch

    from nkbx_torch.data import get_inference_dataset
    from nkbx_torch.eval import check_options, finish, start
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import collectives
    from nkbx_torch.utils import load_classes, load_config

    cfg = load_config(args.config)
    check_options(cfg)
    device, mesh = start(cfg, args.device or cfg.device)
    loader = get_inference_dataset(cfg.inference_data, cfg.inference_pipeline, mesh=mesh)
    classes = load_classes(cfg.classes)
    dtype = torch.bfloat16 if cfg.enable_mixed_precision else torch.float32
    input_size = cfg.inference_pipeline.output_size() or (224, 224)
    model = get_model(cfg.model, classes, input_size=input_size, seed=cfg.get("seed", 0),
                      dtype=dtype, device=device)
    save_path = Path(cfg.save_path)
    if collectives.rank() == 0:
        save_path.mkdir(exist_ok=True, parents=True)
    inference(model, loader, classes, save_path, cfg, mesh)
    if collectives.rank() == 0:
        print(f"Wrote {save_path / 'inference_annotations.csv'}")
    finish(mesh)


if __name__ == "__main__":
    main()
