"""The port's export CLI, nkbx's ``export.py`` surface:

    python -m nkbx_torch.export -cfg CONFIG --to serving -w RUN/weights/best.pt
        [--dynamic none|batch|all] [--input-shape B H W C] [--save_path DIR]
        [--half] [--fused-attention] [--device cpu] [-v]

Formats (``--to``):

- ``serving``: a ``.nkbx`` bundle, nkbx's metadata and a ``torch.export``
  program (:mod:`nkbx_torch.export.bundle`) for
  :class:`~nkbx_torch.export.ServingModule`; ``--dynamic`` as in nkbx;
  ``--fused-attention`` keeps the forward kernels in the program as
  registered ops and needs ``--dynamic none`` (a static batch);
- ``torchscript``: the reference's ``.pt`` (``torch.jit.trace``, NCHW);
- ``onnx``: ``.onnx`` where the ``onnx`` package is installed
  (``--opset``, ``--sim``).

``stablehlo``, ``savedmodel`` and ``tflite`` (and ``--quantize``, TFLite's)
are JAX lowerings and raise. ``-w`` takes what ``get_model``'s
``checkpoint`` takes: a port ``best.pt``, a port checkpoint directory or a
nkbx ``.msgpack``. The classes come from the config's train dataset, as in
nkbx. The model is traced (and a bundle served) on ``--device``, by default
the config's device, else the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

NO_COUNTERPART = {
    "stablehlo": "--to stablehlo has no counterpart in nkbx_torch: StableHLO is JAX's "
                 "lowering; --to serving writes the torch.export program.",
    "savedmodel": "--to savedmodel has no counterpart in nkbx_torch: a TF SavedModel comes "
                  "from jax2tf; use --to onnx or --to torchscript.",
    "tflite": "--to tflite has no counterpart in nkbx_torch: the TFLite flatbuffer comes "
              "from jax2tf; use --to onnx or --to torchscript.",
}
FORMATS = ("serving", "torchscript", "onnx")


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="nkbx_torch export")
    parser.add_argument("-cfg", "--config", type=str, required=True, help="Config file path")
    parser.add_argument("--to", type=str, required=True,
                        help="serving (.nkbx bundle, torch.export) | torchscript (.pt) | onnx")
    parser.add_argument("-w", "--weights", type=str, required=True,
                        help="a port best.pt, a port checkpoint directory or a nkbx .msgpack")
    parser.add_argument("--dynamic", type=str, default="batch", choices=("batch", "none", "all"),
                        help="none | batch | all (all = symbolic H/W too, CNN backbones only)")
    parser.add_argument("--input-shape", nargs=4, type=int, default=[32, 224, 224, 3],
                        help="B H W C (NHWC; B = max batch for a dynamic export)")
    parser.add_argument("--save_path", type=str, default=".", help="Save dir")
    parser.add_argument("--half", type=str2bool, nargs="?", const=True, default=False,
                        help="bf16 program input")
    parser.add_argument("--quantize", type=str, default=None,
                        help="tflite only: no counterpart in the port")
    parser.add_argument("--opset", type=int, default=17, help="onnx only: ONNX opset version")
    parser.add_argument("--fused-attention", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="serving only: keep the forward kernels (window attention, "
                             "attention, the fused MLPs) in the bundle as registered ops; "
                             "requires --dynamic none")
    parser.add_argument("--sim", action="store_true",
                        help="onnx only: run onnxsim on the exported model if installed")
    parser.add_argument("--device", type=str, default=None,
                        help="where the model is traced: cuda (the default) or cpu")
    parser.add_argument("-v", "--verbose", type=str2bool, nargs="?", const=True,
                        default=False, help="print export metadata and artifact sizes")
    args = parser.parse_args(argv)
    if args.to in NO_COUNTERPART:
        raise NotImplementedError(NO_COUNTERPART[args.to])
    if args.to not in FORMATS:
        parser.error(f"--to must be one of {FORMATS}, got {args.to!r}")
    if args.quantize is not None:
        raise NotImplementedError("--quantize has no counterpart in nkbx_torch: it is the "
                                  "TFLite route's int8 quantization.")
    if args.fused_attention and (args.to != "serving" or args.dynamic != "none"):
        parser.error("--fused-attention applies to --to serving with --dynamic none")
    return args


def main(args):
    import torch

    from nkbx_torch.core.runtime import resolve_device
    from nkbx_torch.data import get_dataset
    from nkbx_torch.models import get_model
    from nkbx_torch.utils import load_config

    print(f"Export to {args.to}")
    if args.sim and args.to != "onnx":
        print("NOTE: --sim applies to --to onnx only")
    cfg = load_config(args.config)
    device = resolve_device(args.device or cfg.device)
    # the classes come from the train dataset, as in the reference (export.py:106-109)
    classes = get_dataset(cfg.train_data, cfg.train_pipeline).dataset.classes
    model_cfg = dict(cfg.model, pretrained=False, checkpoint=args.weights)
    b, h, w, c = args.input_shape
    compute = torch.bfloat16 if cfg.enable_mixed_precision else torch.float32
    model = get_model(model_cfg, classes, input_size=(h, w), seed=cfg.get("seed", 0),
                      dtype=compute, device=device)

    stem = Path(args.weights).stem or "model"
    save_dir = Path(args.save_path)
    save_dir.mkdir(parents=True, exist_ok=True)
    exp_name = cfg.experiment["local"]["path"] if cfg.get("experiment") else "nkbx"

    from nkbx_torch.export.bundle import export_model, make_metadata

    metadata = make_metadata(classes, args.input_shape, cfg.task,
                             description=f"nkbx classification model ({exp_name})")
    t0 = time.perf_counter()
    if args.to == "serving":
        path, _ = export_model(model, args.input_shape, save_dir / f"{stem}.nkbx",
                               metadata=metadata, dynamic=args.dynamic,
                               dtype=torch.bfloat16 if args.half else torch.float32,
                               fused_attention=args.fused_attention)
    elif args.to == "torchscript":
        from nkbx_torch.export.torchscript import export_torchscript

        path, _ = export_torchscript(model, save_dir / f"{stem}.pt", args.input_shape,
                                     metadata=metadata)
    else:
        from nkbx_torch.export.torchscript import export_onnx

        if args.dynamic == "all":
            print("WARNING: --to onnx supports dynamic BATCH only; H/W stay static")
        path, _ = export_onnx(model, save_dir / f"{stem}.onnx", args.input_shape,
                              metadata=metadata, dynamic_batch=args.dynamic != "none",
                              opset=args.opset, simplify=args.sim)
    print(f"{args.to} export success, saved as {path} ({time.perf_counter() - t0:.2f} s)")
    if args.verbose:
        print(json.dumps(metadata, indent=2, default=str))
        for p in sorted(save_dir.glob(f"{stem}*")):
            if p.is_file():
                print(f"  {p}  {p.stat().st_size / 1e6:.2f} MB")
    return path


if __name__ == "__main__":
    main(parse_args())
