"""Serving bundles: a model's inference program lowered with ``torch.export``
(counterpart of ``nkbx/export/stablehlo.py``, where nkbx lowers to
StableHLO).

The bundle format is nkbx's:

    4-byte little-endian metadata length | JSON metadata | payload

where the payload is the bytes of ``torch.export.save`` and the metadata
carries nkbx's keys plus ``"format": "torch.export"``. The extension stays
``.nkbx``. The program takes what the model's module takes: the pipeline's
normalised NHWC batch in the export's dtype (nkbx's ``module.apply(variables,
x)``), and returns the logits (or {target: logits}).

By default the trace runs under :func:`~nkbx_torch.ops.disable_fused`: the
program holds plain PyTorch operations only, runs on any device and
launches none of the port's kernels. ``fused_attention=True`` (static shapes
only, as in nkbx) keeps the forward kernels in the program as the registered
ops ``nkbx_torch::window_attention``, ``::attention``, ``::ln_mlp`` and
``::mlp``; such a bundle loads after ``import nkbx_torch.ops``, which
:func:`load_exported` makes.
"""

from __future__ import annotations

import contextlib
import io
import json
from datetime import datetime
from pathlib import Path

import torch

FORMAT = "torch.export"
DYNAMIC = ("none", "batch", "all")


def make_metadata(classes, input_shape, task="single", description=""):
    """Model metadata: nkbx's keys (reference export.py:126-135) and
    ``format``, which marks the payload as ``torch.export``'s."""
    import nkbx_torch

    return {
        "description": description or "nkbx classification model",
        "author": "nkbx",
        "date": datetime.now().isoformat(),
        "version": nkbx_torch.__version__,
        "batch": input_shape[0],
        "imgsz": list(input_shape[1:3]),
        "layout": "NHWC",
        "task": task,
        "classes": classes,
        "format": FORMAT,
    }


def _pins_spatial_size(module) -> bool:
    """Whether the backbone fixes H and W (positional embeddings, windows):
    the ViT family and Swin, for which nkbx's ``dynamic='all'`` does not
    trace either."""
    from nkbx_torch.models.swin import SwinTransformer
    from nkbx_torch.models.vit import UnicomViT, ViT

    return isinstance(getattr(module, "backbone", module), (SwinTransformer, ViT, UnicomViT))


def export_model(model, input_shape, save_path, metadata=None, dynamic="batch",
                 dtype=torch.float32, spatial_multiple=32, fused_attention=False):
    """Export ``model.module`` (a :class:`~nkbx_torch.models.ClassificationModel`'s,
    in eval mode, on its device) to a ``.nkbx`` bundle; returns (path,
    metadata).

    ``input_shape`` is (B, H, W, C), B the largest batch the server pads to.
    ``dynamic``: ``"batch"`` makes the batch a ``torch.export.Dim``,
    ``"all"`` also H and W as ``spatial_multiple`` times a ``Dim`` (CNN
    backbones only: a ViT or Swin raises), ``"none"`` keeps every size
    static. ``fused_attention=True`` keeps the forward kernels in the
    program as registered ops (see the module docstring); it requires
    ``dynamic="none"``, as nkbx's does."""
    from torch.export import Dim

    from nkbx_torch.ops import disable_fused

    if dynamic not in DYNAMIC:
        raise ValueError(f"dynamic must be one of {DYNAMIC}, got {dynamic!r}")
    if fused_attention and dynamic != "none":
        raise ValueError("fused_attention export requires dynamic='none': the kernels' "
                         "launch geometry needs a concrete batch")
    module = model.module
    if dynamic == "all" and _pins_spatial_size(module):
        raise ValueError(f"dynamic='all' makes H and W symbolic, which only CNN backbones "
                         f"take; {type(getattr(module, 'backbone', module)).__name__} fixes its "
                         f"input size (use dynamic='batch')")
    b, h, w, c = (int(v) for v in input_shape)
    m = int(spatial_multiple)
    # a symbolic size traced at 1 would be specialised to 1: trace at 2 or more
    tb = b if dynamic == "none" else max(b, 2)
    th, tw = (h, w) if dynamic != "all" else (max(h // m, 2) * m, max(w // m, 2) * m)
    x = torch.zeros((tb, th, tw, c), dtype=dtype, device=model.device)
    dims = None
    if dynamic == "batch":
        dims = ({0: Dim("batch")},)
    elif dynamic == "all":
        dims = ({0: Dim("batch"), 1: m * Dim("h"), 2: m * Dim("w")},)

    was_training = module.training
    module.eval()
    try:
        with torch.no_grad(), (contextlib.nullcontext() if fused_attention
                               else disable_fused()):
            program = torch.export.export(module, (x,), dynamic_shapes=dims)
    finally:
        module.train(was_training)
    blob = io.BytesIO()
    torch.export.save(program, blob)

    meta = dict(metadata or make_metadata(model.classes, input_shape, model.task), format=FORMAT)
    if fused_attention:
        meta["fused_attention"] = True
    meta_bytes = json.dumps(meta).encode()
    save_path = Path(save_path)
    with open(save_path, "wb") as f:
        f.write(len(meta_bytes).to_bytes(4, byteorder="little", signed=True))
        f.write(meta_bytes)
        f.write(blob.getvalue())
    return save_path, meta


def read_metadata(path):
    """(metadata, offset of the payload) of a ``.nkbx`` file; a file that
    is not a bundle, or a StableHLO bundle written by nkbx, raises
    ValueError."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(4), byteorder="little", signed=True)
        try:
            if not 0 < n <= size - 4:
                raise ValueError
            meta = json.loads(f.read(n).decode())
        except ValueError:
            raise ValueError(f"{path} is not a .nkbx serving bundle (no metadata header)") from None
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is a StableHLO bundle written by nkbx's export (JAX), which "
                         "nkbx_torch cannot run; export the weights again with python -m "
                         "nkbx_torch.export --to serving")
    return meta, 4 + n


def load_exported(path, device=None):
    """Read a ``.nkbx`` bundle -> (metadata, ``torch.export.ExportedProgram``)
    with its parameters and constants on ``device`` (default ``cuda``; a
    program traced on one device keeps that device's constants, which
    ``move_to_device_pass`` moves)."""
    import nkbx_torch.ops  # noqa: F401  (registers the kernels' ops a fused bundle holds)
    from torch.export.passes import move_to_device_pass

    from nkbx_torch.core.runtime import resolve_device

    dev = resolve_device(device)
    meta, offset = read_metadata(path)
    with open(path, "rb") as f:
        f.seek(offset)
        program = torch.export.load(io.BytesIO(f.read()))
    return meta, move_to_device_pass(program, dev)
