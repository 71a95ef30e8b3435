"""TorchScript and ONNX artifacts of a port model (counterpart of
``nkbx/export/torch_onnx.py``'s two routes).

nkbx reaches these formats through a torch replica of its model with
reverse-converted weights; the port's model is a torch module already, so
both trace it directly. The artifact keeps the reference repo's contract:
an NCHW float32 input (the pipeline's normalised batch, channels first) and,
for a multi-task model, a tuple of logits in the sorted order of the
targets. Both trace under :func:`~nkbx_torch.ops.disable_fused`: a kernel is
a ctypes call, which a trace would record as a constant.

- :func:`export_torchscript` writes the ``.pt`` that the reference repo's
  ``scripted=True`` loads with ``torch.jit.load``, after holding the traced
  logits against the module's; the metadata rides in ``_extra_files`` as
  ``config.txt``, as the reference's export does.
- :func:`export_onnx` writes ``.onnx`` where the ``onnx`` package is
  importable, else raises naming it; its metadata goes to a JSON sidecar.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from nkbx_torch.ops import disable_fused


class _Nchw(nn.Module):
    """The model's module behind the reference's input contract: NCHW in,
    NHWC to the module; multi-task logits as a tuple in sorted target
    order."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, x):
        out = self.module(x.permute(0, 2, 3, 1))
        if isinstance(out, dict):
            return tuple(out[t] for t in sorted(out))
        return out


def _example(model, input_shape, seed=0):
    n, h, w, c = (int(v) for v in input_shape)
    x = np.random.default_rng(seed).normal(size=(max(n, 1), c, h, w)).astype(np.float32)
    return torch.from_numpy(x).to(model.device)


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def export_torchscript(model, out_path, input_shape, metadata=None, rtol: float = 1e-5):
    """``torch.jit.trace`` of ``model.module`` (eval mode, on its device) at
    ``input_shape`` (B, H, W, C; traced with B images in NCHW), written to
    ``out_path``; returns (path, metadata). Raises RuntimeError before
    writing when the traced logits differ from the module's by more than
    ``rtol`` of the largest."""
    wrap = _Nchw(model.module).eval()
    x = _example(model, input_shape)
    with disable_fused(), torch.no_grad():
        traced = torch.jit.trace(wrap, x, check_trace=False)
        want, got = _outputs(wrap(x)), _outputs(traced(x))
    for a, b in zip(got, want, strict=True):
        err = float((a.float() - b.float()).abs().max())
        if not err <= rtol * max(1.0, float(b.float().abs().max())):
            raise RuntimeError(f"the traced module's logits differ from the module's by {err}")
    meta = dict(metadata or {})
    meta.update({"exporter": "nkbx_torch", "layout": "NCHW"})
    out_path = Path(out_path)
    traced.save(str(out_path), _extra_files={"config.txt": json.dumps(meta)})
    return out_path, meta


def export_onnx(model, out_path, input_shape, metadata=None, dynamic_batch: bool = True,
                opset: int = 17, simplify: bool = False):
    """``torch.onnx.export`` of ``model.module`` (NCHW input ``images``,
    outputs ``output`` or the targets' names, a dynamic batch axis unless
    ``dynamic_batch`` is False) to ``out_path``, with the metadata in
    ``<out_path>.json``; returns (path, metadata). Needs the ``onnx``
    package; ``simplify`` runs ``onnxsim`` where it is installed."""
    try:
        import onnx
    except ImportError as e:
        raise ImportError("export_onnx needs the 'onnx' package, which is not installed "
                          "(nkbx_torch downloads nothing)") from e
    wrap = _Nchw(model.module).eval()
    x = _example(model, input_shape)
    names = sorted(model.classes) if model.task == "multi" else ["output"]
    axes = ({"images": {0: "batch"}, **{o: {0: "batch"} for o in names}}
            if dynamic_batch else None)
    out_path = Path(out_path)
    with disable_fused(), torch.no_grad():
        torch.onnx.export(wrap, (x,), str(out_path), opset_version=opset, input_names=["images"],
                          output_names=names, dynamic_axes=axes)
    if simplify:
        try:
            import onnxsim
        except ImportError:
            print("NOTE: --sim: onnxsim is not installed; the graph is written unsimplified")
        else:
            simplified, ok = onnxsim.simplify(onnx.load(str(out_path)))
            if ok:
                onnx.save(simplified, str(out_path))
    meta = dict(metadata or {})
    meta.update({"exporter": "nkbx_torch", "layout": "NCHW", "opset": opset,
                 "output_names": names})
    out_path.with_suffix(out_path.suffix + ".json").write_text(json.dumps(meta))
    return out_path, meta
