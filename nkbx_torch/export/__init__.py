"""Serving and export (counterpart of ``nkbx/export/``): serving bundles
lowered with ``torch.export`` (:mod:`nkbx_torch.export.bundle`), the
bucket-padding :class:`ServingModule` and :class:`ExportedModel`
(:mod:`nkbx_torch.export.serving`), and TorchScript/ONNX
(:mod:`nkbx_torch.export.torchscript`). ``python -m nkbx_torch.export`` is
the export CLI, ``python -m nkbx_torch.export.serving`` the serving
benchmark. The names below import on first use, so that running a
submodule with ``-m`` finds it not yet imported."""

import importlib

_WHERE = {"export_model": "bundle", "load_exported": "bundle", "make_metadata": "bundle",
          "ExportedModel": "serving", "ServingModule": "serving", "default_buckets": "serving",
          "export_torchscript": "torchscript", "export_onnx": "torchscript"}

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
