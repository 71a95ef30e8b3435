"""Python-module configs (counterpart of ``nkbx/utils/config.py``).

A config file declares module-level attributes (``task``, ``train_data``,
``train_pipeline``, ``model``, ``optimizer``, ``lr_policy``, ``criterion``,
``experiment``, ``n_epochs``, ...). :func:`load_config` runs it and wraps it
in a :class:`Config` view with nkbx's defaults, its alias of the typo'd
``enable_mixed_presicion`` key and its warning on near-misses of known keys.

nkbx's shipped configs say ``import nkbx.transforms as T``. While a config
runs, ``nkbx`` and ``nkbx.transforms`` in ``sys.modules`` resolve to
:mod:`nkbx_torch.transforms`, so the same files build the port's pipelines
unchanged; afterwards ``sys.modules`` holds exactly the ``nkbx`` entries it
held before (none, or the real package's in a process that imported it).
As in nkbx, the config's directory goes on the import path, so a config may
import a sibling module. Modules of that directory that hold transforms are
imported afresh while the config runs (so their ``nkbx.transforms`` is the
port's too) and leave ``sys.modules`` as they found it afterwards; the main
script and modules holding no transforms are not touched.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import sys
import types
from pathlib import Path

_DEFAULTS = {
    "device": None,  # None: the CUDA card
    "enable_mixed_precision": True,  # bf16 compute
    "compile": True,  # kept for config compatibility
    "log_gradients": False,
    "show_full_current_loss_in_terminal": False,
    "show_all_classes_in_confusion_matrix": False,
    "backbone_state_policy": {},
    "lr_policy": {},
    "n_epochs": 1,
    "seed": 0,
    "mesh": None,
}

# every knob an nkbx entry point reads; only near-misses of these are warned about
_KNOWN_KEYS = frozenset(_DEFAULTS) | {
    "enable_mixed_presicion", "experiment_name", "experiment", "task",
    "train_data", "val_data", "inference_data", "train_pipeline",
    "val_pipeline", "inference_pipeline", "model", "optimizer", "criterion",
    "target_names", "metrics_accumulation", "mixup", "model_ema_decay",
    "steps_per_dispatch", "grad_accum_steps", "fsdp", "export_serving",
    "enable_nan_debugging", "debug_nans", "save_path",
}


class Config:
    """Attribute view over a loaded config module (or a plain dict).

    A missing attribute falls back to the defaults; ``enable_mixed_presicion``
    is an alias of ``enable_mixed_precision`` both ways."""

    def __init__(self, source):
        if isinstance(source, dict):
            self._ns = dict(source)
        elif isinstance(source, types.ModuleType):
            self._ns = {k: v for k, v in vars(source).items() if not k.startswith("__")}
        elif isinstance(source, Config):
            self._ns = dict(source._ns)
        else:
            raise TypeError(f"Cannot build Config from {type(source)}")
        if "enable_mixed_presicion" in self._ns and "enable_mixed_precision" not in self._ns:
            self._ns["enable_mixed_precision"] = self._ns["enable_mixed_presicion"]
        if "enable_mixed_precision" in self._ns:
            self._ns.setdefault("enable_mixed_presicion", self._ns["enable_mixed_precision"])
        self._warn_near_miss_keys()

    def _warn_near_miss_keys(self):
        """Warn when a config name looks like a typo of a real knob (it would
        otherwise be read with its default and silently ignored)."""
        import difflib
        import warnings

        for key in self._ns:
            if key in _KNOWN_KEYS or not isinstance(key, str):
                continue
            close = difflib.get_close_matches(key, _KNOWN_KEYS, n=1, cutoff=0.75)
            prefix = [k for k in _KNOWN_KEYS if len(key) >= 5 and k.startswith(key) and k != key]
            hit = close or sorted(prefix)
            if hit:
                warnings.warn(
                    f"Config key {key!r} is not a known nkbx knob but is close "
                    f"to {hit[0]!r} — it would be silently ignored; did you "
                    f"mean {hit[0]!r}?")

    def __getattr__(self, name):
        ns = object.__getattribute__(self, "_ns")
        if name in ns:
            return ns[name]
        if name in _DEFAULTS:
            return _DEFAULTS[name]
        raise AttributeError(f"Config has no attribute {name!r}")

    def __contains__(self, name):
        """True only for keys the user set."""
        return name in self._ns

    _MISSING = object()

    def get(self, name, default=_MISSING):
        """User value > caller's explicit default > framework default."""
        if name in self._ns:
            return self._ns[name]
        if default is not Config._MISSING:
            return default
        return _DEFAULTS.get(name)

    def __setattr__(self, name, value):
        if name == "_ns":
            object.__setattr__(self, name, value)
        else:
            self._ns[name] = value

    def asdict(self):
        return dict(self._ns)

    def __repr__(self):
        return f"Config({sorted(self._ns)})"


def _is_nkbx(name: str) -> bool:
    return name == "nkbx" or name.startswith("nkbx.")


def _imported_from(name: str, module, folder: Path) -> bool:
    """True for a module imported with ``folder`` as its root on the import
    path (a sibling file or package of a config there), but the port's own
    and a script run as the main module."""
    f = getattr(module, "__file__", None)
    if not f or name in ("__main__", "__mp_main__") or name.split(".")[0] == "nkbx_torch":
        return False
    p = Path(f).resolve()
    if not p.is_relative_to(folder):
        return False
    return len(p.relative_to(folder).parts) == name.count(".") + 1 + (p.name == "__init__.py")


def _of_transforms(name) -> bool:
    return isinstance(name, str) and (_is_nkbx(name) or name == "nkbx_torch.transforms"
                                      or name.startswith("nkbx_torch.transforms."))


def _holds_transforms(value, depth: int = 2) -> bool:
    """True when ``value`` is, or in lists, tuples, sets and dicts up to
    ``depth`` levels holds, a module, class, function or object of nkbx or
    of the port's transforms."""
    if isinstance(value, types.ModuleType):
        return _of_transforms(value.__name__)
    if isinstance(value, (type, types.FunctionType)):
        return _of_transforms(value.__module__)
    if _of_transforms(type(value).__module__):
        return True
    if depth and isinstance(value, (list, tuple, set, frozenset)):
        return any(_holds_transforms(v, depth - 1) for v in value)
    if depth and isinstance(value, dict):
        return any(_holds_transforms(v, depth - 1) for v in value.values())
    return False


@contextlib.contextmanager
def _nkbx_transforms_resolve_to_port(folder: Path, config_name: str):
    """``nkbx`` and ``nkbx.transforms`` name the port's transforms inside
    the block. A module of the config's ``folder`` (but the config itself
    and the main script) that holds nkbx's or the port's transforms is
    imported anew there: a sibling that an nkbx load left in ``sys.modules``
    holds nkbx's objects. After the block every ``nkbx`` entry and every
    such module in ``sys.modules`` is as before; a module of ``folder``
    holding none of them is left alone, as nkbx's loader leaves it."""
    import nkbx_torch.transforms as port_transforms

    def ours(k, v):
        return _is_nkbx(k) or (k != config_name and _imported_from(k, v, folder) and any(
            _holds_transforms(x) for a, x in vars(v).items() if not a.startswith("__")))

    saved = {k: v for k, v in sys.modules.items() if ours(k, v)}
    for k in saved:
        del sys.modules[k]
    alias = types.ModuleType("nkbx", "nkbx's transforms, resolved to nkbx_torch.transforms")
    alias.transforms = port_transforms
    sys.modules["nkbx"], sys.modules["nkbx.transforms"] = alias, port_transforms
    try:
        yield
    finally:
        for k in [k for k, v in list(sys.modules.items()) if ours(k, v)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _run_config(path: Path, mod_name: str) -> types.ModuleType:
    folder = path.parent.resolve()
    if str(folder) not in sys.path:
        sys.path.append(str(folder))  # siblings import, as nkbx/utils/config.py:145-147
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module  # dataclasses and pickling inside configs resolve
    with _nkbx_transforms_resolve_to_port(folder, mod_name):
        spec.loader.exec_module(module)
    return module


def load_config(path) -> Config:
    """Run a Python config file and return it as a :class:`Config`."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    # a module name per file, so two configs that share a stem never alias
    digest = hashlib.md5(str(path.resolve()).encode()).hexdigest()[:8]
    return Config(_run_config(path, f"nkbx_torch_cfg_{path.stem}_{digest}"))


def read_py_config(path):
    """nkbx's reference-compatible helper: returns ``"import <stem> as
    cfg"`` for the caller to exec. The config is run here and registered
    under its stem, with its directory on the import path as nkbx's."""
    path = Path(path)
    _run_config(path, path.stem)
    return f"import {path.stem} as cfg"
