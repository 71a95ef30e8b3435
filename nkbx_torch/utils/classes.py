"""Class names: ``classes.json`` and index maps (counterpart of
``nkbx/utils/classes.py``). Classes are a list (single-task) or a
``{target_name: [class, ...]}`` dict (multi-task)."""

from __future__ import annotations

import json
from pathlib import Path


def save_classes(classes, save_path):
    if isinstance(classes, (list, dict)):
        with open(save_path, "w") as f:
            json.dump(classes, f)
    else:
        raise NotImplementedError(f"unknown classes config type {type(classes)}")


def load_classes(classes):
    """Pass a list or dict through, or load one from a JSON file path."""
    if isinstance(classes, (list, dict)):
        return classes
    if isinstance(classes, (str, Path)):
        with open(classes, "r") as f:
            return json.load(f)
    raise NotImplementedError(f"unknown classes config type {type(classes)}")


def get_classes_configs(classes):
    """(class_to_idx, idx_to_class) for a list or a per-target dict."""
    if isinstance(classes, list):
        class_to_idx = {cls: idx for idx, cls in enumerate(classes)}
        idx_to_class = {idx: cls for cls, idx in class_to_idx.items()}
        return class_to_idx, idx_to_class
    if isinstance(classes, dict):
        class_to_idx = {t: {cls: i for i, cls in enumerate(cs)} for t, cs in classes.items()}
        idx_to_class = {t: {i: cls for cls, i in m.items()} for t, m in class_to_idx.items()}
        return class_to_idx, idx_to_class
    raise NotImplementedError(f"unknown classes config type {type(classes)}")
