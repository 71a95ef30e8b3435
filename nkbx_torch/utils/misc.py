"""Small helpers (counterpart of ``nkbx/utils/misc.py``)."""

from __future__ import annotations

import numpy as np


def convert_dict_types_recursive(d):
    """ndarray / tensor / numpy scalar -> plain Python, in place, for JSON
    dumps (nkbx misc.py:20-32)."""
    for key in d:
        v = d[key]
        if isinstance(v, dict):
            d[key] = convert_dict_types_recursive(v)
        elif isinstance(v, np.ndarray):
            d[key] = v.tolist()
        elif isinstance(v, (np.floating, np.integer)):
            d[key] = v.item()
        elif hasattr(v, "__array__") and not isinstance(v, (list, str, float, int, bool,
                                                             type(None))):
            d[key] = np.asarray(v).tolist()
    return d
