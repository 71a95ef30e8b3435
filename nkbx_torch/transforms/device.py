"""Device stage of the transform pipeline (counterpart of
``nkbx/transforms/device.py`` ``build_device_fn``), Normalize only so far."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nkbx_torch.transforms import spec as S


def build_device_fn(transforms: Sequence[S.Transform]):
    """Return ``fn(batch, out_dtype=torch.float32)``: a uint8 NHWC batch to
    ``(x − 255·mean) / (255·std)`` in f32, cast to ``out_dtype`` (the same
    arithmetic as nkbx's, device.py:708-733)."""
    norm = None
    for t in transforms:
        if isinstance(t, S.Normalize):
            norm = t
        elif t.stage != S.MARKER:
            raise NotImplementedError(
                f"Device transform {type(t).__name__} is not ported to nkbx_torch yet "
                "(ROADMAP.md, A9)")
    if norm is not None:
        mean = np.asarray(norm.mean, dtype=np.float32) * norm.max_pixel_value
        std = np.asarray(norm.std, dtype=np.float32) * norm.max_pixel_value
    else:
        mean = np.zeros(1, dtype=np.float32)
        std = np.ones(1, dtype=np.float32)
    consts = {}

    def device_fn(batch: torch.Tensor, out_dtype=torch.float32):
        dev = batch.device
        if dev not in consts:
            consts[dev] = (torch.as_tensor(mean, device=dev), torch.as_tensor(std, device=dev))
        m, s = consts[dev]
        return ((batch.float() - m) / s).to(out_dtype)

    return device_fn
