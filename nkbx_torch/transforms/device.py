"""Device stage of the transform pipeline (counterpart of
``nkbx/transforms/device.py`` ``build_device_fn``): the random flips and
Normalize, fused as nkbx fuses them (device.py:715-721): the flips select on
the raw uint8 batch, and Normalize writes the compute dtype once."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nkbx_torch.transforms import spec as S

_FLIP_DIMS = {S.HorizontalFlip: 2, S.VerticalFlip: 1}  # NHWC: W is dim 2, H dim 1


def build_device_fn(transforms: Sequence[S.Transform]):
    """Return ``fn(batch, out_dtype=torch.float32, generator=None,
    gates=None)``: a uint8 NHWC batch through the flips in pipeline order,
    then ``(x − 255·mean) / (255·std)`` in f32, cast to ``out_dtype`` (the
    same arithmetic as nkbx's, device.py:708-733).

    The flips run when a ``generator`` is given (training): each draws one
    uniform number per sample from it, on the batch's device, and flips the
    samples whose number is under its ``p`` (nkbx device.py:74-83).
    ``gates`` instead hands in those decisions, one (B,) bool tensor per
    flip, so that a test can feed the gates nkbx drew. With neither, only
    Normalize runs (evaluation and serving)."""
    norm, flips = None, []
    for t in transforms:
        if isinstance(t, S.Normalize):
            norm = t
        elif type(t) in _FLIP_DIMS:
            flips.append(t)
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

    def device_fn(batch: torch.Tensor, out_dtype=torch.float32, generator=None, gates=None):
        dev = batch.device
        x = batch
        if gates is None and generator is not None:
            gates = [torch.rand(x.shape[0], generator=generator, device=dev) < t.p
                     for t in flips]
        if gates is not None:
            if len(gates) != len(flips):
                raise ValueError(f"{len(gates)} gates for {len(flips)} flips")
            for t, gate in zip(flips, gates):
                x = torch.where(gate.to(dev).view(-1, 1, 1, 1), x.flip(_FLIP_DIMS[type(t)]), x)
        if dev not in consts:
            consts[dev] = (torch.as_tensor(mean, device=dev), torch.as_tensor(std, device=dev))
        m, s = consts[dev]
        return ((x.float() - m) / s).to(out_dtype)

    return device_fn
