"""Transform specs and Compose (counterpart of ``nkbx/transforms/spec.py``)
for the serving and training paths: the device stage is the random flips
and Normalize.

The host stage (geometry) and the other random device ops (photometric,
dropout, blur, ...) are not ported yet (ROADMAP.md, A9); a pipeline that
names one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

HOST = "host"
DEVICE = "device"
MARKER = "marker"


@dataclasses.dataclass
class Transform:
    stage = HOST


@dataclasses.dataclass
class Normalize(Transform):
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    max_pixel_value: float = 255.0
    p: float = 1.0
    always_apply: bool = True
    stage = DEVICE


@dataclasses.dataclass
class HorizontalFlip(Transform):
    p: float = 0.5
    stage = DEVICE


@dataclasses.dataclass
class VerticalFlip(Transform):
    p: float = 0.5
    stage = DEVICE


PORTED_DEVICE_OPS = (HorizontalFlip, VerticalFlip, Normalize)


@dataclasses.dataclass
class ToTensorV2(Transform):
    """Layout marker for API compatibility; the port keeps NHWC."""

    transpose_mask: bool = False
    stage = MARKER


class Compose:
    """A pipeline of transform specs; its device stage is one fused batched
    function of a uint8 NHWC batch (:meth:`device_apply`)."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = [t for t in transforms if t.stage != MARKER]
        for t in self.transforms:
            if not isinstance(t, PORTED_DEVICE_OPS):
                raise NotImplementedError(
                    f"{type(t).__name__} is not ported to nkbx_torch yet; the port's "
                    "device stage is HorizontalFlip, VerticalFlip and Normalize "
                    "(ROADMAP.md, A9)")
        seen_norm = False
        for t in self.transforms:
            if isinstance(t, Normalize):
                seen_norm = True
            elif seen_norm:
                raise ValueError(f"{type(t).__name__} appears after Normalize; the fused device "
                                 "stage applies Normalize last, so put random ops before it.")
        self.device_transforms = self.transforms
        self._device_fn = None

    def device_apply(self, batch, out_dtype=None, generator=None, gates=None):
        """The device stage of a uint8 NHWC batch on its device: the random
        flips when a ``generator`` (training) or the flips' ``gates`` are
        given, then Normalize; float32 by default, or ``out_dtype`` (the
        model's compute dtype) straight out."""
        import torch

        from nkbx_torch.transforms.device import build_device_fn

        if self._device_fn is None:
            self._device_fn = build_device_fn(self.device_transforms)
        return self._device_fn(batch, torch.float32 if out_dtype is None else out_dtype,
                               generator=generator, gates=gates)
