"""Transform specs and Compose (counterpart of ``nkbx/transforms/spec.py``),
with nkbx's names and parameters so that its config files run unchanged.

A pipeline splits into two stages, as in nkbx:

- the host stage, the geometry before the first device op (LongestMaxSize,
  SmallestMaxSize, PadIfNeeded, Resize, CenterCrop, RandomCrop): numpy per
  sample in the loader's threads (:mod:`nkbx_torch.transforms.host`), so
  that every batch has one static (H, W);
- the device stage, one batched function of the uint8 batch on its device:
  the random flips, RandomBrightnessContrast, HueSaturationValue,
  CoarseDropout, Rotate, ShiftScaleRotate, RandAugment, TrivialAugmentWide,
  MotionBlur, RandomShadow, RandomFog, RandomRain and Normalize
  (:mod:`nkbx_torch.transforms.device`).

Every device op of nkbx runs in the port. nkbx's own approximations of
albumentations are kept as they are, and so are the fields it leaves inert
(RandomFog's ``alpha_coef``; RandomRain's ``drop_width``, ``blur_value``
and ``rain_type``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

HOST = "host"
DEVICE = "device"
MARKER = "marker"


def _as_range(limit, symmetric=True) -> Tuple[float, float]:
    """Albumentations-style limit: scalar x -> (-x, x); a pair is sorted
    (nkbx spec.py:23-29)."""
    if isinstance(limit, (tuple, list)):
        lo, hi = float(limit[0]), float(limit[1])
        return (min(lo, hi), max(lo, hi))
    x = float(limit)
    return (-x, x) if symmetric else (0.0, x)


@dataclasses.dataclass
class Transform:
    stage = HOST


# --- host stage: geometry, per sample in the loader ------------------------------------


@dataclasses.dataclass
class LongestMaxSize(Transform):
    """Resize so the longest side equals ``max_size``, keeping aspect ratio."""

    max_size: int = 1024
    interpolation: int = 1  # cv2.INTER_LINEAR
    always_apply: bool = True
    p: float = 1.0
    stage = HOST

    def out_size(self, h, w):
        scale = self.max_size / max(h, w)
        return max(1, round(h * scale)), max(1, round(w * scale))


@dataclasses.dataclass
class SmallestMaxSize(Transform):
    max_size: int = 1024
    interpolation: int = 1
    always_apply: bool = True
    p: float = 1.0
    stage = HOST

    def out_size(self, h, w):
        scale = self.max_size / min(h, w)
        return max(1, round(h * scale)), max(1, round(w * scale))


@dataclasses.dataclass
class PadIfNeeded(Transform):
    """Center-pad to at least (min_height, min_width)."""

    min_height: int = 1024
    min_width: int = 1024
    border_mode: int = 0  # constant
    value: Union[int, Sequence[int]] = 0
    always_apply: bool = True
    p: float = 1.0
    stage = HOST


@dataclasses.dataclass
class Resize(Transform):
    height: int = 224
    width: int = 224
    interpolation: int = 1
    always_apply: bool = True
    p: float = 1.0
    stage = HOST


@dataclasses.dataclass
class CenterCrop(Transform):
    height: int = 224
    width: int = 224
    always_apply: bool = True
    p: float = 1.0
    stage = HOST


@dataclasses.dataclass
class RandomCrop(Transform):
    height: int = 224
    width: int = 224
    always_apply: bool = True
    p: float = 1.0
    stage = HOST


# --- device stage: the ported ops ------------------------------------------------------


@dataclasses.dataclass
class HorizontalFlip(Transform):
    p: float = 0.5
    stage = DEVICE


@dataclasses.dataclass
class VerticalFlip(Transform):
    p: float = 0.5
    stage = DEVICE


@dataclasses.dataclass
class Normalize(Transform):
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    max_pixel_value: float = 255.0
    p: float = 1.0
    always_apply: bool = True
    stage = DEVICE


@dataclasses.dataclass
class RandomBrightnessContrast(Transform):
    """img <- clip(img * alpha + beta * 255), alpha ~ U(1 + c_lo, 1 + c_hi),
    beta ~ U(b_lo, b_hi); with ``brightness_by_max`` False, beta scales the
    image's mean instead of 255."""

    brightness_limit: Union[float, Tuple[float, float]] = 0.2
    contrast_limit: Union[float, Tuple[float, float]] = 0.2
    brightness_by_max: bool = True
    p: float = 0.5
    stage = DEVICE

    def ranges(self):
        return _as_range(self.brightness_limit), _as_range(self.contrast_limit)


@dataclasses.dataclass
class HueSaturationValue(Transform):
    """Random shifts in cv2-uint8 HSV space (H in [0, 180), S and V in [0, 255])."""

    hue_shift_limit: Union[float, Tuple[float, float]] = 20
    sat_shift_limit: Union[float, Tuple[float, float]] = 30
    val_shift_limit: Union[float, Tuple[float, float]] = 20
    p: float = 0.5
    stage = DEVICE

    def ranges(self):
        return (_as_range(self.hue_shift_limit), _as_range(self.sat_shift_limit),
                _as_range(self.val_shift_limit))


@dataclasses.dataclass
class CoarseDropout(Transform):
    """Cut out between ``min_holes`` and ``max_holes`` random rectangles,
    filled with ``fill_value`` (pixel units, a scalar or one per channel).
    Hole sizes under 1.0 given as floats are fractions of the image's H/W,
    as in albumentations."""

    max_holes: int = 8
    min_holes: Optional[int] = None
    max_height: Union[int, float] = 8
    min_height: Optional[Union[int, float]] = None
    max_width: Union[int, float] = 8
    min_width: Optional[Union[int, float]] = None
    fill_value: Union[int, float, Sequence[float]] = 0
    p: float = 0.5
    stage = DEVICE

    def resolved(self, img_h: int, img_w: int):
        """(min_holes, max_holes, min_h, max_h, min_w, max_w) in pixels."""
        min_holes = self.max_holes if self.min_holes is None else self.min_holes
        min_h = self.max_height if self.min_height is None else self.min_height
        min_w = self.max_width if self.min_width is None else self.min_width

        def _px(v, dim):
            return float(v) * dim if isinstance(v, float) and v <= 1.0 else float(v)

        return (int(min_holes), int(self.max_holes), _px(min_h, img_h),
                _px(self.max_height, img_h), _px(min_w, img_w), _px(self.max_width, img_w))


@dataclasses.dataclass
class Rotate(Transform):
    """Random rotation by U(lo, hi) degrees about the image centre
    ((w − 1)/2, (h − 1)/2), bilinear; border ``"reflect101"`` (cv2's
    default) or ``"constant"`` filled with ``value`` (nkbx spec.py:200-213)."""

    limit: Union[float, Tuple[float, float]] = 90
    border_mode: str = "reflect101"
    value: float = 0.0
    p: float = 0.5
    stage = DEVICE

    def range(self):
        return _as_range(self.limit)


@dataclasses.dataclass
class ShiftScaleRotate(Transform):
    """Random affine about the centre: a shift of U(shift range)·(W, H), a
    scale of 1 + U(scale range), a rotation of U(rotate range) degrees,
    bilinear, with Rotate's border modes (nkbx spec.py:217-232)."""

    shift_limit: Union[float, Tuple[float, float]] = 0.0625
    scale_limit: Union[float, Tuple[float, float]] = 0.1
    rotate_limit: Union[float, Tuple[float, float]] = 45
    border_mode: str = "reflect101"
    value: float = 0.0
    p: float = 0.5
    stage = DEVICE

    def ranges(self):
        return (_as_range(self.shift_limit), _as_range(self.scale_limit),
                _as_range(self.rotate_limit))


@dataclasses.dataclass
class RandAugment(Transform):
    """torchvision's RandAugment: ``num_ops`` rounds of one op a sample from
    the 14-op table at ``magnitude`` (of ``num_magnitude_bins``), the affine
    ops through ``num_affine_grids`` grids the batch shares (nkbx's knob)."""

    num_ops: int = 2
    magnitude: int = 9
    num_magnitude_bins: int = 31
    num_affine_grids: int = 4
    p: float = 1.0
    stage = DEVICE


@dataclasses.dataclass
class TrivialAugmentWide(Transform):
    """torchvision's TrivialAugmentWide: one op a sample at a magnitude bin
    drawn per sample (per grid for the affine ops), the wide ranges."""

    num_magnitude_bins: int = 31
    num_affine_grids: int = 4
    p: float = 1.0
    stage = DEVICE


@dataclasses.dataclass
class MotionBlur(Transform):
    """A straight-line blur through the kernel centre at a random angle, of
    an odd length from :meth:`ksizes` (nkbx spec.py:286-309: nkbx's raster
    of a centred line, not cv2.line's). ``allow_shifted`` lets the line sit
    off the centre inside the drawn k x k box, as albumentations does."""

    blur_limit: Union[int, Tuple[int, int]] = 7
    allow_shifted: bool = True
    p: float = 0.5
    stage = DEVICE

    def __post_init__(self):
        if not self.ksizes():
            raise ValueError(
                f"MotionBlur(blur_limit={self.blur_limit!r}) contains no odd kernel size >= 3")

    def ksizes(self):
        """The odd kernel sizes >= 3 up to ``blur_limit`` (or in its pair)."""
        lim = self.blur_limit
        lo, hi = (3, lim) if isinstance(lim, int) else lim
        return [k for k in range(lo, hi + 1) if k % 2 == 1 and k >= 3]


@dataclasses.dataclass
class RandomShadow(Transform):
    """Darken ``num_shadows_lower``..``num_shadows_upper`` random regions
    centred in ``shadow_roi`` by ``shadow_intensity``. As in nkbx
    (spec.py:313), the regions are rotated rectangles, not albumentations'
    polygons."""

    shadow_roi: Tuple[float, float, float, float] = (0.0, 0.5, 1.0, 1.0)
    num_shadows_lower: int = 1
    num_shadows_upper: int = 2
    shadow_intensity: float = 0.5
    p: float = 0.5
    stage = DEVICE


@dataclasses.dataclass
class RandomFog(Transform):
    """Blend toward white haze: img·(1 − f) + 255·f, f ~ U(lower, upper).
    ``alpha_coef`` is accepted and unused, as in nkbx (spec.py:326)."""

    fog_coef_lower: float = 0.3
    fog_coef_upper: float = 1.0
    alpha_coef: float = 0.08
    p: float = 0.5
    stage = DEVICE


@dataclasses.dataclass
class RandomRain(Transform):
    """Slanted streaks of ``drop_color`` and a darkening by
    ``brightness_coefficient``. As in nkbx (spec.py:337), the streaks are
    thresholded noise smeared ``drop_length`` rows along the slant;
    ``drop_width``, ``blur_value`` and ``rain_type`` are accepted and
    unused."""

    slant_lower: int = -10
    slant_upper: int = 10
    drop_length: int = 20
    drop_width: int = 1
    drop_color: Tuple[int, int, int] = (200, 200, 200)
    blur_value: int = 7
    brightness_coefficient: float = 0.7
    rain_type: Optional[str] = None
    p: float = 0.5
    stage = DEVICE


PORTED_DEVICE_OPS = (HorizontalFlip, VerticalFlip, RandomBrightnessContrast, HueSaturationValue,
                     CoarseDropout, Rotate, ShiftScaleRotate, RandAugment, TrivialAugmentWide,
                     MotionBlur, RandomShadow, RandomFog, RandomRain, Normalize)


@dataclasses.dataclass
class ToTensorV2(Transform):
    """Layout marker for API compatibility; the port keeps NHWC."""

    transpose_mask: bool = False
    stage = MARKER


class Compose:
    """A pipeline of transform specs split into a host stage (the geometry up
    to the first device op) and a device stage, one fused batched function
    of a uint8 NHWC batch (:meth:`device_apply`)."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = [t for t in transforms if t.stage != MARKER]
        split = next((i for i, t in enumerate(self.transforms) if t.stage == DEVICE),
                     len(self.transforms))
        self.host_transforms = self.transforms[:split]
        self.device_transforms = self.transforms[split:]
        for t in self.device_transforms:
            if t.stage == HOST:
                raise ValueError(
                    f"Host-stage transform {type(t).__name__} appears after a device-stage "
                    "transform; geometry must come before random photometric ops.")
            if not isinstance(t, PORTED_DEVICE_OPS):
                raise NotImplementedError(f"{type(t).__name__} is not a device op of nkbx "
                                          "(ROADMAP.md lists what the port runs)")
        seen_norm = False
        for t in self.device_transforms:
            if isinstance(t, Normalize):
                seen_norm = True
            elif seen_norm:
                raise ValueError(f"{type(t).__name__} appears after Normalize; the fused device "
                                 "stage applies Normalize last, so put random ops before it.")
        self._device_fn = None

    def host_apply(self, img: np.ndarray, rng: Optional[np.random.Generator] = None):
        """The host stage of one uint8 HWC image."""
        from nkbx_torch.transforms import host as H

        return H.apply_host(self.host_transforms, img, rng)

    def output_size(self, in_h: int = 1024, in_w: int = 768):
        """The static (H, W) the host stage gives every input, or None."""
        from nkbx_torch.transforms import host as H

        return H.infer_output_size(self.host_transforms, in_h, in_w)

    def device_apply(self, batch, out_dtype=None, generator=None, draws=None):
        """The device stage of a uint8 NHWC batch on its device: the random
        ops when a ``generator`` (training) or their ``draws`` are given (see
        :class:`nkbx_torch.transforms.device.DeviceStage`), then Normalize;
        float32 by default, or ``out_dtype`` (the model's compute dtype)
        straight out."""
        import torch

        return self.device_stage()(batch, torch.float32 if out_dtype is None else out_dtype,
                                   generator=generator, draws=draws)

    def device_stage(self):
        """The device stage as a :class:`~nkbx_torch.transforms.device.DeviceStage`."""
        from nkbx_torch.transforms.device import build_device_fn

        if self._device_fn is None:
            self._device_fn = build_device_fn(self.device_transforms)
        return self._device_fn
