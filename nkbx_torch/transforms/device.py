"""Device stage of the transform pipeline (counterpart of
``nkbx/transforms/device.py`` ``build_device_fn``): the random flips,
RandomBrightnessContrast, HueSaturationValue and CoarseDropout, then
Normalize, as plain elementwise PyTorch ops on the batch's device.

The chain keeps nkbx's order (device.py:694-733): the flips select on the
raw uint8 batch until the first photometric op, which casts to float32; each
photometric op clips to [0, 255] at its boundary; Normalize writes the
compute dtype once. HSV follows the cv2-uint8 convention (H in [0, 180), S
and V in [0, 255]). Padded (masked) rows are augmented like any other row;
the loss and the statistics weight them out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nkbx_torch.transforms import spec as S

_FLIP_DIMS = {S.HorizontalFlip: 2, S.VerticalFlip: 1}  # NHWC: W is dim 2, H dim 1


def _mod(a, b: float):
    """``jnp.mod``'s rule: fmod, plus ``b`` where the remainder is non-zero and
    its sign differs from ``b``'s (the result takes the divisor's sign)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


# --- colour space (cv2-uint8 convention, float math; nkbx device.py:34-61) -------------


def rgb_to_hsv(x):
    """RGB float [0, 255] (..., 3) -> (H in [0, 180), S in [0, 255], V in [0, 255])."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff == 0, 1.0, diff)
    h_r = _mod((g - b) / safe, 6.0)
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    h6 = torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b))
    h = torch.where(diff == 0, 0.0, h6 * 30.0)
    s = torch.where(mx > 0, 255.0 * diff / torch.where(mx == 0, 1.0, mx), 0.0)
    return h, s, mx


def hsv_to_rgb(h, s, v):
    """Inverse of :func:`rgb_to_hsv`; sector 5 takes ``jnp.select``'s
    defaults (r = c, g = 0, b = xm)."""
    h6 = h / 30.0
    c = v * (s / 255.0)
    xm = c * (1.0 - torch.abs(_mod(h6, 2.0) - 1.0))
    m = v - c
    sector = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    zero = torch.zeros_like(c)
    # (r, g, b) of sectors 0-4; sector 5 is the default
    table = ((c, xm, zero), (xm, c, zero), (zero, c, xm), (zero, xm, c), (xm, zero, c))
    r, g, b = c, zero, xm
    for k in range(4, -1, -1):
        hit = sector == k
        r, g, b = (torch.where(hit, t, o) for t, o in zip(table[k], (r, g, b)))
    return torch.stack([r + m, g + m, b + m], dim=-1)


# --- the per-op draws --------------------------------------------------------------


def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def draw(t: S.Transform, shape, generator: torch.Generator, device) -> dict:
    """One random op's draws for a batch of ``shape`` (B, H, W, C), from
    ``generator`` on ``device``, in this order: ``gate`` (B uniforms under
    ``p``), then the op's own: brightness/contrast ``alpha`` (1 + U(c_lo,
    c_hi)) and ``beta`` (U(b_lo, b_hi)); HSV ``dh``, ``ds``, ``dv``; coarse
    dropout ``n_holes`` (an integer in [min_holes, max_holes]), the hole
    heights ``hh`` and widths ``ww`` (floors of U(min, max)), then the top
    rows ``y1`` and left columns ``x1`` (floors of U(0, 1)·max(H − hh, 1),
    and of W), each (B, max_holes)."""
    b, ih, iw = shape[0], shape[1], shape[2]
    out = {"gate": torch.rand(b, generator=generator, device=device) < t.p}
    if isinstance(t, S.RandomBrightnessContrast):
        (b_lo, b_hi), (c_lo, c_hi) = t.ranges()
        out["alpha"] = 1.0 + _uniform(b, c_lo, c_hi, generator, device)
        out["beta"] = _uniform(b, b_lo, b_hi, generator, device)
    elif isinstance(t, S.HueSaturationValue):
        for key, (lo, hi) in zip(("dh", "ds", "dv"), t.ranges()):
            out[key] = _uniform(b, lo, hi, generator, device)
    elif isinstance(t, S.CoarseDropout):
        min_holes, max_holes, min_h, max_h, min_w, max_w = t.resolved(ih, iw)
        n = (b, max_holes)
        out["n_holes"] = torch.randint(min_holes, max_holes + 1, (b,), generator=generator,
                                       device=device)
        out["hh"] = torch.floor(_uniform(n, min_h, max_h, generator, device))
        out["ww"] = torch.floor(_uniform(n, min_w, max_w, generator, device))
        out["y1"] = torch.floor(torch.rand(n, generator=generator, device=device)
                                * torch.clamp(ih - out["hh"], min=1.0))
        out["x1"] = torch.floor(torch.rand(n, generator=generator, device=device)
                                * torch.clamp(iw - out["ww"], min=1.0))
    return out


# --- the per-op appliers (nkbx device.py:86-146); x is f32 NHWC in [0, 255] -----------


def _col(v):
    return v.reshape(-1, 1, 1, 1)


def _apply_brightness_contrast(t: S.RandomBrightnessContrast, x, d):
    alpha, beta = _col(d["alpha"]), _col(d["beta"])
    if t.brightness_by_max:
        y = x * alpha + beta * 255.0
    else:  # brightness relative to the image's mean, as albumentations does
        y = x * alpha + beta * x.mean(dim=(1, 2, 3), keepdim=True)
    return torch.where(_col(d["gate"]), torch.clamp(y, 0.0, 255.0), x)


def _apply_hsv(t: S.HueSaturationValue, x, d):
    shift = {k: d[k].reshape(-1, 1, 1) for k in ("dh", "ds", "dv")}
    h, s, v = rgb_to_hsv(x)
    h = _mod(h + shift["dh"], 180.0)
    s = torch.clamp(s + shift["ds"], 0.0, 255.0)
    v = torch.clamp(v + shift["dv"], 0.0, 255.0)
    y = torch.clamp(hsv_to_rgb(h, s, v), 0.0, 255.0)
    return torch.where(_col(d["gate"]), y, x)


def _apply_coarse_dropout(t: S.CoarseDropout, x, d):
    _, ih, iw, c = x.shape
    dev = x.device
    hh, ww, y1, x1 = (d[k][:, :, None, None] for k in ("hh", "ww", "y1", "x1"))  # (B, n, 1, 1)
    rows = torch.arange(ih, dtype=torch.float32, device=dev).view(1, 1, ih, 1)
    cols = torch.arange(iw, dtype=torch.float32, device=dev).view(1, 1, 1, iw)
    holes = (rows >= y1) & (rows < y1 + hh) & (cols >= x1) & (cols < x1 + ww)  # (B, n, H, W)
    active = torch.arange(hh.shape[1], device=dev)[None, :] < d["n_holes"][:, None]
    mask = (holes & active[:, :, None, None]).any(dim=1)[..., None] & _col(d["gate"])
    fill = torch.as_tensor(np.asarray(t.fill_value, np.float32), device=dev)
    fill = torch.broadcast_to(fill, (c,)) if fill.dim() <= 1 else fill
    return torch.where(mask, fill, x)


def _apply_flip(t, x, d):
    return torch.where(_col(d["gate"]), x.flip(_FLIP_DIMS[type(t)]), x)


_APPLIERS = {
    S.HorizontalFlip: _apply_flip,
    S.VerticalFlip: _apply_flip,
    S.RandomBrightnessContrast: _apply_brightness_contrast,
    S.HueSaturationValue: _apply_hsv,
    S.CoarseDropout: _apply_coarse_dropout,
}


class DeviceStage:
    """``stage(batch, out_dtype=torch.float32, generator=None, draws=None)``:
    a uint8 NHWC batch through the random ops in pipeline order, then
    ``(x − 255·mean) / (255·std)`` in f32, cast to ``out_dtype`` (the same
    arithmetic as nkbx's, device.py:694-733).

    The random ops run when a ``generator`` is given (training): each op
    takes its :func:`draw` from it, on the batch's device, op after op in
    pipeline order. ``draws`` instead hands them in, one dict per random op
    (:meth:`draw` makes such a list), so that a test can feed the draws nkbx
    made from its key or hold one device against another. With neither,
    only Normalize runs (evaluation and serving)."""

    def __init__(self, transforms: Sequence[S.Transform]):
        norm, self.ops = None, []
        for t in transforms:
            if isinstance(t, S.Normalize):
                norm = t
            elif type(t) in _APPLIERS:
                self.ops.append(t)
            elif t.stage != S.MARKER:
                raise NotImplementedError(
                    f"Device transform {type(t).__name__} is not ported to nkbx_torch yet "
                    "(ROADMAP.md, A9)")
        if norm is not None:
            self.mean = np.asarray(norm.mean, dtype=np.float32) * norm.max_pixel_value
            self.std = np.asarray(norm.std, dtype=np.float32) * norm.max_pixel_value
        else:
            self.mean = np.zeros(1, dtype=np.float32)
            self.std = np.ones(1, dtype=np.float32)
        self._consts = {}

    def draw(self, shape, generator: torch.Generator, device=None) -> list:
        """Every random op's draws for a batch of ``shape`` (B, H, W, C)."""
        device = generator.device if device is None else device
        return [draw(t, shape, generator, device) for t in self.ops]

    def __call__(self, batch: torch.Tensor, out_dtype=torch.float32, generator=None,
                 draws=None):
        dev = batch.device
        x = batch
        if draws is None and generator is not None:
            draws = self.draw(tuple(x.shape), generator, dev)
        if draws is not None:
            if len(draws) != len(self.ops):
                raise ValueError(f"{len(draws)} draws for {len(self.ops)} random ops")
            for t, d in zip(self.ops, draws):
                if type(t) not in _FLIP_DIMS and not x.is_floating_point():
                    x = x.float()
                x = _APPLIERS[type(t)](t, x, {k: v.to(dev) for k, v in d.items()})
        if dev not in self._consts:
            self._consts[dev] = (torch.as_tensor(self.mean, device=dev),
                                 torch.as_tensor(self.std, device=dev))
        m, s = self._consts[dev]
        return ((x.float() - m) / s).to(out_dtype)


def build_device_fn(transforms: Sequence[S.Transform]) -> DeviceStage:
    """The device stage of ``transforms`` (see :class:`DeviceStage`)."""
    return DeviceStage(transforms)
