"""Host-stage geometry (counterpart of ``nkbx/transforms/host.py``): the
shape-changing transforms, per sample in the loader's threads, so that the
device stage sees one static (H, W).

Resizing goes through cv2, then PIL, as nkbx's does. Where neither is
installed it goes through :func:`resize_bilinear`, a numpy bilinear resize
with cv2's INTER_LINEAR half-pixel convention, the arithmetic of nkbx's
native decoder (``nkbx/native/decode.cpp`` ``resize_bilinear``); cv2's own
fixed-point weights put it within one uint8 level of cv2. Padding is
``np.pad`` with nkbx's table of cv2 border modes.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

from nkbx_torch.transforms import spec as S

# cv2 border_mode -> np.pad mode (cv2.BORDER_CONSTANT/REPLICATE/REFLECT/WRAP/
# REFLECT_101; np 'reflect' == cv2 REFLECT_101, np 'symmetric' == cv2 REFLECT)
_PAD_MODES = {0: "constant", 1: "edge", 2: "symmetric", 3: "wrap", 4: "reflect"}


@functools.lru_cache(maxsize=None)
def resizer() -> str:
    """The library that resizes on this host: "cv2", "PIL" or "numpy"."""
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            return name
        except ImportError:
            continue
    return "numpy"


def _axis(dst: int, src: int):
    """Source indices and weights of one axis (decode.cpp, in float32)."""
    f = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * (np.float32(src) / np.float32(dst))
    f -= np.float32(0.5)
    i0 = np.floor(f).astype(np.int64)
    wgt = (f - i0).astype(np.float32)
    i1 = i0 + 1
    low = i0 < 0
    i0[low], i1[low], wgt[low] = 0, 0, 0.0
    return np.minimum(i0, src - 1), np.minimum(i1, src - 1), wgt


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (H, W[, C]) to (h, w[, C]): bilinear at half-pixel centres,
    float32 weights, rounded as ``uint8(v + 0.5)``."""
    src = img.reshape(img.shape[0], img.shape[1], -1).astype(np.float32)
    y0, y1, wy = _axis(h, img.shape[0])
    x0, x1, wx = _axis(w, img.shape[1])
    wx = wx[None, :, None]
    one = np.float32(1)
    top = src[y0][:, x0] * (one - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (one - wx) + src[y1][:, x1] * wx
    wy = wy[:, None, None]
    out = (top * (one - wy) + bot * wy + np.float32(0.5)).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def _resize(img: np.ndarray, h: int, w: int, interpolation: int = 1) -> np.ndarray:
    if img.shape[0] == h and img.shape[1] == w:
        return img
    lib = resizer()
    if lib == "cv2":
        import cv2

        return cv2.resize(img, (w, h), interpolation=interpolation)
    if lib == "PIL":
        from PIL import Image

        modes = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC, 3: Image.BOX,
                 4: Image.LANCZOS}
        return np.asarray(Image.fromarray(img).resize((w, h), modes.get(interpolation,
                                                                         Image.BILINEAR)))
    if interpolation != 1:
        raise NotImplementedError(f"resize interpolation {interpolation} needs cv2 or PIL; "
                                  "without them only bilinear (1) is available")
    return resize_bilinear(img, h, w)


def _pad_center(img: np.ndarray, min_h: int, min_w: int, value=0,
                border_mode: int = 0) -> np.ndarray:
    h, w = img.shape[:2]
    if h >= min_h and w >= min_w:
        return img
    pad_top = max(0, (min_h - h) // 2)
    pad_bottom = max(0, min_h - h - pad_top)
    pad_left = max(0, (min_w - w) // 2)
    pad_right = max(0, min_w - w - pad_left)
    pads = [(pad_top, pad_bottom), (pad_left, pad_right)] + [(0, 0)] * (img.ndim - 2)
    mode = _PAD_MODES.get(border_mode, "constant")
    if mode != "constant":
        return np.pad(img, pads, mode=mode)
    if np.isscalar(value):
        return np.pad(img, pads, mode="constant", constant_values=value)
    out = np.pad(img, pads, mode="constant")
    val = np.asarray(value, dtype=img.dtype)
    if pad_top:
        out[:pad_top] = val
    if pad_bottom:
        out[out.shape[0] - pad_bottom:] = val
    if pad_left:
        out[:, :pad_left] = val
    if pad_right:
        out[:, out.shape[1] - pad_right:] = val
    return out


def _center_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Center-crop to exactly (h, w); an axis shorter than that is zero-padded."""
    ih, iw = img.shape[:2]
    y1 = max(0, (ih - h) // 2)
    x1 = max(0, (iw - w) // 2)
    img = img[y1:y1 + h, x1:x1 + w]
    if img.shape[0] != h or img.shape[1] != w:
        img = _pad_center(img, h, w, 0)
    return img


def apply_host(transforms: Sequence[S.Transform], img: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    img = np.ascontiguousarray(img)
    for t in transforms:
        if isinstance(t, (S.LongestMaxSize, S.SmallestMaxSize)):
            h, w = t.out_size(img.shape[0], img.shape[1])
            img = _resize(img, h, w, t.interpolation)
        elif isinstance(t, S.PadIfNeeded):
            img = _pad_center(img, t.min_height, t.min_width, t.value, t.border_mode)
        elif isinstance(t, S.Resize):
            img = _resize(img, t.height, t.width, t.interpolation)
        elif isinstance(t, S.CenterCrop):
            img = _center_crop(img, t.height, t.width)
        elif isinstance(t, S.RandomCrop):
            ih, iw = img.shape[:2]
            r = rng if rng is not None else np.random.default_rng()
            y1 = int(r.integers(0, max(1, ih - t.height + 1)))
            x1 = int(r.integers(0, max(1, iw - t.width + 1)))
            img = img[y1:y1 + t.height, x1:x1 + t.width]
            if img.shape[0] != t.height or img.shape[1] != t.width:
                img = _pad_center(img, t.height, t.width, 0)
        else:
            raise NotImplementedError(f"Host transform {type(t).__name__} not implemented")
    return np.ascontiguousarray(img)


def infer_output_size(transforms: Sequence[S.Transform], in_h: int = None, in_w: int = None):
    """The static (H, W) the host chain gives every input, or None where the
    output shape depends on the input. Tracks per axis an exact size or an
    upper bound; PadIfNeeded makes an axis exact when its bound is at most
    the pad's minimum."""
    exact = [None, None]
    bound = [None, None]
    for t in transforms:
        if isinstance(t, S.LongestMaxSize):
            exact = [None, None]
            bound = [t.max_size, t.max_size]
        elif isinstance(t, S.SmallestMaxSize):
            exact = [None, None]
            bound = [None, None]
        elif isinstance(t, (S.Resize, S.CenterCrop, S.RandomCrop)):
            exact = [t.height, t.width]
            bound = [t.height, t.width]
        elif isinstance(t, S.PadIfNeeded):
            mins = (t.min_height, t.min_width)
            for ax in range(2):
                if exact[ax] is not None:
                    exact[ax] = max(exact[ax], mins[ax])
                    bound[ax] = exact[ax]
                elif bound[ax] is not None and bound[ax] <= mins[ax]:
                    exact[ax] = mins[ax]
                    bound[ax] = mins[ax]
    if exact[0] is not None and exact[1] is not None:
        return exact[0], exact[1]
    return None
