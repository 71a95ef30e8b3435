"""Device stage of the transform pipeline (counterpart of
``nkbx/transforms/device.py`` ``build_device_fn``): the random flips,
RandomBrightnessContrast, HueSaturationValue, CoarseDropout, Rotate,
ShiftScaleRotate, RandAugment, TrivialAugmentWide, MotionBlur,
RandomShadow, RandomFog and RandomRain, then Normalize, as plain PyTorch ops
on the batch's device: every device op of nkbx.

RandAugment and TrivialAugmentWide run torchvision's 14-op table as nkbx
runs it in batch mode: every op on the whole batch, then each sample's op
selected, so nothing waits on the host; the affine ops (shears, translates,
rotation, nearest-neighbour sampling) go through ``num_affine_grids`` grids
that the batch shares, each sample taking one; equalize is PIL's integer
LUT, bit for bit.

Rotate and ShiftScaleRotate warp each sample by its own affine map,
bilinearly, by ``jax.scipy.ndimage.map_coordinates``' rules (reflect-101 or
a constant border). MotionBlur rasterises a line kernel a sample and
accumulates kmax² shifted slices; RandomShadow darkens rotated rectangles;
RandomRain smears thresholded noise along a slant: nkbx's own
approximations of albumentations, kept as they are. The thresholds on sine
and cosine (the line raster, the shadow's edges) can fall the other way on
another device within an ulp of their bounds: :func:`motion_ties` and
:func:`shadow_ties` list those taps and pixels.

The chain keeps nkbx's order (device.py:694-733): the flips select on the
raw uint8 batch until the first photometric op, which casts to float32; an
op clips to [0, 255] where nkbx's does (fog, shadow and the warps stay in
range without it); Normalize writes the
compute dtype once. HSV follows the cv2-uint8 convention (H in [0, 180), S
and V in [0, 255]). Padded (masked) rows are augmented like any other row;
the loss and the statistics weight them out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nkbx_torch.parallel import collectives
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


def _signs(shape, generator, device):
    return torch.where(torch.rand(shape, generator=generator, device=device) < 0.5, 1.0, -1.0)


def draw(t: S.Transform, shape, generator: torch.Generator, device) -> dict:
    """One random op's draws for a batch of ``shape`` (B, H, W, C), from
    ``generator`` on ``device``, in this order: ``gate`` (B uniforms under
    ``p``), then the op's own: brightness/contrast ``alpha`` (1 + U(c_lo,
    c_hi)) and ``beta`` (U(b_lo, b_hi)); HSV ``dh``, ``ds``, ``dv``; coarse
    dropout ``n_holes`` (an integer in [min_holes, max_holes]), the hole
    heights ``hh`` and widths ``ww`` (floors of U(min, max)), then the top
    rows ``y1`` and left columns ``x1`` (floors of U(0, 1)·max(H − hh, 1),
    and of W), each (B, max_holes); Rotate ``angle`` (B, degrees);
    ShiftScaleRotate ``shift`` (B, 2: x then y, fractions of W and H),
    ``scale`` (B, 1 + U(sc_lo, sc_hi)) and ``angle``; MotionBlur ``length``
    (B, one of ``ksizes()``), ``theta`` (B, U(0, π)) and ``off`` (B, 2,
    U(−1, 1), read only under ``allow_shifted``); RandomShadow
    ``n_shadows`` (B, an integer in [lower, upper]), then with n =
    max(1, upper) ``centre`` (B, n, 2, U(0, 1) in the ROI), ``ab`` (B, n, 2,
    U(0.1, 0.35) of W and H) and ``theta`` (B, n, U(0, π)); RandomFog ``f``
    (B); RandomRain ``seeds`` (B, H, W, uniforms under 0.002) and ``slant``
    (B, an integer in [slant_lower, slant_upper]); RandAugment and
    TrivialAugmentWide one row a round (R = ``num_ops``, or 1) of ``op`` (B,
    the 14-op table), ``grid`` (B, the affine grid a sample takes), ``sign``
    (B, ±1), and of each of the K affine grids ``grid_op`` (1-5) and
    ``grid_sign``; TrivialAugmentWide also the magnitude bins ``mag`` (B) and
    ``grid_mag`` (K)."""
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
    elif isinstance(t, S.Rotate):
        out["angle"] = _uniform(b, *t.range(), generator, device)
    elif isinstance(t, S.ShiftScaleRotate):
        (sh_lo, sh_hi), (sc_lo, sc_hi), (r_lo, r_hi) = t.ranges()
        out["shift"] = _uniform((b, 2), sh_lo, sh_hi, generator, device)
        out["scale"] = 1.0 + _uniform(b, sc_lo, sc_hi, generator, device)
        out["angle"] = _uniform(b, r_lo, r_hi, generator, device)
    elif isinstance(t, S.MotionBlur):
        ksizes = t.ksizes()
        pick = torch.randint(0, len(ksizes), (b,), generator=generator, device=device)
        out["length"] = torch.tensor(ksizes, device=device)[pick]
        out["theta"] = _uniform(b, 0.0, np.pi, generator, device)
        out["off"] = _uniform((b, 2), -1.0, 1.0, generator, device)
    elif isinstance(t, S.RandomShadow):
        n = (b, max(1, t.num_shadows_upper))
        out["n_shadows"] = torch.randint(t.num_shadows_lower, t.num_shadows_upper + 1, (b,),
                                         generator=generator, device=device)
        out["centre"] = torch.rand((*n, 2), generator=generator, device=device)
        out["ab"] = _uniform((*n, 2), 0.1, 0.35, generator, device)
        out["theta"] = _uniform(n, 0.0, np.pi, generator, device)
    elif isinstance(t, S.RandomFog):
        out["f"] = _uniform(b, t.fog_coef_lower, t.fog_coef_upper, generator, device)
    elif isinstance(t, S.RandomRain):
        out["seeds"] = torch.rand((b, ih, iw), generator=generator, device=device) < RAIN_DENSITY
        out["slant"] = torch.randint(t.slant_lower, t.slant_upper + 1, (b,), generator=generator,
                                     device=device)
    elif isinstance(t, (S.RandAugment, S.TrivialAugmentWide)):
        r, k = getattr(t, "num_ops", 1), t.num_affine_grids
        out["op"] = torch.randint(0, N_POLICY_OPS, (r, b), generator=generator, device=device)
        out["grid"] = torch.randint(0, k, (r, b), generator=generator, device=device)
        out["sign"] = _signs((r, b), generator, device)
        out["grid_op"] = torch.randint(SHEAR_X, ROTATE + 1, (r, k), generator=generator,
                                       device=device)
        out["grid_sign"] = _signs((r, k), generator, device)
        if isinstance(t, S.TrivialAugmentWide):
            bins = t.num_magnitude_bins
            out["mag"] = torch.randint(0, bins, (r, b), generator=generator, device=device)
            out["grid_mag"] = torch.randint(0, bins, (r, k), generator=generator, device=device)
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


# --- RandAugment and TrivialAugmentWide (nkbx device.py:382-646) -------------------------

# op ids, in torchvision's RandAugment._augmentation_space order
(IDENTITY, SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE, BRIGHTNESS, COLOR, CONTRAST,
 SHARPNESS, POSTERIZE, SOLARIZE, AUTOCONTRAST, EQUALIZE) = range(14)
N_POLICY_OPS = 14


def _gray(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _blend(base, img, factor):
    """torchvision's ``_blend``: base + factor·(img − base), clipped."""
    return torch.clamp(base + factor * (img - base), 0.0, 255.0)


def posterize(x, bits):
    step = torch.pow(2.0, 8.0 - _col(bits))
    return torch.floor(torch.floor(x) / step) * step


def solarize(x, thr):
    return torch.where(x >= _col(thr), 255.0 - x, x)


def autocontrast(x):
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.where(mx > mn, mx - mn, 1.0)
    return torch.where(mx > mn, (x - mn) * scale, x)


def equalize(x):
    """PIL's ``ImageOps.equalize`` per sample and channel: an int64
    histogram of the rounded pixels, the step ``(N − count of the last
    non-empty bin) // 255``, the LUT ``(step // 2 + exclusive cumsum) //
    step`` clipped to [0, 255], the identity where the step is 0 or one
    bin is non-empty (nkbx device.py:407-443, whose nibble einsums reach
    the same integers)."""
    b, h, w, c = x.shape
    q = torch.clamp(torch.round(x), 0, 255).long()
    flat = q.permute(0, 3, 1, 2).reshape(b * c, h * w)
    hist = torch.zeros(b * c, 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    nonzero = hist > 0
    last_nz = 255 - torch.argmax(nonzero.flip(1).to(torch.int32), dim=1)
    last_count = hist.gather(1, last_nz[:, None])[:, 0]
    step = (h * w - last_count) // 255
    csum = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((step[:, None] // 2 + csum) // torch.clamp(step, min=1)[:, None], 0, 255)
    identity = (step <= 0) | (nonzero.sum(dim=1) <= 1)
    lut = torch.where(identity[:, None], torch.arange(256, device=x.device), lut)
    out = lut.gather(1, flat).to(x.dtype)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


_SHARP = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


def sharpness(x, factor):
    """torchvision's ``adjust_sharpness``: blend with the rounded 3x3
    [1,1,1; 1,5,1; 1,1,1]/13 blur, whose border ring keeps the original
    pixels. The blur is nine shifted products, so no convolution algorithm
    (TF32 on the card) rounds it; an integer sum over 13 is never within
    rounding of a .5 tie, so the rounded blur is exact."""
    _, h, w, _ = x.shape
    sm = x.clone()
    if h > 2 and w > 2:
        acc = None
        for dy in range(3):
            for dx in range(3):
                term = (_SHARP[dy][dx] / 13.0) * x[:, dy:dy + h - 2, dx:dx + w - 2]
                acc = term if acc is None else acc + term
        sm[:, 1:-1, 1:-1] = torch.clamp(torch.round(acc), 0.0, 255.0)
    return _blend(sm, x, factor)


def affine_sources(grids: dict, h: int, w: int, device):
    """The (K, H, W) source rows and columns of the K affine grids
    (``aop`` 1-5, ``shear``, ``trans_x``, ``trans_y``, ``rot_deg``, each
    (K,)): the inverse map of shear x/y anchored at the top-left, an integer
    translate, or a rotation about the centre (nkbx device.py:556-576)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    aop = grids["aop"][:, None, None]
    sh = grids["shear"][:, None, None]
    rad = grids["rot_deg"][:, None, None] * (np.pi / 180.0)
    cos, sin = torch.cos(rad), torch.sin(rad)
    is_shx, is_shy, is_rot = aop == SHEAR_X, aop == SHEAR_Y, aop == ROTATE
    zero = torch.zeros_like(sh)
    m00 = torch.where(is_rot, cos, 1.0)
    m01 = torch.where(is_shx, -sh, torch.where(is_rot, -sin, zero))
    m10 = torch.where(is_shy, -sh, torch.where(is_rot, sin, zero))
    m11 = torch.where(is_rot, cos, 1.0)
    tx = torch.where(aop == TRANSLATE_X, grids["trans_x"][:, None, None], zero)
    ty = torch.where(aop == TRANSLATE_Y, grids["trans_y"][:, None, None], zero)
    tl = is_shx | is_shy
    ox = torch.where(tl, zero, torch.full_like(sh, cx))
    oy = torch.where(tl, zero, torch.full_like(sh, cy))
    dx = xs - ox - tx
    dy = ys - oy - ty
    return m10 * dx + m11 * dy + oy, m00 * dx + m01 * dy + ox


def nearest_warp(x, src_y, src_x):
    """``x`` (B, H, W, C) sampled at the nearest pixel of the shared (H, W)
    source grid, 0 outside (nkbx ``_shared_nearest_gather``)."""
    b, h, w, c = x.shape
    yi, xi = torch.round(src_y).long(), torch.round(src_x).long()
    valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[None, :, :, None]
    idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).reshape(-1)
    v = x.reshape(b, h * w, c)[:, idx].reshape(b, h, w, c)
    return torch.where(valid, v, 0.0)


def policy_round(x, op, grid, point, grids):
    """One round of the 14-op table on the f32 batch ``x`` (nkbx
    ``_policy_round``): every op on the whole batch, then each sample's
    selected. ``op``, ``grid`` (B,): each sample's op and affine grid;
    ``point``: per-sample ``color_v``, ``post_bits``, ``solar_thr`` (B,);
    ``grids``: the K grids (see :func:`affine_sources`)."""
    _, h, w, _ = x.shape
    src_y, src_x = affine_sources(grids, h, w, x.device)
    is_affine = (op >= SHEAR_X) & (op <= ROTATE)
    y = x
    for k in range(src_y.shape[0]):
        y = torch.where(_col(is_affine & (grid == k)), nearest_warp(x, src_y[k], src_x[k]), y)
    f = _col(1.0 + point["color_v"])

    def sel(op_id, val):
        return torch.where(_col(op == op_id), val, y)

    y = sel(BRIGHTNESS, _blend(torch.zeros_like(x), x, f))
    y = sel(COLOR, _blend(_gray(x), x, f))
    mean_gray = torch.round(_gray(x)).mean(dim=(1, 2, 3), keepdim=True)
    y = sel(CONTRAST, _blend(mean_gray, x, f))
    y = sel(SHARPNESS, sharpness(x, f))
    y = sel(POSTERIZE, posterize(x, point["post_bits"]))
    y = sel(SOLARIZE, solarize(x, point["solar_thr"]))
    y = sel(AUTOCONTRAST, autocontrast(x))
    y = sel(EQUALIZE, equalize(x))
    return torch.clamp(y, 0.0, 255.0)


def randaugment_magnitudes(t: S.RandAugment, d: dict, r: int, h: int, w: int):
    """Round ``r``'s per-sample and per-grid magnitudes of RandAugment at its
    fixed magnitude (nkbx device.py:466-494, 595-612), in nkbx's f32
    arithmetic; posterize keeps ``8 − round(m / ((bins − 1) / 4))`` bits
    (Python's round, half to even)."""
    frac = t.magnitude / max(t.num_magnitude_bins - 1, 1)
    sign = d["sign"][r]
    point = {"color_v": sign * (0.9 * frac),
             "post_bits": torch.full_like(sign, 8.0 - round(
                 t.magnitude / ((t.num_magnitude_bins - 1) / 4))),
             "solar_thr": torch.full_like(sign, 255.0 * (1.0 - frac))}
    gs = d["grid_sign"][r]
    fr = torch.full_like(gs, frac)
    grids = {"aop": d["grid_op"][r], "shear": 0.3 * fr * gs,
             "trans_x": torch.floor(150.0 / 331.0 * w * fr) * gs,
             "trans_y": torch.floor(150.0 / 331.0 * h * fr) * gs,
             "rot_deg": 30.0 * fr * gs}
    return point, grids


def _div(a, b: float):
    """``a / b`` rounded as a true division on any device: CUDA divides by a
    host scalar through its reciprocal, an ulp off nkbx's (and the CPU's)
    quotient, which can move a solarize threshold across a pixel value."""
    return a / torch.tensor(float(b), device=a.device)


def trivialaugment_magnitudes(t: S.TrivialAugmentWide, d: dict, r: int):
    """TrivialAugmentWide's magnitudes from the bins drawn per sample and
    per grid, at the wide ranges (shear 0.99, translate 32 px, rotate 135°,
    colour 0.99, posterize ``8 − round(m / ((bins − 1) / 6))`` bits; nkbx
    device.py:497-526)."""
    bins = t.num_magnitude_bins
    m = d["mag"][r].float()
    fr = _div(m, max(bins - 1, 1))
    sign = d["sign"][r]
    point = {"color_v": 0.99 * fr * sign,
             "post_bits": 8.0 - torch.round(_div(m, (bins - 1) / 6)),
             "solar_thr": 255.0 * (1.0 - fr)}
    gm = d["grid_mag"][r].float()
    gfr = _div(gm, max(bins - 1, 1))
    gs = d["grid_sign"][r]
    grids = {"aop": d["grid_op"][r], "shear": 0.99 * gfr * gs,
             "trans_x": torch.floor(32.0 * gfr) * gs, "trans_y": torch.floor(32.0 * gfr) * gs,
             "rot_deg": 135.0 * gfr * gs}
    return point, grids


def policy_magnitudes(t, d: dict, r: int, h: int, w: int):
    """Round ``r``'s ``(point, grids)`` magnitudes of either policy ``t``."""
    if isinstance(t, S.RandAugment):
        return randaugment_magnitudes(t, d, r, h, w)
    return trivialaugment_magnitudes(t, d, r)


# the ops whose output on uint8-valued input is exact on any device (the others
# blend, blur or rescale in f32 and agree to rounding)
EXACT_OPS = (IDENTITY, SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE, POSTERIZE, SOLARIZE,
             EQUALIZE)


def policy_ties(t, d: dict, r: int, h: int, w: int, tol: float = 1e-4):
    """(B, H, W): the pixels of round ``r`` of a sample on an affine op whose
    source row or column (computed on the CPU) lies within ``tol`` of a .5
    tie, where another device's or framework's arithmetic may take the other
    nearest neighbour."""
    cpu = {k: v.cpu() for k, v in d.items()}
    _, grids = policy_magnitudes(t, cpu, r, h, w)
    src_y, src_x = affine_sources(grids, h, w, torch.device("cpu"))
    near = [torch.abs(torch.remainder(s, 1.0) - 0.5) < tol for s in (src_y, src_x)]
    op = cpu["op"][r]
    affine = (op >= SHEAR_X) & (op <= ROTATE)
    return (near[0] | near[1])[cpu["grid"][r]] & affine[:, None, None]


def _apply_policy(t, x, d):
    """RandAugment's ``num_ops`` rounds, or TrivialAugmentWide's one, each
    from its own row of draws, then the per-sample gate."""
    _, h, w, _ = x.shape
    y = x
    for r in range(d["op"].shape[0]):
        point, grids = policy_magnitudes(t, d, r, h, w)
        y = policy_round(y, d["op"][r], d["grid"][r], point, grids)
    return torch.where(_col(d["gate"]), y, x)


# --- MotionBlur, RandomShadow, RandomFog, RandomRain (nkbx device.py:149-260) -------------

RAIN_DENSITY = 0.002  # the share of pixels that seed a rain streak (nkbx device.py:244)


def _motion_raster(t: S.MotionBlur, d: dict):
    """(dist, proj, half) of the per-sample line kernels: each tap's distance
    from the line through the (shifted) centre at ``theta``, its distance
    along the line, each (B, kmax, kmax), and the half-length (B, 1, 1)."""
    kmax = max(t.ksizes())
    dev = d["theta"].device
    c = torch.arange(kmax, dtype=torch.float32, device=dev) - (kmax - 1) / 2.0
    yy, xx = c[:, None], c[None, :]
    dy, dx = torch.sin(d["theta"]), torch.cos(d["theta"])
    half = _div(d["length"].float() - 1.0, 2.0)
    if t.allow_shifted:
        # the line may sit off the centre inside the drawn k x k box: each
        # axis's offset at most half·(1 − |direction|)
        oy = d["off"][:, 0] * (half * (1.0 - torch.abs(dy)))
        ox = d["off"][:, 1] * (half * (1.0 - torch.abs(dx)))
    else:
        oy = ox = torch.zeros_like(half)
    yc = yy[None] - oy[:, None, None]
    xc = xx[None] - ox[:, None, None]
    dy, dx = dy[:, None, None], dx[:, None, None]
    dist = torch.abs(yc * dx - xc * dy)
    proj = torch.abs(yc * dy + xc * dx)
    return dist, proj, half[:, None, None]


def motion_kernels(t: S.MotionBlur, d: dict):
    """The (B, kmax, kmax) line kernels: the taps with dist <= 0.5 and proj
    <= half + 0.25, each kernel divided by max(its tap count, 1)."""
    dist, proj, half = _motion_raster(t, d)
    kern = ((dist <= 0.5) & (proj <= half + 0.25)).float()
    return kern / torch.clamp(kern.sum(dim=(1, 2), keepdim=True), min=1.0)


def motion_ties(t: S.MotionBlur, d: dict, tol: float = 1e-4):
    """(B, kmax, kmax): the taps whose dist or proj lies within ``tol`` of its
    bound, which another device's sin and cos may put on the other side."""
    dist, proj, half = _motion_raster(t, d)
    return (torch.abs(dist - 0.5) < tol) | (torch.abs(proj - (half + 0.25)) < tol)


def _apply_motion_blur(t: S.MotionBlur, x, d):
    """The per-sample kernels applied as kmax² shifted slices of the batch
    padded by reflection (reflect-101, as ``jnp.pad(mode="reflect")``),
    accumulated from zeros in nkbx's i-major, j-minor order, then clipped."""
    kern = motion_kernels(t, d)
    kmax = kern.shape[1]
    _, h, w, _ = x.shape
    p = kmax // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)
    y = torch.zeros_like(x)
    for i in range(kmax):
        for j in range(kmax):
            y.addcmul_(_col(kern[:, i, j]), xp[:, i:i + h, j:j + w])
    return torch.where(_col(d["gate"]), y.clamp_(0.0, 255.0), x)


def _shadow_uv(t: S.RandomShadow, d: dict, h: int, w: int):
    """Each shadow's pixel coordinates (u, v), rotated by its ``theta`` about
    its centre in the ROI, its half-extents (a, b) and whether it is one of
    the sample's ``n_shadows``: (B, n, H, W), (B, n, H, W), (B, n, 1, 1) twice,
    (B, n, 1, 1)."""
    x1r, y1r, x2r, y2r = t.shadow_roi
    c, ab, theta = d["centre"], d["ab"], d["theta"]
    dev = theta.device
    cx = ((x1r + c[..., 0] * (x2r - x1r)) * w)[:, :, None, None]
    cy = ((y1r + c[..., 1] * (y2r - y1r)) * h)[:, :, None, None]
    a = (ab[..., 0] * w)[:, :, None, None]
    b = (ab[..., 1] * h)[:, :, None, None]
    rows = torch.arange(h, dtype=torch.float32, device=dev).view(1, 1, h, 1)
    cols = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, 1, w)
    dy, dx = rows - cy, cols - cx
    ct, st = torch.cos(theta)[:, :, None, None], torch.sin(theta)[:, :, None, None]
    u = dx * ct + dy * st
    v = -dx * st + dy * ct
    active = torch.arange(theta.shape[1], device=dev)[None, :] < d["n_shadows"][:, None]
    return u, v, a, b, active[:, :, None, None]


def shadow_mask(t: S.RandomShadow, d: dict, h: int, w: int):
    """(B, H, W): the union over the active shadows of |u| < a and |v| < b."""
    u, v, a, b, active = _shadow_uv(t, d, h, w)
    return ((torch.abs(u) < a) & (torch.abs(v) < b) & active).any(dim=1)


def shadow_ties(t: S.RandomShadow, d: dict, h: int, w: int, tol: float = 2e-4):
    """(B, H, W): the pixels where an active shadow's |u| or |v| lies within
    ``tol`` of its bound, which another device's sin and cos may put on the
    other side."""
    u, v, a, b, active = _shadow_uv(t, d, h, w)
    near = (torch.abs(torch.abs(u) - a) < tol) | (torch.abs(torch.abs(v) - b) < tol)
    return (near & active).any(dim=1)


def op_ties(t, d: dict, h: int, w: int):
    """(B, H, W): the pixels of one op's output that another device may
    compute otherwise for a tie on sin/cos: every pixel of a gated
    MotionBlur sample with a tie tap (its kernel's normalisation moves) and
    a gated shadow's tie pixels; none for the other ops (the policies' .5
    ties are a round's: :func:`policy_ties`)."""
    b = d["gate"].shape[0]
    if isinstance(t, S.MotionBlur):
        return (motion_ties(t, d).any(dim=(1, 2)) & d["gate"])[:, None, None].expand(b, h, w)
    if isinstance(t, S.RandomShadow):
        return shadow_ties(t, d, h, w) & d["gate"][:, None, None]
    return torch.zeros(b, h, w, dtype=torch.bool, device=d["gate"].device)


def _apply_shadow(t: S.RandomShadow, x, d):
    _, h, w, _ = x.shape
    mask = (shadow_mask(t, d, h, w) & d["gate"][:, None, None]).float()[..., None]
    return x * (1.0 - mask * t.shadow_intensity)


def _apply_fog(t: S.RandomFog, x, d):
    f = _col(d["f"])
    return torch.where(_col(d["gate"]), x * (1.0 - f) + 255.0 * f, x)


def rain_streaks(t: S.RandomRain, d: dict):
    """(B, H, W) bool: the seeds smeared over ``steps`` = max(1, min(
    drop_length, H)) rows; step i rolls them i rows down and each sample's
    ⌊slant·i / max(steps − 1, 1)⌋ columns across (floor division, so a
    negative slant leans left), and the steps are merged by a running max."""
    seeds = d["seeds"]
    b, h, w = seeds.shape
    steps = max(1, min(t.drop_length, h))
    cols = torch.arange(w, device=seeds.device)
    streaks = torch.zeros_like(seeds)
    for i in range(steps):
        dx = torch.div(d["slant"] * i, max(steps - 1, 1), rounding_mode="floor")
        idx = torch.remainder(cols[None, :] - dx[:, None], w)  # a per-sample roll by dx
        shifted = torch.gather(torch.roll(seeds, i, dims=1), 2, idx[:, None, :].expand(b, h, w))
        streaks |= shifted
    return streaks


def _apply_rain(t: S.RandomRain, x, d):
    color = torch.as_tensor(np.asarray(t.drop_color, np.float32), device=x.device)
    y = x * t.brightness_coefficient
    y = torch.where(rain_streaks(t, d)[..., None], color, y)
    return torch.where(_col(d["gate"]), y.clamp_(0.0, 255.0), x)


# --- Rotate and ShiftScaleRotate: per-sample bilinear warps (nkbx device.py:272-373) -------

BORDER_MODES = {"reflect101": "mirror", "constant": "constant"}  # map_coordinates' names


def _mirror(i, n: int):
    """``map_coordinates``' mirror fold |(i + s) mod 2s − s|, s = n − 1: a
    border reflects without repeating its edge pixel (reflect-101)."""
    if n == 1:
        return torch.zeros_like(i)
    s = n - 1
    return torch.abs(torch.remainder(i + s, 2 * s) - s)


def _fold(i, n: int, mode: str):
    """(in-range index, whether the tap lies inside) of integer taps ``i``
    along an axis of ``n`` by ``mode``'s rule; None for every tap inside."""
    if mode == "mirror":
        return _mirror(i, n), None
    if mode == "constant":
        return torch.clamp(i, 0, n - 1), (i >= 0) & (i < n)
    raise ValueError(f"border mode {mode!r}: not one of 'mirror', 'constant'")


def bilinear_warp(x, src_y, src_x, mode: str, cval: float):
    """``x`` (B, H, W, C) sampled bilinearly at per-sample source rows and
    columns (B, H, W), by ``jax.scipy.ndimage.map_coordinates``' order-1
    rules: weights 1 − frac and frac from ``floor``; ``"mirror"`` folds an
    index by :func:`_mirror`, ``"constant"`` takes ``cval`` for a tap outside
    the image; the four products wy·wx·tap summed in the order (y0, x0),
    (y0, x1), (y1, x0), (y1, x1). Each tap is gathered by int32 row indices
    from a (B·H·W, C) view of the batch, one tap at a time, so the warp holds
    a few batches of temporaries."""
    b, h, w, c = x.shape
    flat = x.reshape(b * h * w, c)
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    fy, fx = src_y - y0, src_x - x0
    y0, x0 = y0.int(), x0.int()
    base = (torch.arange(b, dtype=torch.int32, device=x.device) * (h * w))[:, None, None]
    rows = [(i.mul_(w).add_(base), v) for i, v in (_fold(y0 + k, h, mode) for k in (0, 1))]
    cols = [_fold(x0 + k, w, mode) for k in (0, 1)]
    del y0, x0
    out = None
    for dy, (yi, yv) in enumerate(rows):
        wy = 1 - fy if dy == 0 else fy
        for dx, (xi, xv) in enumerate(cols):
            tap = torch.index_select(flat, 0, (yi + xi).reshape(-1))
            if yv is not None:
                tap.masked_fill_(~(yv & xv).reshape(-1, 1), cval)
            tap.mul_((wy * (1 - fx if dx == 0 else fx)).reshape(-1, 1))
            out = tap if out is None else out.add_(tap)
    return out.reshape(b, h, w, c)


def affine_map(angle_deg, scale, tx, ty, h: int, w: int):
    """nkbx's ``_affine_sample`` grid: (src_y, src_x), each (B, H, W), the
    inverse of a rotation by ``angle_deg`` (positive counter-clockwise,
    cv2's ``getRotationMatrix2D``), a scale and a shift (tx, ty) about the
    centre ((W − 1)/2, (H − 1)/2), each (B,)."""
    b = angle_deg.shape[0]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=angle_deg.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=angle_deg.device)[None, None, :]
    rad = angle_deg * (np.pi / 180.0)
    cos, sin = torch.cos(rad).reshape(b, 1, 1), torch.sin(rad).reshape(b, 1, 1)
    s = scale.reshape(b, 1, 1)
    dx = xs - cx - tx.reshape(b, 1, 1)
    dy = ys - cy - ty.reshape(b, 1, 1)
    return (sin * dx + cos * dy) / s + cy, (cos * dx - sin * dy) / s + cx


def warp_sources(t, d: dict, h: int, w: int):
    """(src_y, src_x) of Rotate's draws (scale 1, no shift) or
    ShiftScaleRotate's (a shift of (W, H) times its draw)."""
    angle = d["angle"]
    if isinstance(t, S.Rotate):
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        return affine_map(angle, one, zero, zero, h, w)
    return affine_map(angle, d["scale"], d["shift"][:, 0] * w, d["shift"][:, 1] * h, h, w)


def _apply_warp(t, x, d):
    _, h, w, _ = x.shape
    y = bilinear_warp(x, *warp_sources(t, d, h, w), BORDER_MODES[t.border_mode],
                      float(t.value))
    return torch.where(_col(d["gate"]), y, x)


_APPLIERS = {
    S.HorizontalFlip: _apply_flip,
    S.VerticalFlip: _apply_flip,
    S.RandomBrightnessContrast: _apply_brightness_contrast,
    S.HueSaturationValue: _apply_hsv,
    S.CoarseDropout: _apply_coarse_dropout,
    S.Rotate: _apply_warp,
    S.ShiftScaleRotate: _apply_warp,
    S.RandAugment: _apply_policy,
    S.TrivialAugmentWide: _apply_policy,
    S.MotionBlur: _apply_motion_blur,
    S.RandomShadow: _apply_shadow,
    S.RandomFog: _apply_fog,
    S.RandomRain: _apply_rain,
}


# the draws with a row a round (R, B): the rows are their second dimension
_ROUND_KEYS = ("op", "grid", "sign", "mag")
# the draws of the grids the batch shares: not per row
_SHARED_KEYS = ("grid_op", "grid_sign", "grid_mag")


def local_rows(t: S.Transform, d: dict, rows: slice) -> dict:
    """The draws ``d`` of op ``t`` for the global batch, cut to the rows
    ``rows`` (a rank's share under a data-parallel step): every per-row
    draw keeps those rows, the policies' per-round draws those columns, the
    shared grids' draws all of theirs."""
    def cut(k, v):
        if k in _SHARED_KEYS:
            return v
        return v[:, rows] if k in _ROUND_KEYS else v[rows]

    if isinstance(t, (S.RandAugment, S.TrivialAugmentWide)):
        return {k: cut(k, v) for k, v in d.items()}
    return {k: v[rows] for k, v in d.items()}


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
    only Normalize runs (evaluation and serving).

    Under a data-parallel train step (:mod:`nkbx_torch.parallel`) every op
    draws for the global batch from the generator and the rank keeps its
    rows (:func:`local_rows`): each rank's generator stays in step with the
    others', and a row gets the draws it gets in a world of one."""

    def __init__(self, transforms: Sequence[S.Transform]):
        norm, self.ops = None, []
        for t in transforms:
            if isinstance(t, S.Normalize):
                norm = t
            elif type(t) in _APPLIERS:
                self.ops.append(t)
            elif t.stage != S.MARKER:
                raise NotImplementedError(f"Device transform {type(t).__name__} not implemented")
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
            mesh = collectives.active()
            if mesh is None:
                draws = self.draw(tuple(x.shape), generator, dev)
            else:  # the global batch's draws, this rank's rows of them
                b = x.shape[0]
                draws = [local_rows(t, d, mesh.rows(b)) for t, d in
                         zip(self.ops, self.draw((b * mesh.data,) + tuple(x.shape[1:]),
                                                 generator, dev))]
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
