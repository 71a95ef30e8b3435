"""The port's MotionBlur, RandomShadow, RandomFog, RandomRain, Rotate and
ShiftScaleRotate against nkbx's, on the CPU.

Each op runs alone through both device stages with Normalize's identity
(nkbx ``build_device_fn([op])``, its key split as the stage splits it), the
port fed the draws nkbx made from that key, at B = 24, 20x28 (as
tests/test_torch_augment.py does for the other random ops). Tolerances, on
the 0-255 scale:

- RandomFog and RandomRain: equal to rounding (1e-4); rain's streaks equal
  a transcription of nkbx's loop (``jnp.roll`` per step, per sample).
- RandomShadow: the mask that nkbx's output shows equal to the port's
  ``shadow_mask`` but at its tie pixels (an active shadow's |u| or |v|
  within 2e-4 px of its bound), which are counted and bounded; the output
  within 1e-4 elsewhere.
- MotionBlur: nkbx's kernels, read off its output on an impulse image, equal
  to the port's ``motion_kernels`` in support and within 1e-6 in value but
  at their tie taps (dist or proj within 1e-4 of its bound), counted and
  bounded; the output within 1e-3 on the samples with no tie tap.
- Rotate and ShiftScaleRotate: within 1e-3 in both border modes (a constant
  border with a nonzero value); the warp itself against
  ``jax.scipy.ndimage.map_coordinates`` at order 1 within 1e-4.

Also configs/heavy_augs_config.py's whole train pipeline against nkbx's
``build_device_fn`` (1e-3 / (255·std) after Normalize, the samples with a
MotionBlur tie and the pixels of a shadow tie left out and bounded), the
port's own draws (in range, repeatable), and a CPU run of ``python -m
nkbx_torch.train --device cpu`` on a copy of the config cut to a tiny
backbone, 32 px and a few images: finite losses and ``Gradients/*``
columns in ``metrics.csv``.
"""

import csv
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates

from nkbx.transforms import device as jdevice
from nkbx.transforms import spec as jspec
from nkbx.utils import load_config as jload_config
from nkbx_torch.transforms import device as tdevice
from nkbx_torch.transforms import spec as tspec
from nkbx_torch.utils import load_config
from test_torch_augment import _key_of, _nkbx_draws, _port_spec, _torch

ROOT = Path(__file__).resolve().parents[1]
HEAVY = ROOT / "configs" / "heavy_augs_config.py"
TOL = 1e-3  # on the 0-255 scale
EXACT = 1e-4  # fog, rain and the shadow's factor: the same f32 arithmetic
B, H, W = 24, 20, 28


def _images(seed=0, b=B, h=H, w=W, lo=0):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, 256, (b, h, w, 3), dtype=np.uint8)


def _gate(k, p, b):
    return np.asarray(jax.random.uniform(k, (b, 1, 1, 1)) < p).reshape(b)


def _heavy_draws(t, key, shape):
    """The draws nkbx's applier of one of the six ops makes from ``key``
    (device.py:149-260, 649-673), in the port's layout."""
    b, ih, iw = shape[:3]
    if isinstance(t, jspec.MotionBlur):
        k_g, k_len, k_ang, k_off = jax.random.split(key, 4)
        ks = t.ksizes()
        return {"gate": _gate(k_g, t.p, b),
                "length": np.asarray(jnp.asarray(ks)[jax.random.randint(k_len, (b,), 0,
                                                                         len(ks))]),
                "theta": np.asarray(jax.random.uniform(k_ang, (b,), minval=0.0, maxval=np.pi)),
                "off": np.asarray(jax.random.uniform(k_off, (b, 2), minval=-1.0, maxval=1.0))}
    if isinstance(t, jspec.RandomShadow):
        k_g, k_n, k_c, k_ab, k_th = jax.random.split(key, 5)
        n = max(1, t.num_shadows_upper)
        return {"gate": _gate(k_g, t.p, b),
                "n_shadows": np.asarray(jax.random.randint(
                    k_n, (b, 1), t.num_shadows_lower, t.num_shadows_upper + 1)).reshape(b),
                "centre": np.asarray(jax.random.uniform(k_c, (b, n, 2))),
                "ab": np.asarray(jax.random.uniform(k_ab, (b, n, 2), minval=0.1, maxval=0.35)),
                "theta": np.asarray(jax.random.uniform(k_th, (b, n), maxval=np.pi))}
    if isinstance(t, jspec.RandomFog):
        k_g, k_f = jax.random.split(key)
        return {"gate": _gate(k_g, t.p, b),
                "f": np.asarray(jax.random.uniform(k_f, (b, 1, 1, 1), minval=t.fog_coef_lower,
                                                   maxval=t.fog_coef_upper)).reshape(b)}
    if isinstance(t, jspec.RandomRain):
        k_g, k_noise, k_slant = jax.random.split(key, 3)
        seeds = jax.random.uniform(k_noise, (b, ih, iw, 1)) < tdevice.RAIN_DENSITY
        return {"gate": _gate(k_g, t.p, b), "seeds": np.asarray(seeds)[..., 0],
                "slant": np.asarray(jax.random.randint(k_slant, (b,), t.slant_lower,
                                                       t.slant_upper + 1))}
    if isinstance(t, jspec.Rotate):
        k_g, k_a = jax.random.split(key)
        lo, hi = t.range()
        return {"gate": _gate(k_g, t.p, b),
                "angle": np.asarray(jax.random.uniform(k_a, (b,), minval=lo, maxval=hi))}
    if isinstance(t, jspec.ShiftScaleRotate):
        (sh_lo, sh_hi), (sc_lo, sc_hi), (r_lo, r_hi) = t.ranges()
        k_g, k_s, k_c, k_r = jax.random.split(key, 4)
        return {"gate": _gate(k_g, t.p, b),
                "shift": np.asarray(jax.random.uniform(k_s, (b, 2), minval=sh_lo, maxval=sh_hi)),
                "scale": np.asarray(1.0 + jax.random.uniform(k_c, (b,), minval=sc_lo,
                                                             maxval=sc_hi)),
                "angle": np.asarray(jax.random.uniform(k_r, (b,), minval=r_lo, maxval=r_hi))}
    return _nkbx_draws(t, key, shape)


def _both(t, images, seed=3):
    """(nkbx's output, the port's fed nkbx's draws, the draws as tensors)."""
    key, k0 = _key_of(seed)
    want = np.asarray(jdevice.build_device_fn([t])(jnp.asarray(images), key, True))
    d = _torch(_heavy_draws(t, k0, images.shape))
    got = tdevice.build_device_fn([_port_spec(t)])(torch.from_numpy(images), draws=[d]).numpy()
    return want, got, d


# --- RandomFog and RandomRain -------------------------------------------------------


@pytest.mark.parametrize("t", [
    jspec.RandomFog(fog_coef_lower=0.3, fog_coef_upper=0.5, alpha_coef=0.28, p=0.5),
    jspec.RandomFog(p=0.7),
], ids=["shipped", "defaults"])
def test_fog_matches_nkbx(t):
    images = _images(1)
    want, got, d = _both(t, images)
    assert 0 < d["gate"].sum() < B
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    assert np.array_equal(got[~d["gate"].numpy()], images[~d["gate"].numpy()])


def _nkbx_streaks(seeds, slant, drop_length):
    """nkbx's streak loop (device.py:246-253) in numpy: roll i rows, then
    each sample ⌊slant·i / max(steps − 1, 1)⌋ columns, running max."""
    steps = max(1, min(drop_length, seeds.shape[1]))
    out = np.zeros_like(seeds)
    for i in range(steps):
        dx = (slant * i) // max(steps - 1, 1)
        shifted = np.roll(seeds, i, axis=1)
        shifted = np.stack([np.roll(s, int(v), axis=1) for s, v in zip(shifted, dx)])
        out = np.maximum(out, shifted)
    return out


@pytest.mark.parametrize("t", [
    jspec.RandomRain(p=0.5),
    jspec.RandomRain(slant_lower=-20, slant_upper=-5, drop_length=7, drop_color=(10, 90, 250),
                     brightness_coefficient=0.9, p=0.9),
    jspec.RandomRain(slant_lower=3, slant_upper=40, drop_length=40, p=1.0),
], ids=["shipped-defaults", "negative-slant", "longer-than-the-image"])
def test_rain_matches_nkbx(t):
    images = _images(2, b=B, h=H, w=W)
    want, got, d = _both(t, images)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    assert got.min() >= 0 and got.max() <= 255
    seeds, slant = d["seeds"].numpy(), d["slant"].numpy()
    assert seeds.any() and (slant.min() >= t.slant_lower) and (slant.max() <= t.slant_upper)
    streaks = tdevice.rain_streaks(_port_spec(t), d).numpy()
    np.testing.assert_array_equal(streaks, _nkbx_streaks(seeds, slant, t.drop_length))
    color = np.asarray(t.drop_color, np.float32)
    hit = streaks & d["gate"].numpy()[:, None, None]
    assert hit.any() and (got[hit] == color).all()


def test_rain_streaks_take_the_floor_of_negative_slants():
    seeds = torch.zeros(2, 8, 9, dtype=torch.bool)
    seeds[:, 0, 4] = True
    t = tspec.RandomRain(drop_length=4)
    got = tdevice.rain_streaks(t, {"seeds": seeds, "slant": torch.tensor([-1, 1])})
    # steps 0-3 shift ⌊∓i/3⌋: the negative slant leans left from step 1, the positive
    # one moves only at step 3
    assert got[0].nonzero().tolist() == [[0, 4], [1, 3], [2, 3], [3, 3]]
    assert got[1].nonzero().tolist() == [[0, 4], [1, 4], [2, 4], [3, 5]]


# --- RandomShadow --------------------------------------------------------------------

SHADOW_TIE = 2e-4  # px: |u| or |v| this close to its bound may fall either way


@pytest.mark.parametrize("t", [
    jspec.RandomShadow(p=0.5),
    jspec.RandomShadow(shadow_roi=(0.2, 0.0, 0.9, 0.6), num_shadows_lower=0,
                       num_shadows_upper=4, shadow_intensity=0.3, p=0.8),
    jspec.RandomShadow(num_shadows_lower=0, num_shadows_upper=0, p=1.0),
], ids=["shipped-defaults", "roi-up-to-4", "no-shadows"])
def test_shadow_matches_nkbx(t):
    images = _images(3, lo=1)  # no zero pixel: the mask shows in nkbx's output
    want, got, d = _both(t, images)
    ts = _port_spec(t)
    shown = (want != images).any(-1)
    mask = tdevice.shadow_mask(ts, d, H, W).numpy() & d["gate"].numpy()[:, None, None]
    ties = tdevice.shadow_ties(ts, d, H, W, SHADOW_TIE).numpy()
    assert ties.sum() <= 2, ties.sum()
    np.testing.assert_array_equal(mask & ~ties, shown & ~ties)
    keep = ~ties[..., None]
    np.testing.assert_allclose(got * keep, want * keep, rtol=0, atol=EXACT)
    if t.num_shadows_upper > 0:
        assert mask.any() and not mask.all()
    else:
        assert not mask.any() and np.array_equal(got, images)


# --- MotionBlur ----------------------------------------------------------------------

MOTION_TIE = 1e-4  # a tap's dist or proj this close to its bound may fall either way


def _nkbx_kernels(t, seed, b=B, h=H, w=W):
    """nkbx's per-sample kernels read off its output on an impulse of 255 at
    the centre: the output at centre − (i − pad, j − pad) is 255·kern[i, j]
    (the gated samples; the others keep the impulse)."""
    kmax = max(t.ksizes())
    pad = kmax // 2
    x = np.zeros((b, h, w, 3), np.uint8)
    cy, cx = h // 2, w // 2
    x[:, cy, cx] = 255
    key, _ = _key_of(seed)
    y = np.asarray(jdevice.build_device_fn([t])(jnp.asarray(x), key, True))[..., 0]
    return (y[:, cy + pad - np.arange(kmax)[:, None], cx + pad - np.arange(kmax)[None, :]]
            / np.float32(255.0))


@pytest.mark.parametrize("t", [
    jspec.MotionBlur(blur_limit=3, p=0.5),
    jspec.MotionBlur(p=0.8),
    jspec.MotionBlur(blur_limit=3, allow_shifted=False, p=0.8),
    jspec.MotionBlur(blur_limit=7, allow_shifted=True, p=1.0),
    jspec.MotionBlur(blur_limit=7, allow_shifted=False, p=1.0),
    jspec.MotionBlur(blur_limit=(5, 9), p=1.0),
], ids=["shipped", "defaults", "limit3-centred", "limit7-shifted", "limit7-centred",
        "limit5-9"])
def test_motion_blur_matches_nkbx(t):
    images = _images(4)
    want, got, d = _both(t, images)
    ts = _port_spec(t)
    kern = tdevice.motion_kernels(ts, d).numpy()
    ties = tdevice.motion_ties(ts, d, MOTION_TIE).numpy()
    gate = d["gate"].numpy()
    assert 0 < gate.sum() and set(d["length"].tolist()) <= set(t.ksizes())
    assert ties.sum() <= 2, ties.sum()
    jk = _nkbx_kernels(t, 3)
    untied = ~ties.any(axis=(1, 2))
    for s in np.flatnonzero(gate):
        np.testing.assert_array_equal(kern[s][~ties[s]] > 0, jk[s][~ties[s]] > 0)
        if untied[s]:
            np.testing.assert_allclose(kern[s], jk[s], rtol=0, atol=1e-6)
    taps = (kern > 0).sum(axis=(1, 2))  # a diagonal raster of length 3 may hit 1 or 2
    np.testing.assert_allclose(kern.sum(axis=(1, 2))[taps > 0], 1.0, rtol=0, atol=1e-6)
    assert taps.max() >= 3
    np.testing.assert_allclose(got[untied], want[untied], rtol=0, atol=TOL)
    assert untied.sum() >= B - 2
    assert np.array_equal(got[~gate], images[~gate])


def test_motion_blur_ksizes_and_refusal():
    assert tspec.MotionBlur(blur_limit=3).ksizes() == [3]
    assert tspec.MotionBlur(blur_limit=8).ksizes() == [3, 5, 7]
    assert tspec.MotionBlur(blur_limit=(4, 9)).ksizes() == [5, 7, 9]
    for lim in (3, 7, (4, 9), (3, 3)):
        want = jspec.MotionBlur(blur_limit=lim).ksizes()
        assert tspec.MotionBlur(blur_limit=lim).ksizes() == want
    for lim in (2, (4, 4), (0, 1)):
        with pytest.raises(ValueError, match="no odd kernel size"):
            tspec.MotionBlur(blur_limit=lim)
        with pytest.raises(ValueError):
            jspec.MotionBlur(blur_limit=lim)


def test_motion_blur_pads_by_reflect_101():
    """A one-hot column at the left edge blurred by a horizontal 3-tap line:
    the pad at column −1 reads column 1 (no repeated edge)."""
    t = tspec.MotionBlur(blur_limit=3, allow_shifted=False, p=1.0)
    x = torch.zeros(1, 3, 5, 3)
    x[:, :, 1] = 90.0
    d = {"gate": torch.tensor([True]), "length": torch.tensor([3]), "theta": torch.tensor([0.0]),
         "off": torch.zeros(1, 2)}
    y = tdevice.build_device_fn([t])(x.to(torch.uint8), draws=[d])
    assert torch.allclose(y[0, 1, :, 0], torch.tensor([60.0, 30.0, 30.0, 0.0, 0.0]))


# --- Rotate and ShiftScaleRotate ------------------------------------------------------


@pytest.mark.parametrize("mode", ["mirror", "constant"])
def test_bilinear_warp_matches_map_coordinates(mode):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (3, 9, 11, 2)).astype(np.float32)
    sy = rng.uniform(-12, 20, (3, 9, 11)).astype(np.float32)
    sx = rng.uniform(-12, 22, (3, 9, 11)).astype(np.float32)
    sy[0, 0, :4] = [-1.0, 0.0, 8.0, 9.0]  # integer rows on and past the edges
    got = tdevice.bilinear_warp(torch.from_numpy(x), torch.from_numpy(sy), torch.from_numpy(sx),
                                mode, 37.5).numpy()
    want = np.stack([np.stack([np.asarray(map_coordinates(
        jnp.asarray(x[b, :, :, c]), [jnp.asarray(sy[b]), jnp.asarray(sx[b])], order=1,
        mode=mode, cval=37.5)) for c in range(2)], -1) for b in range(3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    if mode == "constant":
        far = (sy < -1) | (sy > 9) | (sx < -1) | (sx > 11)
        assert far.any() and np.allclose(got[far], 37.5)
    i = torch.arange(-30, 31)
    for n in (2, 5, 9):
        np.testing.assert_array_equal(tdevice._mirror(i, n).numpy(),
                                      np.asarray(jdevice._reflect101_index(jnp.asarray(i), n)))


@pytest.mark.parametrize("t", [
    jspec.Rotate(p=0.7),
    jspec.Rotate(limit=(-30, 10), border_mode="constant", value=120.0, p=0.8),
    jspec.Rotate(limit=180, border_mode="reflect101", p=1.0),
], ids=["defaults", "constant-value", "full-turn"])
def test_rotate_matches_nkbx(t):
    images = _images(6)
    want, got, d = _both(t, images)
    gate = d["gate"].numpy()
    assert 0 < gate.sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.array_equal(got[~gate], images[~gate])
    assert not np.allclose(got[gate], images[gate])


@pytest.mark.parametrize("t", [
    jspec.ShiftScaleRotate(p=0.7),
    jspec.ShiftScaleRotate(shift_limit=0.3, scale_limit=(-0.5, 0.4), rotate_limit=(-170, 60),
                           border_mode="constant", value=250.0, p=1.0),
    jspec.ShiftScaleRotate(shift_limit=(0.05, 0.2), scale_limit=0.0, rotate_limit=0,
                           border_mode="reflect101", p=1.0),
], ids=["defaults", "constant-value-wide", "shift-only"])
def test_shift_scale_rotate_matches_nkbx(t):
    images = _images(7)
    want, got, d = _both(t, images)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    gate = d["gate"].numpy()
    assert np.array_equal(got[~gate], images[~gate])
    if t.border_mode == "constant":  # a border pixel of the value where the map leaves
        assert np.isclose(got[gate], t.value, atol=TOL).all(-1).any()


# --- the heavy_augs_config pipeline -------------------------------------------------


def test_heavy_train_pipeline_matches_nkbx():
    """configs/heavy_augs_config.py's device stage (MotionBlur, brightness/
    contrast, HSV, shadow, fog, rain, coarse dropout, Normalize) on a 64-px
    batch of 32: nkbx's build_device_fn against the port fed the draws of
    nkbx's per-op key splits."""
    jpipe = jload_config(str(HEAVY)).train_pipeline.device_transforms
    tpipe = load_config(HEAVY).train_pipeline
    images = _images(8, b=32, h=64, w=64)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jdevice.build_device_fn(jpipe)(jnp.asarray(images), key, True))
    jops = [t for t in jpipe if not isinstance(t, jspec.Normalize)]
    keys = jax.random.split(key, len(jops))
    draws = [_torch(_heavy_draws(t, k, images.shape)) for t, k in zip(jops, keys)]
    got = tpipe.device_apply(torch.from_numpy(images), draws=draws).numpy()
    tops = tpipe.device_stage().ops
    assert [type(t).__name__ for t in tops] == [type(t).__name__ for t in jops]
    ties = {type(t).__name__: tdevice.op_ties(t, d, 64, 64).numpy() for t, d in zip(tops, draws)}
    assert ties["MotionBlur"].any(axis=(1, 2)).sum() <= 1 and ties["RandomShadow"].sum() <= 4
    keep = ~np.logical_or.reduce(list(ties.values()))[..., None]
    std = 255.0 * np.asarray(jpipe[-1].std, np.float32)
    np.testing.assert_allclose(got * keep, want * keep, rtol=0, atol=TOL / std.min())
    assert all(0 < d["gate"].sum() < 32 for d in draws)


def test_generator_draws_are_in_range_and_repeatable():
    pipe = tspec.Compose([tspec.MotionBlur(blur_limit=(3, 9)), tspec.RandomShadow(p=0.5),
                          tspec.RandomFog(fog_coef_lower=0.3, fog_coef_upper=0.5),
                          tspec.RandomRain(slant_lower=-7, slant_upper=4),
                          tspec.Rotate(limit=(-20, 35)),
                          tspec.ShiftScaleRotate(shift_limit=0.1, scale_limit=(-0.2, 0.3),
                                                 rotate_limit=15), tspec.Normalize()])
    stage = pipe.device_stage()
    shape = (512, 32, 48, 3)
    a = stage.draw(shape, torch.Generator().manual_seed(0))
    b = stage.draw(shape, torch.Generator().manual_seed(0))
    c = stage.draw(shape, torch.Generator().manual_seed(1))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(torch.equal(x[k], y[k]) for x, y in zip(a, c) for k in x)
    mb, sh, fog, rain, rot, ssr = a
    for d in a:
        assert 0.3 < d["gate"].float().mean() < 0.7 and d["gate"].dtype == torch.bool
    assert set(mb["length"].tolist()) == {3, 5, 7, 9}
    assert mb["theta"].min() >= 0 and mb["theta"].max() <= np.pi
    assert mb["off"].shape == (512, 2) and mb["off"].abs().max() <= 1
    assert set(sh["n_shadows"].tolist()) == {1, 2} and sh["centre"].shape == (512, 2, 2)
    assert sh["ab"].min() >= 0.1 and sh["ab"].max() <= 0.35 and sh["theta"].max() <= np.pi
    assert fog["f"].min() >= 0.3 and fog["f"].max() <= 0.5
    assert rain["seeds"].shape == (512, 32, 48) and rain["seeds"].dtype == torch.bool
    assert 0.001 < rain["seeds"].float().mean() < 0.003
    assert set(rain["slant"].tolist()) == set(range(-7, 5))
    assert rot["angle"].min() >= -20 and rot["angle"].max() <= 35
    assert ssr["shift"].abs().max() <= 0.1 and ssr["angle"].abs().max() <= 15
    assert ssr["scale"].min() >= 0.8 and ssr["scale"].max() <= 1.3
    x = torch.from_numpy(_images(9, b=4, h=32, w=48))
    out1 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    out2 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(out1, out2) and not torch.equal(out1, pipe.device_apply(x))
    assert torch.isfinite(out1).all()


def test_every_nkbx_device_op_is_ported():
    names = {c.__name__ for c in jdevice._RANDOM_APPLIERS} | {"Normalize"}
    assert {c.__name__ for c in tspec.PORTED_DEVICE_OPS} == names
    assert {c.__name__ for c in tdevice._APPLIERS} | {"Normalize"} == names


# --- the train CLI on the config -------------------------------------------------------

TARGETS = ["dog_size", "dog_fur", "dog_color", "dog_ear_type", "dog_muzzle_len", "dog_leg_len"]


def test_train_cli_runs_heavy_augs_on_the_cpu(tmp_path):
    """``python -m nkbx_torch.train --device cpu`` on a copy of
    configs/heavy_augs_config.py with its data, run directory, model and
    sizes cut down (resnet_tiny_test, 32 px, batch 8, 24 + 10 images): the
    whole heavy device stage, six FocalLoss heads, nadam, multistep, the
    freeze policy and log_gradients; exit 0, finite losses, Gradients/*
    columns."""
    import cv2

    rng = np.random.default_rng(10)
    (tmp_path / "images").mkdir()
    rows = ["path,fold," + ",".join(TARGETS)]
    for i in range(34):
        img = rng.integers(0, 256, (int(rng.integers(24, 48)), int(rng.integers(24, 48)), 3),
                           dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "images" / f"{i}.png"), img)
        labels = [f"{t}_{int(rng.integers(0, 2 + k % 2))}" for k, t in enumerate(TARGETS)]
        rows.append(f"{i}.png,{'train' if i < 24 else 'val'}," + ",".join(labels))
    (tmp_path / "annotations.csv").write_text("\n".join(rows) + "\n")
    text = HEAVY.read_text()
    run = tmp_path / "run"
    for old, new in (('"data/annotations.csv"', f'"{tmp_path}/annotations.csv"'),
                     ('"data/images"', f'"{tmp_path}/images"'),
                     ('f"data/runs/{experiment_name}"', f'"{run}"'),
                     ('"batch_size": 64', '"batch_size": 8'),
                     ('"num_workers": 8', '"num_workers": 1'),
                     ("img_size = 224", "img_size = 32"),
                     ('"mobilenetv3_large_100"', '"resnet_tiny_test"'), ('"pretrained": True',
                                                                         '"pretrained": False')):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    cfg = tmp_path / "heavy.py"
    cfg.write_text(text)
    proc = subprocess.run([sys.executable, "-m", "nkbx_torch.train", "-cfg", str(cfg), "--device",
                           "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert len(rows) == 2
    grads = [k for k in rows[0] if k.startswith("Gradients/")]
    assert grads
    for r in rows:
        assert np.isfinite(float(r["train loss"])) and np.isfinite(float(r["Val loss"]))
        assert all(np.isfinite(float(r[k])) for k in grads)
