"""The port's random device ops (RandomBrightnessContrast,
HueSaturationValue, CoarseDropout) against nkbx's, on the CPU.

Each op runs alone through both device stages with Normalize's identity
(nkbx ``build_device_fn([op])``, its key split as the stage splits it), the
port fed the draws nkbx made from that key: the gate, alpha/beta, dh/ds/dv,
or the hole count, sizes and corners (floored as nkbx floors them).
Tolerances: brightness/contrast and HSV within 1e-3 on the 0-255 scale
(nkbx's XLA program and PyTorch round the same float32 arithmetic in their
own order; HSV's sector at a boundary is continuous); CoarseDropout's
output, and so its mask, equal. Also the colour-space pair on gray pixels
and the hue wrap, the whole singletask train pipeline of
``configs/singletask_config.py`` against nkbx's ``build_device_fn`` (1e-3
on the 0-255 scale, i.e. 1e-3 / (255·std) after Normalize), and the port's
own draws: inside each op's range, repeatable from a seed.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.transforms import device as jdevice
from nkbx.transforms import spec as jspec
from nkbx.utils import load_config as jload_config
from nkbx_torch.transforms import device as tdevice
from nkbx_torch.transforms import spec as tspec
from nkbx_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-3  # on the 0-255 scale
B, H, W = 24, 20, 28


def _images(seed=0, b=B, h=H, w=W):
    """uint8 images whose first rows are gray (r = g = b) and include 0 and 255."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    x[:, :3] = x[:, :3, :, :1]
    x[:, 3, :4] = 0
    x[:, 3, 4:8] = 255
    return x


def _key_of(seed):
    """The key nkbx's stage hands its only random op: split(key, 1)[0]."""
    key = jax.random.PRNGKey(seed)
    return key, jax.random.split(key, 1)[0]


def _nkbx_draws(t, key, shape):
    """The draws nkbx's applier makes from ``key`` (device.py:86-146), as a
    dict of numpy arrays in the port's layout."""
    b, ih, iw = shape[:3]
    if isinstance(t, (jspec.HorizontalFlip, jspec.VerticalFlip)):
        return {"gate": np.asarray(jax.random.uniform(key, (b, 1, 1, 1)) < t.p).reshape(b)}
    if isinstance(t, jspec.RandomBrightnessContrast):
        (b_lo, b_hi), (c_lo, c_hi) = t.ranges()
        k_g, k_a, k_b = jax.random.split(key, 3)
        return {"gate": np.asarray(jax.random.uniform(k_g, (b, 1, 1, 1)) < t.p).reshape(b),
                "alpha": np.asarray(1.0 + jax.random.uniform(k_a, (b, 1, 1, 1), minval=c_lo,
                                                             maxval=c_hi)).reshape(b),
                "beta": np.asarray(jax.random.uniform(k_b, (b, 1, 1, 1), minval=b_lo,
                                                      maxval=b_hi)).reshape(b)}
    if isinstance(t, jspec.HueSaturationValue):
        k_g, *ks = jax.random.split(key, 4)
        out = {"gate": np.asarray(jax.random.uniform(k_g, (b, 1, 1, 1)) < t.p).reshape(b)}
        for name, k, (lo, hi) in zip(("dh", "ds", "dv"), ks, t.ranges()):
            out[name] = np.asarray(jax.random.uniform(k, (b, 1, 1), minval=lo,
                                                      maxval=hi)).reshape(b)
        return out
    if isinstance(t, jspec.CoarseDropout):
        min_holes, max_holes, min_h, max_h, min_w, max_w = t.resolved(ih, iw)
        k_g, k_n, k_h, k_w, k_y, k_x = jax.random.split(key, 6)
        hh = jnp.floor(jax.random.uniform(k_h, (b, max_holes), minval=min_h, maxval=max_h))
        ww = jnp.floor(jax.random.uniform(k_w, (b, max_holes), minval=min_w, maxval=max_w))
        y1 = jnp.floor(jax.random.uniform(k_y, (b, max_holes)) * jnp.maximum(ih - hh, 1.0))
        x1 = jnp.floor(jax.random.uniform(k_x, (b, max_holes)) * jnp.maximum(iw - ww, 1.0))
        n = jax.random.randint(k_n, (b, 1), min_holes, max_holes + 1).reshape(b)
        return {"gate": np.asarray(jax.random.uniform(k_g, (b, 1, 1, 1)) < t.p).reshape(b),
                "n_holes": np.asarray(n), "hh": np.asarray(hh), "ww": np.asarray(ww),
                "y1": np.asarray(y1), "x1": np.asarray(x1)}
    raise TypeError(type(t))


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port_spec(t):
    """The port's spec with the same fields as nkbx's ``t``."""
    return getattr(tspec, type(t).__name__)(**{f: getattr(t, f) for f in t.__dataclass_fields__})


def _both(t, images, seed=3):
    """(nkbx's output, the port's fed nkbx's draws, the draws) for ``t`` alone."""
    key, k0 = _key_of(seed)
    want = np.asarray(jdevice.build_device_fn([t])(jnp.asarray(images), key, True))
    d = _nkbx_draws(t, k0, images.shape)
    got = tdevice.build_device_fn([_port_spec(t)])(torch.from_numpy(images),
                                                   draws=[_torch(d)]).numpy()
    return want, got, d


@pytest.mark.parametrize("t", [
    jspec.RandomBrightnessContrast(brightness_limit=(-0.2, 0.2), contrast_limit=(0.1, -0.5),
                                   p=0.5),
    jspec.RandomBrightnessContrast(p=0.7),
    jspec.RandomBrightnessContrast(brightness_limit=0.3, contrast_limit=0.4,
                                   brightness_by_max=False, p=0.6),
], ids=["shipped", "defaults", "by-mean"])
def test_brightness_contrast_matches_nkbx(t):
    want, got, d = _both(t, _images(1))
    assert 0 < d["gate"].sum() < B
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert got.min() >= 0 and got.max() <= 255


@pytest.mark.parametrize("t", [
    jspec.HueSaturationValue(hue_shift_limit=0, sat_shift_limit=10, val_shift_limit=50, p=0.5),
    jspec.HueSaturationValue(p=0.8),
    jspec.HueSaturationValue(hue_shift_limit=(-170, 170), sat_shift_limit=60,
                             val_shift_limit=40, p=1.0),
], ids=["shipped", "defaults", "wide-hue"])
def test_hsv_matches_nkbx(t):
    want, got, d = _both(t, _images(2))
    assert d["gate"].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_hsv_pair_on_gray_pixels_and_the_hue_wrap():
    """rgb_to_hsv on gray (diff == 0: H = 0, S = 0 where max = 0) and on the
    sector edges; hsv_to_rgb after shifts that wrap both ways (mod 180 with
    jnp.mod's sign rule, sector 5 on select's default)."""
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (400, 3)).astype(np.float32)
    rgb[:40] = rgb[:40, :1]  # gray
    rgb[40] = 0
    rgb[41:47] = [[255, 0, 0], [255, 255, 0], [0, 255, 0], [0, 255, 255], [0, 0, 255],
                  [255, 0, 255]]
    jh, js, jv = (np.asarray(a) for a in jdevice.rgb_to_hsv(jnp.asarray(rgb)))
    th, ts, tv = (a.numpy() for a in tdevice.rgb_to_hsv(torch.from_numpy(rgb)))
    for got, want in ((th, jh), (ts, js), (tv, jv)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (th[:41] == 0).all() and (ts[:41] == 0).all()
    for shift in (-179.5, -30.0, -1e-6, 0.0, 45.0, 179.9):
        h = np.mod(jh + np.float32(shift), np.float32(180.0))
        hj = jnp.mod(jnp.asarray(jh) + shift, 180.0)
        ht = tdevice._mod(torch.from_numpy(th) + shift, 180.0)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=TOL)
        assert ((ht >= 0) & (ht <= 180)).all() and np.allclose(h, np.asarray(hj), atol=TOL)
        want = np.asarray(jdevice.hsv_to_rgb(hj, jnp.asarray(js), jnp.asarray(jv)))
        got = tdevice.hsv_to_rgb(ht, torch.from_numpy(ts), torch.from_numpy(tv)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    sectors = np.floor(np.asarray(hj) / 30.0).astype(int) % 6
    assert set(sectors.tolist()) == set(range(6))


def test_mod_follows_jnp_sign_rule():
    a = np.array([-7.5, -6.0, -1e-8, -0.0, 0.0, 3.0, 6.0, 179.99, 180.0, 361.0], np.float32)
    for b in (6.0, 180.0, 2.0):
        np.testing.assert_array_equal(tdevice._mod(torch.from_numpy(a), b).numpy(),
                                      np.asarray(jnp.mod(jnp.asarray(a), b)))


@pytest.mark.parametrize("t", [
    jspec.CoarseDropout(max_holes=4, min_holes=1, max_height=0.2, min_height=0.05,
                        max_width=0.2, min_width=0.05, fill_value=[0, 0.5, 1], p=0.5),
    jspec.CoarseDropout(p=0.9),
    jspec.CoarseDropout(max_holes=3, min_holes=1, max_height=9, min_height=2, max_width=0.4,
                        fill_value=128, p=1.0),
], ids=["shipped-per-channel-fill", "defaults-scalar-fill", "pixels-and-fraction"])
def test_coarse_dropout_equals_nkbx(t):
    images = _images(5)
    want, got, d = _both(t, images)
    np.testing.assert_array_equal(got, want)
    changed = (got != images.astype(np.float32)).any(-1)
    assert changed.any() and not changed[~d["gate"]].any()
    lo, hi = t.resolved(H, W)[:2]
    assert d["n_holes"].min() >= lo and d["n_holes"].max() <= hi
    if hi > lo:  # the shipped 1..4 holes: every count drawn across the batch
        assert set(d["n_holes"].tolist()) == set(range(lo, hi + 1))


def test_singletask_train_pipeline_matches_nkbx():
    """configs/singletask_config.py's device stage (flips, brightness/contrast
    with its lo > hi contrast limit, HSV, coarse dropout with a per-channel
    fill, Normalize) on a 64-px batch: nkbx's build_device_fn against the
    port fed the draws of nkbx's per-op key splits."""
    path = ROOT / "configs" / "singletask_config.py"
    jpipe = jload_config(str(path)).train_pipeline.device_transforms
    tpipe = load_config(path).train_pipeline
    images = _images(6, b=32, h=64, w=64)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jdevice.build_device_fn(jpipe)(jnp.asarray(images), key, True))
    jops = [t for t in jpipe if not isinstance(t, jspec.Normalize)]
    keys = jax.random.split(key, len(jops))
    draws = [_torch(_nkbx_draws(t, k, images.shape)) for t, k in zip(jops, keys)]
    got = tpipe.device_apply(torch.from_numpy(images), draws=draws).numpy()
    std = 255.0 * np.asarray(jpipe[-1].std, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL / std.min())
    assert all(0 < d["gate"].sum() < 32 for d in draws)


def test_generator_draws_are_in_range_and_repeatable():
    pipe = load_config(ROOT / "configs" / "singletask_config.py").train_pipeline
    stage = pipe.device_stage()
    shape = (256, 128, 128, 3)
    a = stage.draw(shape, torch.Generator().manual_seed(0))
    b = stage.draw(shape, torch.Generator().manual_seed(0))
    c = stage.draw(shape, torch.Generator().manual_seed(1))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(torch.equal(x[k], y[k]) for x, y in zip(a, c) for k in x)
    ops = dict(zip((type(t).__name__ for t in stage.ops), a))
    for d, t in zip(a, stage.ops):
        assert 0.3 < d["gate"].float().mean() < 0.7 and d["gate"].dtype == torch.bool
    (b_lo, b_hi), (c_lo, c_hi) = stage.ops[2].ranges()
    rbc = ops["RandomBrightnessContrast"]
    assert (c_lo, c_hi) == (-0.5, 0.1)
    assert rbc["alpha"].min() >= 1 + c_lo and rbc["alpha"].max() <= 1 + c_hi
    assert rbc["beta"].min() >= b_lo and rbc["beta"].max() <= b_hi
    hsv = ops["HueSaturationValue"]
    for k, (lo, hi) in zip(("dh", "ds", "dv"), stage.ops[3].ranges()):
        assert hsv[k].min() >= lo and hsv[k].max() <= hi
    cd = ops["CoarseDropout"]
    min_holes, max_holes, min_h, max_h, min_w, max_w = stage.ops[4].resolved(128, 128)
    assert set(cd["n_holes"].tolist()) == set(range(min_holes, max_holes + 1))
    assert cd["hh"].min() >= np.floor(min_h) and cd["hh"].max() <= max_h
    assert cd["ww"].min() >= np.floor(min_w) and cd["ww"].max() <= max_w
    assert (cd["y1"] >= 0).all() and (cd["y1"] + cd["hh"] <= 128).all()
    assert (cd["x1"] >= 0).all() and (cd["x1"] + cd["ww"] <= 128).all()
    x = torch.from_numpy(_images(7, b=4, h=128, w=128))
    out1 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    out2 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(out1, out2) and not torch.equal(out1, pipe.device_apply(x))


def test_draws_must_match_the_random_ops():
    stage = tdevice.build_device_fn([tspec.HorizontalFlip(), tspec.HueSaturationValue(),
                                     tspec.Normalize()])
    with pytest.raises(ValueError, match="1 draws for 2 random ops"):
        stage(torch.zeros(2, 4, 4, 3, dtype=torch.uint8), draws=[{"gate": torch.ones(2)}])
    with pytest.raises(NotImplementedError, match="Blur is not a device op of nkbx"):
        tspec.Compose([type("Blur", (tspec.Transform,), {"stage": tspec.DEVICE})(),
                       tspec.Normalize()])
