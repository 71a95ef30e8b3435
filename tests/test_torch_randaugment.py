"""The port's RandAugment and TrivialAugmentWide against nkbx's, on the CPU.

Both device stages run on the same uint8 batches (B = 8, 20x28 unless
stated), the port fed the draws nkbx made from its key (the gate, then per
round each sample's op, grid and sign, and each grid's op and sign;
TrivialAugmentWide also the magnitude bins), as tests/test_torch_augment.py
feeds the other random ops.

- Each of the 14 ops: a round of RandAugment(num_ops=1, p=1) through nkbx's
  applier, compared on the samples that drew the op. Equalize, posterize,
  solarize, identity and the nearest-neighbour warps are equal: the pixels
  whose source coordinate lies within 1e-4 of a .5 tie (where an ulp of
  the affine arithmetic may pick the other neighbour) are counted and left
  out, and none is expected. The blends (brightness, colour, contrast),
  sharpness and autocontrast are within 1e-3 on the 0-255 scale.
- Equalize's edge cases against nkbx's and PIL's ``ImageOps.equalize``: a
  constant plane, a single non-empty bin, a step of 0, a general plane.
- The magnitude arithmetic of both policies against nkbx's f32 formulas
  (``_ra_affine_specs``, ``_taw_affine_specs``, ``_taw_point_mags``) and
  torchvision's posterize bits.
- RandAugment num_ops = 2 round by round, each round from the same input on
  both sides, and whole; TrivialAugmentWide; the gate.
- configs/modern_recipe_config.py's whole train pipeline against nkbx's
  ``build_device_fn``; the port's own draws in range and repeatable.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from nkbx.transforms import device as jdevice
from nkbx.transforms import spec as jspec
from nkbx.utils import load_config as jload_config
from nkbx_torch.transforms import device as tdevice
from nkbx_torch.transforms import spec as tspec
from nkbx_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-3  # on the 0-255 scale
TIE = 1e-4  # a source coordinate this close to a .5 tie may round either way
B, H, W = 8, 20, 28
OP_NAMES = ["identity", "shear_x", "shear_y", "translate_x", "translate_y", "rotate",
            "brightness", "color", "contrast", "sharpness", "posterize", "solarize",
            "autocontrast", "equalize"]


def _images(seed=0, b=B, h=H, w=W):
    """uint8 images with a constant plane (sample 0, red), a plane of two
    values (sample 1, green) and a dark, low-contrast sample (2)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    x[0, :, :, 0] = 77
    x[1, :, :, 1] = np.where(rng.random((h, w)) < 0.3, 10, 200)
    x[2] = rng.integers(30, 60, (h, w, 3))
    return x


def _policy_draws(t, key, b):
    """The draws nkbx's RandAugment / TrivialAugmentWide applier makes from
    ``key`` (device.py:466-646), in the port's layout."""
    is_ra = isinstance(t, jspec.RandAugment)
    k_gate, key = jax.random.split(key)
    gate = np.asarray(jax.random.uniform(k_gate, (b, 1, 1, 1)) < t.p).reshape(b)
    rkeys = list(jax.random.split(key, t.num_ops)) if is_ra and t.num_ops > 1 else [key]
    k = t.num_affine_grids
    rows = {n: [] for n in ("op", "grid", "sign", "grid_op", "grid_sign", "mag", "grid_mag")}

    def signs(kk, n):
        return np.where(np.asarray(jax.random.bernoulli(kk, 0.5, (n,))), 1.0, -1.0)

    for rk in rkeys:
        k_op, k_assign, k_point, k_aff = jax.random.split(rk, 4)
        rows["op"].append(np.asarray(jax.random.randint(k_op, (b,), 0, 14)))
        rows["grid"].append(np.asarray(jax.random.randint(k_assign, (b,), 0, k)))
        if is_ra:
            rows["sign"].append(signs(k_point, b))
            ka_op, ka_sign = jax.random.split(k_aff)
        else:
            k_mag, k_sign = jax.random.split(k_point)
            rows["mag"].append(np.asarray(jax.random.randint(k_mag, (b,), 0,
                                                             t.num_magnitude_bins)))
            rows["sign"].append(signs(k_sign, b))
            ka_op, ka_mag, ka_sign = jax.random.split(k_aff, 3)
            rows["grid_mag"].append(np.asarray(jax.random.randint(ka_mag, (k,), 0,
                                                                  t.num_magnitude_bins)))
        rows["grid_op"].append(np.asarray(jax.random.randint(ka_op, (k,), 1, 6)))
        rows["grid_sign"].append(signs(ka_sign, k))
    out = {"gate": torch.from_numpy(gate.copy())}
    for name, vals in rows.items():
        if vals:
            dtype = torch.float32 if "sign" in name else torch.int64
            out[name] = torch.from_numpy(np.stack(vals)).to(dtype)
    return out


def _port_spec(t):
    return getattr(tspec, type(t).__name__)(**{f: getattr(t, f) for f in t.__dataclass_fields__})


def _nkbx_apply(t, images, key):
    fn = jdevice._apply_randaugment if isinstance(t, jspec.RandAugment) else \
        jdevice._apply_trivialaugment
    return np.asarray(jax.jit(lambda x, k: fn(t, x, k))(jnp.asarray(images, jnp.float32), key))


def _port_apply(t, images, draws):
    return tdevice._apply_policy(_port_spec(t), torch.from_numpy(images).float(), draws).numpy()


def _tie_pixels(t, draws, r, sample):
    """The output pixels of ``sample`` in round ``r`` whose source row or
    column lies within TIE of a .5 tie (none for a pointwise op)."""
    return tdevice.policy_ties(_port_spec(t), draws, r, H, W, TIE)[sample].numpy()


def _seed_with_op(t, op, b=B):
    """The first key seed whose round-0 draws give ``op`` to some sample."""
    for seed in range(200):
        d = _policy_draws(t, jax.random.PRNGKey(seed), b)
        if (d["op"][0] == op).any():
            return seed, d
    raise AssertionError(f"no seed draws op {op}")


@pytest.mark.parametrize("op", range(14), ids=OP_NAMES)
def test_each_op_matches_nkbx(op):
    t = jspec.RandAugment(num_ops=1, magnitude=9, num_affine_grids=4, p=1.0)
    images = _images(op)
    seed, draws = _seed_with_op(t, op)
    want = _nkbx_apply(t, images, jax.random.PRNGKey(seed))
    got = _port_apply(t, images, draws)
    hit = np.flatnonzero(draws["op"][0].numpy() == op)
    ties = sum(int(_tie_pixels(t, draws, 0, i).sum()) for i in hit)
    assert ties == 0
    for i in hit:
        if op in tdevice.EXACT_OPS:
            np.testing.assert_array_equal(got[i], want[i], err_msg=OP_NAMES[op])
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=0, atol=TOL, err_msg=OP_NAMES[op])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if op != tdevice.IDENTITY and op not in (tdevice.AUTOCONTRAST, tdevice.EQUALIZE):
        assert any(not np.array_equal(got[i], images[i]) for i in hit)


def _pil_equalize(plane):
    return np.asarray(ImageOps.equalize(Image.fromarray(plane, mode="L")))


@pytest.mark.parametrize("case", ["constant", "one-bin-of-two", "step-0", "general",
                                  "general-64x96"])
def test_equalize_edge_cases_match_nkbx_and_pil(case):
    """At 64 x 96 the step (N − last) // 255 differs from a // 256 one."""
    rng = np.random.default_rng(3)
    planes = {
        "constant": np.full((H, W), 131, np.uint8),
        # 559 pixels at 255 and one at 0: the last bin holds all but one, so step = 0
        "one-bin-of-two": np.where(np.arange(H * W).reshape(H, W) == 0, 0, 255).astype(np.uint8),
        "step-0": np.where(rng.random((H, W)) < 0.9, 250, 3).astype(np.uint8),
        "general": rng.integers(0, 256, (H, W), dtype=np.uint8),
        "general-64x96": rng.integers(0, 256, (64, 96), dtype=np.uint8),
    }
    x = np.repeat(planes[case][None, :, :, None], 3, axis=-1)
    x[..., 1] = rng.integers(0, 256, x.shape[1:3])
    want = np.asarray(jdevice._ra_equalize(jnp.asarray(x, jnp.float32)))
    got = tdevice.equalize(torch.from_numpy(x).float()).numpy()
    np.testing.assert_array_equal(got, want)
    for c in range(3):
        np.testing.assert_array_equal(got[0, :, :, c], _pil_equalize(x[0, :, :, c]))
    if not case.startswith("general"):
        np.testing.assert_array_equal(got[0, :, :, 0], x[0, :, :, 0])  # PIL's identity cases


def test_randaugment_magnitudes_match_nkbx():
    t = jspec.RandAugment(num_ops=2, magnitude=9, num_affine_grids=4)
    d = _policy_draws(t, jax.random.PRNGKey(5), B)
    frac = t.magnitude / (t.num_magnitude_bins - 1)
    for r in range(2):
        point, grids = tdevice.randaugment_magnitudes(_port_spec(t), d, r, H, W)
        k_op, k_assign, k_point, k_aff = jax.random.split(
            jax.random.split(jax.random.split(jax.random.PRNGKey(5))[1], 2)[r], 4)
        want = jdevice._ra_affine_specs(k_aff, 4, H, W, frac)
        assert np.array_equal(grids["aop"].numpy(), np.asarray(want["aop"]))
        for mine, theirs in (("shear", "shear_v"), ("trans_x", "trans_x"), ("trans_y", "trans_y"),
                             ("rot_deg", "rot_deg")):
            np.testing.assert_array_equal(grids[mine].numpy(), np.asarray(want[theirs]))
        s = d["sign"][r].numpy()
        np.testing.assert_array_equal(point["color_v"].numpy(),
                                      np.float32(0.9 * frac) * s.astype(np.float32))
        assert (point["post_bits"] == 7).all()  # 8 - round(9 / 7.5)
        assert (point["solar_thr"] == np.float32(255.0 * (1 - frac))).all()
    # torchvision's posterize bits: 8 - (arange(bins) / ((bins - 1) / 4)).round()
    for m in range(31):
        spec = tspec.RandAugment(magnitude=m)
        point, _ = tdevice.randaugment_magnitudes(spec, d, 0, H, W)
        assert int(point["post_bits"][0]) == 8 - int(np.round(m / 7.5)), m


def test_trivialaugment_magnitudes_match_nkbx():
    t = jspec.TrivialAugmentWide(num_affine_grids=4)
    key = jax.random.split(jax.random.PRNGKey(6))[1]
    d = _policy_draws(t, jax.random.PRNGKey(6), 64)
    point, grids = tdevice.trivialaugment_magnitudes(_port_spec(t), d, 0)
    k_op, k_assign, k_point, k_aff = jax.random.split(key, 4)
    want_p = jdevice._taw_point_mags(k_point, 64, 31)
    want_g = jdevice._taw_affine_specs(k_aff, 4, 31)
    for mine, theirs in (("color_v", "color_v"), ("post_bits", "post_bits"),
                         ("solar_thr", "solar_thr")):
        np.testing.assert_array_equal(point[mine].numpy(), np.asarray(want_p[theirs]))
    for mine, theirs in (("shear", "shear_v"), ("trans_x", "trans_x"), ("trans_y", "trans_y"),
                         ("rot_deg", "rot_deg")):
        np.testing.assert_array_equal(grids[mine].numpy(), np.asarray(want_g[theirs]))
    bits = point["post_bits"].numpy()
    assert bits.min() == 2 and bits.max() == 8  # posterize down to 2 bits


def _nkbx_ra_round(t, x, key, h, w):
    """One RandAugment round of nkbx's (its closures of _apply_randaugment)."""
    frac = t.magnitude / max(t.num_magnitude_bins - 1, 1)
    pb = 8.0 - round(t.magnitude / ((t.num_magnitude_bins - 1) / 4))
    st = 255.0 * (1.0 - frac)

    def point_mags(k, bb):
        s = jnp.where(jax.random.bernoulli(k, 0.5, (bb,)), 1.0, -1.0)
        return {"color_v": 0.9 * frac * s, "post_bits": jnp.full((bb,), pb),
                "solar_thr": jnp.full((bb,), st)}

    def affine_specs(k):
        return jdevice._ra_affine_specs(k, t.num_affine_grids, h, w, frac)

    return np.asarray(jax.jit(lambda xx, kk: jdevice._policy_round(
        xx, kk, point_mags, affine_specs, t.num_affine_grids))(jnp.asarray(x), key))


def test_randaugment_two_rounds_match_nkbx_round_by_round():
    """Each round from the same input on both sides (nkbx's own output of
    the round before), then the whole op; nkbx's rounds composed equal its
    scan."""
    t = jspec.RandAugment(num_ops=2, magnitude=9, num_affine_grids=4, p=0.7)
    images = _images(11)
    key = jax.random.PRNGKey(12)
    d = _policy_draws(t, key, B)
    spec = _port_spec(t)
    rkeys = jax.random.split(jax.random.split(key)[1], 2)
    x = images.astype(np.float32)
    for r in range(2):
        want = _nkbx_ra_round(t, x, rkeys[r], H, W)
        point, grids = tdevice.randaugment_magnitudes(spec, d, r, H, W)
        got = tdevice.policy_round(torch.from_numpy(np.array(x)), d["op"][r], d["grid"][r], point,
                                   grids).numpy()
        ties = sum(int(_tie_pixels(t, d, r, i).sum()) for i in range(B))
        assert ties == 0
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        exact = np.isin(d["op"][r].numpy(), tdevice.EXACT_OPS)
        np.testing.assert_array_equal(got[exact], want[exact])
        x = want
    whole = _nkbx_apply(t, images, key)
    gate = d["gate"].numpy()
    assert 0 < gate.sum() < B
    np.testing.assert_array_equal(whole[gate], x[gate])
    np.testing.assert_array_equal(whole[~gate], images[~gate].astype(np.float32))
    np.testing.assert_allclose(_port_apply(t, images, d), whole, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trivialaugment_matches_nkbx(seed):
    t = jspec.TrivialAugmentWide(num_affine_grids=4, p=0.8)
    images = _images(20 + seed, b=16)
    key = jax.random.PRNGKey(30 + seed)
    d = _policy_draws(t, key, 16)
    want = _nkbx_apply(t, images, key)
    spec = _port_spec(t)
    got = tdevice._apply_policy(spec, torch.from_numpy(images).float(), d).numpy()
    ties = sum(int(_tie_pixels(t, d, 0, i).sum()) for i in range(16))
    assert ties == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    exact = np.isin(d["op"][0].numpy(), tdevice.EXACT_OPS) | ~d["gate"].numpy()
    np.testing.assert_array_equal(got[exact], want[exact])


def test_modern_recipe_train_pipeline_matches_nkbx():
    """configs/modern_recipe_config.py's device stage (RandAugment num_ops =
    2, magnitude 9, 4 grids, then Normalize) at 64 px: nkbx's
    build_device_fn against the port fed nkbx's draws (its key split over
    the one random op), 1e-3 on the 0-255 scale."""
    path = ROOT / "configs" / "modern_recipe_config.py"
    jpipe = jload_config(str(path)).train_pipeline.device_transforms
    tpipe = load_config(path).train_pipeline
    images = _images(13, b=16, h=64, w=64)
    key = jax.random.PRNGKey(14)
    want = np.asarray(jdevice.build_device_fn(jpipe)(jnp.asarray(images), key, True))
    (jra,) = [t for t in jpipe if isinstance(t, jspec.RandAugment)]
    draws = [_policy_draws(jra, jax.random.split(key, 1)[0], 16)]
    got = tpipe.device_apply(torch.from_numpy(images), draws=draws).numpy()
    std = 255.0 * np.asarray(jpipe[-1].std, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL / std.min())
    assert [type(t).__name__ for t in tpipe.device_transforms] == ["RandAugment", "Normalize"]


def test_generator_draws_are_in_range_and_repeatable():
    pipe = tspec.Compose([tspec.RandAugment(num_ops=2, num_affine_grids=3),
                          tspec.TrivialAugmentWide(num_magnitude_bins=11), tspec.Normalize()])
    stage = pipe.device_stage()
    shape = (512, 16, 16, 3)
    a = stage.draw(shape, torch.Generator().manual_seed(0))
    b = stage.draw(shape, torch.Generator().manual_seed(0))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    ra, taw = a
    assert ra["op"].shape == (2, 512) and taw["op"].shape == (1, 512)
    assert ra["grid_op"].shape == (2, 3) and "mag" not in ra
    for d, k in ((ra, 3), (taw, 4)):
        assert set(d["op"].flatten().tolist()) == set(range(14))
        assert set(d["grid"].flatten().tolist()) == set(range(k))
        assert set(d["sign"].flatten().tolist()) == {-1.0, 1.0}
        assert d["grid_op"].min() >= 1 and d["grid_op"].max() <= 5
    assert set(taw["mag"].flatten().tolist()) == set(range(11))
    x = torch.from_numpy(_images(15))
    out1 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    out2 = pipe.device_apply(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(out1, out2) and not torch.equal(out1, pipe.device_apply(x))
    rotated = tspec.Compose([tspec.Rotate(), tspec.Normalize()])  # A9 is whole: Rotate runs too
    assert [type(t).__name__ for t in rotated.device_stage().ops] == ["Rotate"]
