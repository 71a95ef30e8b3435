"""The port's mixup/CutMix (``nkbx_torch.train.mixup``) against nkbx's, on
the CPU.

The port's ``apply`` is fed the draws nkbx's ``mix`` makes from its key
(``apply``, ``use_cutmix``, the Beta draw of the mode taken, the box centre;
nkbx mixup.py:62-97). The mixup blend within 1e-6 of the batch's largest
value in f32 (two f32 products and a sum, which XLA may round in another
order), ``lam`` within 1e-6 relative (in bf16 the blend, made in f32 and
cast, equal); the CutMix box exact,
so the mixed batch is equal, and ``lam_adj`` within 1e-6 relative. Also:
prob 0 is the identity, the switch takes both modes, a padded row's partner
is itself, nkbx's error for a config with no alpha, the warning for a key
nkbx does not read (``mixup_alpha``, as configs/modern_recipe_config.py
passes it), and the port's Beta draws (from Gamma draws of the generator):
repeatable from a seed, in [0, 1], with Beta's mean and variance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nkbx.train.mixup import build_mixup as jbuild_mixup
from nkbx_torch.train.mixup import Mixup

SHAPE = (6, 12, 16, 3)


def _x(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 50 + 100


def _nkbx_draws(cfg, key, shape):
    """The draws nkbx's mix makes from ``key``, in the port's layout."""
    alpha, cutmix_alpha = float(cfg.get("alpha", 0.0)), float(cfg.get("cutmix_alpha", 0.0))
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    if alpha <= 0.0:
        use_cutmix = cutmix_alpha > 0.0
    elif cutmix_alpha > 0.0:
        use_cutmix = bool(jax.random.bernoulli(k_switch, float(cfg.get("switch_prob", 0.5))))
    else:
        use_cutmix = False
    a = cutmix_alpha if use_cutmix else alpha
    lam0 = jax.random.beta(k_lam_c if use_cutmix else k_lam_m, max(a, 1e-8), max(a, 1e-8))
    ky, kx = jax.random.split(k_box)
    return {"apply": torch.tensor(bool(jax.random.bernoulli(k_apply, float(cfg.get("prob", 1.0))))),
            "use_cutmix": torch.tensor(use_cutmix),
            "lam0": torch.tensor(np.float32(lam0)),
            "cy": torch.tensor(int(jax.random.randint(ky, (), 0, shape[1]))),
            "cx": torch.tensor(int(jax.random.randint(kx, (), 0, shape[2])))}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _both(cfg, seed, x, mask=None):
    key = jax.random.PRNGKey(seed)
    jm, jlam, jp = jbuild_mixup(cfg)(jnp.asarray(x), key,
                                     None if mask is None else jnp.asarray(mask))
    d = _nkbx_draws(cfg, key, x.shape)
    tm, tlam, tp = Mixup(cfg).apply(torch.from_numpy(x),
                                          None if mask is None else torch.from_numpy(mask), d)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    return (np.asarray(jm), float(jlam)), (tm.numpy(), float(tlam)), d


@pytest.mark.parametrize("seed", range(4))
def test_mixup_blend_matches_nkbx(seed):
    x = _x(seed)
    (jm, jlam), (tm, tlam), d = _both({"alpha": 0.4}, seed, x)
    assert not d["use_cutmix"] and d["apply"]
    assert tlam == pytest.approx(jlam, rel=1e-6) and 0 < tlam < 1
    _close(tm, jm)


def test_mixup_blend_in_bf16_equals_nkbx():
    x = _x(9)
    key = jax.random.PRNGKey(9)
    cfg = {"alpha": 0.2}
    jm, _, _ = jbuild_mixup(cfg)(jnp.asarray(x, jnp.bfloat16), key)
    tm, _, _ = Mixup(cfg).apply(torch.from_numpy(x).bfloat16(), None,
                                      _nkbx_draws(cfg, key, x.shape))
    assert tm.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm.float().numpy(), np.asarray(jm.astype(jnp.float32)))


@pytest.mark.parametrize("seed", range(4))
def test_cutmix_box_and_lam_match_nkbx(seed):
    x = _x(10 + seed)
    (jm, jlam), (tm, tlam), d = _both({"cutmix_alpha": 1.0}, seed, x)
    assert d["use_cutmix"]
    np.testing.assert_array_equal(tm, jm)
    assert tlam == pytest.approx(jlam, rel=1e-6)
    from_flip = (tm != x).any(-1).any(0)  # the box's pixels
    assert tlam == pytest.approx(1.0 - from_flip.mean(), abs=1e-6)


def test_prob_zero_is_the_identity():
    x = _x(3)
    for seed in range(3):
        (jm, jlam), (tm, tlam), d = _both({"alpha": 0.4, "cutmix_alpha": 1.0, "prob": 0.0},
                                          seed, x)
        assert not d["apply"] and tlam == jlam == 1.0
        np.testing.assert_array_equal(tm, x)
    out, lam, _ = Mixup({"alpha": 0.4, "prob": 0.0})(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, torch.from_numpy(x)) and float(lam) == 1.0


def test_the_switch_takes_both_modes():
    cfg = {"alpha": 0.4, "cutmix_alpha": 1.0, "switch_prob": 0.5}
    x = _x(4)
    modes = set()
    for seed in range(12):
        (jm, jlam), (tm, tlam), d = _both(cfg, seed, x)
        _close(tm, jm)
        assert tlam == pytest.approx(jlam, rel=1e-6)
        modes.add(bool(d["use_cutmix"]))
    assert modes == {True, False}
    mix, gen = Mixup(cfg), torch.Generator().manual_seed(0)
    drawn = {bool(mix.draw(SHAPE, gen)["use_cutmix"]) for _ in range(20)}
    assert drawn == {True, False}


@pytest.mark.parametrize("cfg", [{"alpha": 0.4}, {"cutmix_alpha": 1.0}], ids=["mixup", "cutmix"])
def test_a_padded_partner_leaves_the_row_unmixed(cfg):
    x = _x(5)
    mask = np.array([True, True, True, True, False, False])
    (jm, jlam), (tm, tlam), _ = _both(cfg, 1, x, mask)
    _close(tm, jm)
    _, _, partner = Mixup(cfg)(torch.from_numpy(x), torch.from_numpy(mask),
                                     generator=torch.Generator().manual_seed(0))
    assert partner.tolist() == [0, 1, 3, 2, 1, 0]  # rows 0 and 1 pair with padded rows
    _close(tm[:2], x[:2])  # lam·x + (1 − lam)·x, x to f32 rounding
    if "cutmix_alpha" in cfg:
        np.testing.assert_array_equal(tm[:2], x[:2])


def test_bad_config_raises_and_unread_keys_warn():
    with pytest.raises(ValueError, match="alpha > 0 and/or cutmix_alpha > 0"):
        Mixup({})
    with pytest.raises(ValueError, match="alpha"):
        jbuild_mixup({})
    with pytest.warns(UserWarning, match="'mixup_alpha' is ignored"):
        mix = Mixup({"mixup_alpha": 0.2, "cutmix_alpha": 1.0, "prob": 0.5})
    assert (mix.alpha, mix.cutmix_alpha, mix.prob) == (0.0, 1.0, 0.5)  # CutMix alone, as nkbx
    with pytest.raises(ValueError):
        Mixup({"mixup_alpha": 0.2})


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_draws_repeat_and_stay_in_range(alpha):
    mix = Mixup({"alpha": alpha})
    lams = []
    gen = torch.Generator().manual_seed(7)
    for _ in range(4000):
        lams.append(float(mix.draw(SHAPE, gen)["lam0"]))
    again = torch.Generator().manual_seed(7)
    assert [float(mix.draw(SHAPE, again)["lam0"]) for _ in range(50)] == lams[:50]
    lams = np.asarray(lams)
    assert lams.min() >= 0 and lams.max() <= 1
    assert abs(lams.mean() - 0.5) < 0.02
    assert lams.var() == pytest.approx(1 / (4 * (2 * alpha + 1)), rel=0.08)
    d = mix.draw(SHAPE, gen)
    assert d["cy"].dtype == torch.int64 and 0 <= int(d["cy"]) < SHAPE[1]
    assert 0 <= int(d["cx"]) < SHAPE[2]
