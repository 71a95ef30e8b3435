"""The port's counterparts of two of nkbx's Pallas probes under experiments/,
on the CPU, and the masked BatchNorm step they serve.

- X1, ``nkbx_torch.ops.matmul_bn``: the plain version (what
  ``fused_matmul_bn_relu_stats`` computes on CPU tensors) against the
  probe's Pallas kernel in interpret mode and its XLA twin, from the same
  numpy inputs: f32 (2048, 128 -> 256) with tile_rows 512, y 1e-3 absolute
  and the sums 1e-5 relative (the probe's own test); bf16, y within one
  bf16 ulp of each value (f32 accumulations in another order round to the
  other neighbour) and the sums 1e-3 relative (plus 1e-6 of the largest
  sum, for a channel the relu all but empties); the relu case of the probe's
  test; the N % tile_rows refusal.
- X2, ``nkbx_torch.ops.grouped_conv``: the port's ``build_wvec`` equals the
  probe's; the plain version against ``gconv_pallas`` in interpret mode and
  ``gconv_xla`` at the probe's check shapes (gw = 4 and 8, C = 8 gw, x
  (2, 8, 8, C)), f32 1e-4; in bf16 within one bf16 ulp; and against the
  library's grouped convolution (``F.conv2d(groups=)``) on the CPU.
- A small ResNet's train step with ``masked_bn=True`` on a batch with padded
  rows equals the exact-BN step on its valid rows alone, from the same
  weights: loss, running statistics, gradients and updated weights.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import pallas_fused_matmul_bn as jmb  # noqa: E402
import r3_grouped_conv_vpu as jgc  # noqa: E402
from nkbx_torch.models import get_model  # noqa: E402
from nkbx_torch.ops import grouped_conv as tgc  # noqa: E402
from nkbx_torch.ops import matmul_bn as tmb  # noqa: E402
from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer  # noqa: E402
from nkbx_torch.transforms import Compose, Normalize  # noqa: E402


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


# --- X1: matmul + BN-apply + relu + statistics --------------------------------------


def _mb_inputs(n=2048, cin=128, cout=256):
    r = np.random.default_rng(0)
    return (r.normal(size=(n, cin)).astype(np.float32),
            (r.normal(size=(cin, cout)) * 0.05).astype(np.float32),
            r.uniform(0.5, 2, cout).astype(np.float32), r.normal(size=cout).astype(np.float32))


@pytest.mark.parametrize("twin", ["pallas", "xla"])
def test_matmul_bn_plain_matches_the_probe_in_f32(twin):
    x, w, scale, bias = _mb_inputs()
    jargs = [_to_jax(a, jnp.float32) for a in (x, w, scale, bias)]
    if twin == "pallas":
        want = jmb.fused_matmul_bn_relu_stats(*jargs, tile_rows=512, interpret=True)
    else:
        want = jax.jit(jmb.reference_matmul_bn_relu_stats)(*jargs)
    y, s, q = tmb.fused_matmul_bn_relu_stats(*(torch.from_numpy(a) for a in (x, w, scale, bias)),
                                             tile_rows=512)
    assert y.dtype == torch.float32 and s.dtype == q.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want[0]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(s), _np(want[1]), rtol=1e-5)
    np.testing.assert_allclose(_np(q), _np(want[2]), rtol=1e-5)


@pytest.mark.parametrize("twin", ["pallas", "xla"])
def test_matmul_bn_plain_matches_the_probe_in_bf16(twin):
    x, w, scale, bias = _mb_inputs()
    jargs = [_to_jax(x, jnp.bfloat16), _to_jax(w, jnp.bfloat16), jnp.asarray(scale),
             jnp.asarray(bias)]
    if twin == "pallas":
        want = jmb.fused_matmul_bn_relu_stats(*jargs, tile_rows=512, interpret=True)
    else:
        want = jax.jit(jmb.reference_matmul_bn_relu_stats)(*jargs)
    y, s, q = tmb.fused_matmul_bn_relu_stats(_to_torch(x, torch.bfloat16),
                                             _to_torch(w, torch.bfloat16),
                                             torch.from_numpy(scale), torch.from_numpy(bias),
                                             tile_rows=512)
    assert y.dtype == torch.bfloat16
    got, ref = _np(y), _np(want[0])
    assert (np.abs(got - ref) <= _bf16_ulp(ref)).all()
    for got_sum, want_sum in ((s, want[1]), (q, want[2])):
        ref = _np(want_sum)
        np.testing.assert_allclose(_np(got_sum), ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max())


def test_matmul_bn_relu_zeroes_a_negative_product():
    """The probe's relu case: x = -1, w = I, scale 1, bias 0."""
    args = (torch.full((512, 128), -1.0), torch.eye(128), torch.ones(128), torch.zeros(128))
    y, s, q = tmb.fused_matmul_bn_relu_stats(*args, tile_rows=512)
    jy, js, _ = jmb.fused_matmul_bn_relu_stats(*(jnp.asarray(a.numpy()) for a in args),
                                               tile_rows=512, interpret=True)
    assert float(y.max()) == 0.0 and float(s.max()) == 0.0 and float(q.max()) == 0.0
    assert float(jnp.max(jy)) == 0.0 and float(jnp.max(js)) == 0.0


def test_matmul_bn_refuses_rows_off_the_tile():
    """N % tile_rows != 0 raises in the port, as the probe asserts."""
    x, w, scale, bias = _mb_inputs(n=1000)
    with pytest.raises(ValueError, match="tile_rows"):
        tmb.fused_matmul_bn_relu_stats(*(torch.from_numpy(a) for a in (x, w, scale, bias)),
                                       tile_rows=512)
    with pytest.raises(AssertionError):
        jmb.fused_matmul_bn_relu_stats(*(jnp.asarray(a) for a in (x, w, scale, bias)),
                                       tile_rows=512, interpret=True)
    with pytest.raises(ValueError, match="Cout"):
        tmb.fused_matmul_bn_relu_stats(torch.zeros(8, 4), torch.zeros(4, 6), torch.ones(5),
                                       torch.ones(6), tile_rows=8)


# --- X2: the 3x3 grouped convolution ------------------------------------------------


def _gc_inputs(gw, seed=0, shape=(2, 8, 8)):
    r = np.random.RandomState(seed)
    c = 8 * gw
    return (r.randn(*shape, c).astype(np.float32),
            (r.randn(3, 3, gw, c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("gw", [1, 4, 8, 32])
def test_build_wvec_is_the_probes(gw):
    _, w = _gc_inputs(gw)
    want = np.asarray(jgc.build_wvec(jnp.asarray(w), gw))
    np.testing.assert_array_equal(tgc.build_wvec(torch.from_numpy(w), gw).numpy(), want)


@pytest.mark.parametrize("twin", ["pallas", "xla"])
@pytest.mark.parametrize("gw", [4, 8])
def test_gconv_plain_matches_the_probe(gw, twin):
    x, w = _gc_inputs(gw)
    wvec = jgc.build_wvec(jnp.asarray(w), gw)
    if twin == "pallas":
        want = jgc.gconv_pallas(jnp.asarray(x), wvec, gw, interpret=True)
    else:
        want = jgc.gconv_xla(jnp.asarray(x), jnp.asarray(w), x.shape[-1] // gw)
    got = tgc.gconv(torch.from_numpy(x), tgc.build_wvec(torch.from_numpy(w), gw), gw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gw", [4, 8])
def test_gconv_plain_matches_the_probe_in_bf16(gw):
    """bf16 x and weights, f32 accumulation, out rounded to bf16 on both sides."""
    x, w = _gc_inputs(gw, seed=1)
    jw = jnp.asarray(w, jnp.bfloat16)
    want = jgc.gconv_pallas(jnp.asarray(x, jnp.bfloat16), jgc.build_wvec(jw, gw), gw,
                            interpret=True)
    tw = _to_torch(w, torch.bfloat16)
    got = tgc.gconv(_to_torch(x, torch.bfloat16), tgc.build_wvec(tw, gw), gw)
    assert got.dtype == torch.bfloat16
    ref = _np(want)
    assert (np.abs(_np(got) - ref) <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("b,h,w,gw", [(2, 8, 8, 4), (1, 7, 7, 32), (3, 5, 9, 2)])
def test_gconv_plain_matches_the_library_grouped_convolution(b, h, w, gw):
    """F.conv2d with C / gw groups on the channels-last NCHW view, f32."""
    x, wt = _gc_inputs(gw, seed=2, shape=(b, h, w))
    xt, wt = torch.from_numpy(x), torch.from_numpy(wt)
    got = tgc.gconv(xt, tgc.build_wvec(wt, gw), gw)
    want = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1,
                    groups=x.shape[-1] // gw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgc.conv2d_grouped(xt, wt, gw).numpy(), want.numpy(), rtol=0,
                               atol=0)


def test_gconv_refuses_what_it_cannot_take():
    x = torch.zeros(1, 4, 4, 24)
    with pytest.raises(ValueError, match="power of two"):
        tgc.gconv(x, torch.zeros(27, 24), 3)
    with pytest.raises(ValueError, match="wvec"):
        tgc.gconv(x, torch.zeros(9, 24), 4)


def test_kernel_wrappers_need_the_card():
    """On CPU tensors the wrappers take the plain versions and count nothing;
    the probes' command-line entries run on the card unless asked for the CPU."""
    before = tmb.fused_matmul_bn_relu_stats.launches, tgc.gconv.launches
    tmb.fused_matmul_bn_relu_stats(torch.ones(16, 16), torch.eye(16), torch.ones(16),
                                   torch.zeros(16), tile_rows=16)
    tgc.gconv(torch.ones(1, 3, 3, 32), torch.ones(36, 32), 4)
    assert (tmb.fused_matmul_bn_relu_stats.launches, tgc.gconv.launches) == before
    if not torch.cuda.is_available():
        for entry in (tmb.main, tgc.main, tmb.check, tgc.check):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                entry()


# --- masked BatchNorm: a padded batch equals its valid rows -------------------------

SGD = {"type": "sgd", "lr": 0.05, "weight_decay": 1e-4}


def _step(name, masked_bn, images, labels, mask, size):
    model = get_model({"model": name}, list("abc"), input_size=(size, size), seed=0,
                      device="cpu", dtype=torch.float32)
    state = TrainState.create(model, seed=0)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                            augment_fn=Compose([Normalize()]).device_apply, masked_bn=masked_bn)
    grads = {}
    state, metrics = step(state, images, labels, mask, 1.0, 1.0)
    for n, p in model.module.named_parameters():
        grads[n] = p.grad.clone()
    return float(metrics["loss"]), grads, model.module.state_dict()


@pytest.mark.parametrize("name", ["resnet_tiny_test", "resnet14t"])
def test_masked_bn_step_equals_the_exact_step_on_the_valid_rows(name):
    """One f32 SGD step of a small ResNet: ``masked_bn=True`` on a batch of 6
    whose last 2 rows are padding (random pixels, which must not count)
    against ``masked_bn=False`` on the 4 valid rows alone, from the same
    weights. Loss 1e-5 relative; each gradient 1e-4 of its largest value;
    running statistics and updated weights 1e-5 (+ 1e-5 relative): the two
    differ only in the order of f32 sums."""
    size, valid = 32, 4
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (6, size, size, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 3, 6))
    mask = torch.arange(6) < valid
    loss_m, grads_m, sd_m = _step(name, True, images, labels, mask, size)
    loss_e, grads_e, sd_e = _step(name, False, images[:valid], labels[:valid],
                                  torch.ones(valid, dtype=torch.bool), size)
    assert loss_m == pytest.approx(loss_e, rel=1e-5)
    for n, g in grads_e.items():
        scale = float(g.abs().max())
        assert float((grads_m[n] - g).abs().max()) <= 1e-4 * max(scale, 1e-6), n
    for k, v in sd_e.items():
        np.testing.assert_allclose(sd_m[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
