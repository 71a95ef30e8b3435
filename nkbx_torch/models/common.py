"""Shared building blocks of the port's backbones (counterpart of
``nkbx/models/common.py``).

Parameters are float32; each module computes in its ``dtype`` (bf16 on the
card), casting weights at use, as flax's ``param_dtype=float32,
dtype=bfloat16`` does. Initialisers take an explicit ``torch.Generator`` and
follow flax's defaults (lecun-normal Dense/Conv kernels, zero biases).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nkbx_torch.ops.mlp import fused_ln_mlp, fused_mlp, fused_mlp_mode, reference_ln_mlp
from nkbx_torch.parallel import collectives


class LayerNorm(nn.Module):
    """LayerNorm with flax semantics (flax 0.12 ``use_fast_variance=True``):
    f32 statistics, variance E[x²]−μ² clamped at 0, ``(x−μ)·(rsqrt(var+ε)·
    scale) + bias`` in f32, cast to ``dtype``. ``torch.nn.LayerNorm`` uses the
    two-pass variance and is not this."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax ``lecun_normal``: a normal truncated at ±2σ, scaled so that the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``nn.Dense`` with f32
    params): weight (out, in), the transpose of flax's kernel (in, out)."""

    def __init__(self, features_in: int, features_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(features_in, features_out, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def mlp_tail(x, shortcut, norm: LayerNorm, fc1: Dense, fc2: Dense, *, flag, auto: bool = True,
             gamma=None, drop_rate: float = 0.0, train: bool = False):
    """Transformer-block MLP half, ``shortcut + [gamma *] MLP(norm(x))``,
    with one dispatch point (:func:`nkbx_torch.ops.mlp.fused_mlp_mode`), as
    nkbx's ``mlp_tail`` (common.py:249-298): the fused LN-MLP kernels
    (``"ln"``), the MLP-only kernels after the plain LayerNorm (``"mlp"``),
    or the plain version (None). ``auto`` is the family's default for
    ``flag=None``. With ``drop_rate`` above 0 in training, the
    :func:`dropout` between the two Denses is active and the plain version
    runs (the kernels draw no random numbers), as in nkbx."""
    dt = fc1.dtype
    if drop_rate > 0 and train:
        y = fc2(dropout(F.gelu(fc1(norm(x))), drop_rate))
        return shortcut + (y if gamma is None else y * gamma.to(y.dtype))
    w0 = fc1.weight.t().to(dt).contiguous()
    w1 = fc2.weight.t().to(dt).contiguous()
    mode = fused_mlp_mode(flag, x, w0.shape[1], auto)
    if mode == "mlp":
        y = fused_mlp(norm(x), w0, fc1.bias, w1, fc2.bias)
        return shortcut + (y if gamma is None else y * gamma.to(y.dtype))
    args = (x, norm.weight, norm.bias, w0, fc1.bias, w1, fc2.bias, shortcut)
    if mode == "ln":
        return fused_ln_mlp(*args, gamma=gamma, eps=norm.eps)
    return reference_ln_mlp(*args, gamma=gamma, eps=norm.eps)


_replay = threading.local()  # .depth > 0 on the thread where remat replays a forward
_draws = threading.local()  # .generator: the train step's source of dropout masks


@contextlib.contextmanager
def dropout_source(generator: torch.Generator):
    """Draw every dropout mask of the block from ``generator`` (the train
    step's ``state.generator``, nkbx's per-step dropout key): a run is then
    fixed by its seed and a resumed run draws what the uninterrupted one
    draws. Under a data-parallel step (:mod:`nkbx_torch.parallel`) a mask
    whose first dimension is the batch is drawn for the global batch and
    the rank keeps its rows, as the device stage does, so that a world of N
    draws what a world of 1 draws. Outside such a block a mask is drawn as
    ``torch.nn.Dropout`` draws it, from torch's global generator."""
    prev = getattr(_draws, "generator", None)
    _draws.generator = generator
    try:
        yield
    finally:
        _draws.generator = prev


def keep_mask(shape, keep_prob: float, device, batched: bool = True) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each element True with
    probability ``keep_prob``: from the :func:`dropout_source` generator
    where one is installed (``batched``: the first dimension is the batch's,
    drawn for the global batch under a data-parallel step), else from
    torch's global generator."""
    gen = getattr(_draws, "generator", None)
    if gen is None:
        return torch.rand(shape, device=device) < keep_prob
    shape, mesh = tuple(shape), collectives.active()
    if batched and mesh is not None:
        u = torch.rand((shape[0] * mesh.data,) + shape[1:], generator=gen,
                       device=gen.device)[mesh.rows(shape[0])]
    else:
        u = torch.rand(shape, generator=gen, device=gen.device)
    return (u < keep_prob).to(device)


def dropout(x: torch.Tensor, p: float, training: bool = True) -> torch.Tensor:
    """torch's dropout of ``x`` (each element kept with probability 1 − p
    and scaled by 1/(1 − p)), its mask from :func:`keep_mask`: the train
    step's generator inside :func:`dropout_source`, ``F.dropout`` outside."""
    if not training or p == 0:
        return x
    if getattr(_draws, "generator", None) is None:
        return F.dropout(x, p, training=True)
    if p >= 1:
        return x * 0
    return x * keep_mask(x.shape, 1.0 - p, x.device) * (1.0 / (1.0 - p))


class Dropout(nn.Module):
    """``torch.nn.Dropout`` whose mask comes from :func:`dropout` (the train
    step's generator inside :func:`dropout_source`)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p, self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"


@contextlib.contextmanager
def _recompute(gen=None, state=None):
    """A remat replay: BatchNorm updates nothing, and where the forward drew
    its dropout masks from ``gen`` (at ``state``), the replay draws them
    again from there and leaves ``gen`` where it found it."""
    _replay.depth = getattr(_replay, "depth", 0) + 1
    if gen is not None:
        now, prev = gen.get_state(), getattr(_draws, "generator", None)
        gen.set_state(state)
        _draws.generator = gen
    try:
        yield
    finally:
        _replay.depth -= 1
        if gen is not None:
            gen.set_state(now)
            _draws.generator = prev


def remat(module: nn.Module, *args):
    """``module(*args)`` whose activations are recomputed in the backward
    (nkbx's ``nn.remat`` over a stage's blocks): ``torch.utils.checkpoint``
    with ``use_reentrant=False``, so that parameter names and numbers do not
    change. The replay updates no BatchNorm running statistics
    (:meth:`TorchBatchNorm.update_running` skips while it runs): the forward
    updated them once, as flax's remat keeps one update. A dropout mask
    drawn inside from the train step's generator is drawn again the same in
    the replay, which does not advance the generator (``checkpoint`` itself
    restores only torch's default generators). Without gradients the module
    just runs."""
    if not torch.is_grad_enabled():
        return module(*args)
    gen = getattr(_draws, "generator", None)
    state = gen.get_state() if gen is not None else None
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(gen, state)))


def init_dense_(module: nn.Linear, generator: torch.Generator):
    lecun_normal_(module.weight.data, module.weight.shape[1], generator)
    if module.bias is not None:
        module.bias.data.zero_()


def init_conv_(conv: nn.Conv2d, generator: torch.Generator):
    """flax ``nn.Conv``'s defaults: a lecun-normal kernel (fan-in kh·kw·in/groups)
    and a zero bias."""
    w = conv.weight
    lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
    if conv.bias is not None:
        conv.bias.data.zero_()


class TorchBatchNorm(nn.Module):
    """nkbx's BatchNorm (nkbx/models/common.py:52-141) over the last dim of x.

    f32 statistics with the fast variance E[x²]−μ² clamped at 0; the output
    ``(x − μ)·(rsqrt(var + ε)·scale) + bias`` in f32, cast to ``dtype`` (x's
    dtype when None). Eval mode normalises with the running statistics.
    Training updates them as torch does, with the unbiased variance: EMA
    ``momentum·old + (1 − momentum)·new``. Three modes in training:

    - exact: statistics over every row;
    - masked: ``mask`` (broadcastable to x, e.g. (B, 1, 1, 1)) weights padded
      rows out; n = unmasked elements / C;
    - ghost (``ghost_bn=g``): statistics per group of g consecutive rows over
      (g, spatial); the running statistics take the mean of the groups'
      (unbiased with n = g·spatial); g must divide the batch and a mask
      raises, as in nkbx.

    Under a data-parallel train step (:mod:`nkbx_torch.parallel`) the batch
    is the global one, as under nkbx's mesh: exact and masked statistics sum
    the f32 (Σx, Σx², count) over every rank, differentiably, so the
    backward sums too; ghost groups stay on their rank (g must divide the
    rank's rows), and the running statistics take the mean over every
    rank's groups (summed after the backward, in one all-reduce for the
    whole step). The running statistics advance identically on every rank.
    Eval mode uses no collective.

    Parameters ``weight`` (flax ``scale``) and ``bias`` and buffers
    ``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``)
    are f32."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype=None, ghost_bn: int = 0):
        super().__init__()
        self.momentum, self.eps, self.dtype, self.ghost_bn = momentum, eps, dtype, ghost_bn
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self):
        for t, v in ((self.weight, 1.0), (self.bias, 0.0), (self.running_mean, 0.0),
                     (self.running_var, 1.0)):
            t.data.fill_(v)

    @torch.no_grad()
    def update_running(self, mean, unbiased_var):
        """EMA of the running statistics toward ``mean`` and ``unbiased_var``;
        nothing while :func:`remat` replays a forward."""
        if getattr(_replay, "depth", 0):
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased_var)

    @torch.no_grad()
    def update_running_groups(self, gmean, unbiased_gvar):
        """:meth:`update_running` toward the mean over the (groups, C)
        statistics of every rank's ghost groups or chain tiles, in a
        data-parallel step: the sums wait for the step's one
        :func:`collectives.flush` (the forward does not read the running
        statistics), which applies the updates in order."""
        if getattr(_replay, "depth", 0):
            return
        c = gmean.shape[-1]
        tot = torch.cat([gmean.sum(0), unbiased_gvar.sum(0),
                         torch.full((1,), float(gmean.shape[0]), device=gmean.device)])
        collectives.defer_sum(tot, lambda s: self.update_running(s[:c] / s[-1],
                                                                  s[c:2 * c] / s[-1]))

    def _global_moments(self, xf, mask):
        """(mean, var, n/(n-1)) over the rows of every rank, weighted by
        ``mask`` where given: the f32 sums (Σx, Σx², count) of this rank's
        rows, summed over the ranks by :func:`collectives.sum_across_ranks`."""
        axes = tuple(range(xf.dim() - 1))
        c = xf.shape[-1]
        if mask is None:
            s1, s2 = xf.sum(axes), (xf * xf).sum(axes)
            count = torch.full((c,), float(math.prod(xf.shape[:-1])), device=xf.device)
        else:
            where = torch.broadcast_to(mask.to(torch.bool), xf.shape)
            s1 = torch.where(where, xf, 0.0).sum(axes)
            s2 = torch.where(where, xf * xf, 0.0).sum(axes)
            count = where.sum(axes, dtype=torch.float32)
        tot = collectives.sum_across_ranks(torch.cat([s1, s2, count]))
        s1, s2, count = tot[:c], tot[c:2 * c], tot[2 * c:]
        mean = s1 / count
        var = torch.clamp(s2 / count - mean * mean, min=0)
        n = count.detach()
        return mean, var, n / torch.clamp(n - 1.0, min=1.0)

    def forward(self, x, mask=None):
        dtype = self.dtype or x.dtype
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif self.ghost_bn:
            if mask is not None:
                raise ValueError("ghost_bn is incompatible with masked (padded) batches — "
                                 "use drop_last=True with the max-throughput recipe")
            b, g = x.shape[0], self.ghost_bn
            if b % g:
                mesh = collectives.active()
                if mesh is not None:
                    raise ValueError(f"ghost BN under a {mesh.data}-rank data axis needs the "
                                     f"batch B={b * mesh.data} divisible by "
                                     f"ndev*ghost_bn={mesh.data * g}")
                raise ValueError(f"ghost_bn={g} must divide the batch ({b})")
            xg = xf.reshape((b // g, g) + tuple(x.shape[1:]))
            axes = tuple(range(1, xg.dim() - 1))  # (g, spatial) per group
            gmean = xg.mean(axes)
            gvar = torch.clamp((xg * xg).mean(axes) - gmean * gmean, min=0)
            n = float(g * math.prod(x.shape[1:-1]))
            if collectives.active() is None:
                self.update_running(gmean.detach().mean(0),
                                    (gvar.detach() * (n / max(n - 1.0, 1.0))).mean(0))
            else:
                self.update_running_groups(gmean.detach(),
                                           gvar.detach() * (n / max(n - 1.0, 1.0)))
            inv = torch.rsqrt(gvar + self.eps) * self.weight
            bshape = (b // g,) + (1,) * (xg.dim() - 2) + (x.shape[-1],)
            y = (xg - gmean.reshape(bshape)) * inv.reshape(bshape) + self.bias
            return y.reshape(x.shape).to(dtype)
        elif collectives.active() is not None:
            mean, var, unbias = self._global_moments(xf, mask)
            self.update_running(mean.detach(), var.detach() * unbias)
        else:
            axes = tuple(range(x.dim() - 1))
            if mask is None:
                mean = xf.mean(axes)
                var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0)
                n = float(math.prod(x.shape[:-1]))
                unbias = n / max(n - 1.0, 1.0)
            else:
                where = torch.broadcast_to(mask.to(torch.bool), x.shape)
                count = where.sum(axes, dtype=torch.float32)
                mean = torch.where(where, xf, 0.0).sum(axes) / count
                var = torch.clamp(torch.where(where, xf * xf, 0.0).sum(axes) / count
                                  - mean * mean, min=0)
                n = where.sum(dtype=torch.float32) / x.shape[-1]
                unbias = n / torch.clamp(n - 1.0, min=1.0)
            self.update_running(mean.detach(), var.detach() * unbias)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(dtype)


class ConvBN(nn.Module):
    """Conv (no bias) + :class:`TorchBatchNorm` + an optional activation on
    NHWC x (nkbx/models/common.py:144-191), with torch-style symmetric k//2
    padding and groups (``groups=features_in`` is the depthwise conv of the
    mobile families). ``act``: True for relu, False for none, or a function
    (:func:`hard_swish`, ``F.silu``). The convolution computes in ``dtype`` on
    the channels-last NCHW view ``x.permute(0, 3, 1, 2)``. ``mask`` reaches
    the BatchNorm in training only."""

    def __init__(self, features_in: int, features: int, kernel_size: int = 3,
                 strides: int = 1, groups: int = 1, act=True, dtype=torch.float32,
                 ghost_bn: int = 0):
        super().__init__()
        self.dtype, self.act = dtype, act
        self.Conv_0 = nn.Conv2d(features_in, features, kernel_size, stride=strides,
                                padding=kernel_size // 2, groups=groups, bias=False)
        self.BatchNorm_0 = TorchBatchNorm(features, dtype=dtype, ghost_bn=ghost_bn)

    def forward(self, x, mask=None):
        c = self.Conv_0
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), c.weight.to(self.dtype),
                     stride=c.stride, padding=c.padding, groups=c.groups)
        y = self.BatchNorm_0(y.permute(0, 2, 3, 1), mask=mask if self.training else None)
        if self.act is True:
            return torch.relu(y)
        return self.act(y) if self.act else y


def make_divisible(v, divisor=8):
    """Channel rounding shared by the mobile families (timm convention;
    nkbx common.py:194-199)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


class SqueezeExcite(nn.Module):
    """nkbx's SqueezeExcite (common.py:214-231): the global pool in f32, cast
    to x's dtype, a 1x1 ``Conv_0`` to ``reduced`` channels, ``act`` (relu for
    MobileNetV3, swish for EfficientNet), a 1x1 ``Conv_1`` back, and x times
    ``gate`` of it; the convolutions with biases, in ``dtype``."""

    def __init__(self, channels: int, reduced: int, gate=hard_sigmoid, act=torch.relu,
                 dtype=torch.float32):
        super().__init__()
        self.gate, self.act, self.dtype = gate, act, dtype
        self.Conv_0 = nn.Conv2d(channels, reduced, 1)
        self.Conv_1 = nn.Conv2d(reduced, channels, 1)

    def _fc(self, s, conv):
        dt = self.dtype
        return F.linear(s.to(dt), conv.weight.reshape(conv.weight.shape[:2]).to(dt),
                        conv.bias.to(dt))

    def forward(self, x):
        s = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        s = self._fc(self.act(self._fc(s, self.Conv_0)), self.Conv_1)
        return x * self.gate(s)


def global_avg_pool(x):
    """Mean over H and W of NHWC x, summed in f32 and cast back to x's dtype
    (``jnp.mean`` on bf16)."""
    return x.float().mean((1, 2)).to(x.dtype)
