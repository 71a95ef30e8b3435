"""Mixup / CutMix on the batch in the train step (counterpart of
``nkbx/train/mixup.py``).

timm's batch mode, as nkbx runs it: one draw a step. With chance ``prob``
the batch is mixed, by CutMix (chance ``switch_prob`` where both alphas are
on) or by mixup, at one lam from Beta(alpha, alpha); each row mixes with the
row of the reversed batch, or with itself where that row is padded (masked
out), which leaves a padded partner's row unmixed. Under a data-parallel
step the batch is the global one: the draws are one for all ranks (the
generators stay in step), and a row's partner usually lives on another rank
(``peer``). CutMix pastes a box of
about (1 - lam) of the image, centred at a uniform pixel and clipped to the
image, and lam becomes one minus the box's true area. The loss is then
``lam * loss(labels) + (1 - lam) * loss(labels[partner])``.

The op is split as the device stage splits its ops: :meth:`Mixup.draw`
makes a step's draws from a generator on the device, :meth:`Mixup.apply`
mixes a batch with given draws (so that a test can feed the draws nkbx
made). Both mixes are computed and one is selected on the device, so nothing
waits on the host.
"""

from __future__ import annotations

import warnings

import torch

KEYS = ("alpha", "cutmix_alpha", "prob", "switch_prob")


def _beta(alpha: float, generator, device):
    """One Beta(alpha, alpha) draw as G1 / (G1 + G2) of two Gamma(alpha)
    draws from ``generator`` (0.5 where both underflow to 0)."""
    g = torch._standard_gamma(torch.full((2,), alpha, device=device), generator=generator)
    total = g.sum()
    return torch.where(total > 0, g[0] / torch.where(total > 0, total, 1.0), 0.5)


class Mixup:
    """``Mixup(cfg)``: ``cfg`` has timm's keys ``alpha`` (mixup's Beta, 0 is
    off), ``cutmix_alpha`` (0 is off), ``prob`` (default 1) and
    ``switch_prob`` (default 0.5). nkbx reads no other key: any other key
    (such as ``mixup_alpha``) warns that it is ignored, and the numbers stay
    nkbx's."""

    def __init__(self, cfg: dict):
        for key in cfg:
            if key not in KEYS:
                warnings.warn(f"mixup config key {key!r} is ignored: nkbx's mixup reads only "
                              f"{', '.join(KEYS)} (so does the port)")
        self.alpha = float(cfg.get("alpha", 0.0))
        self.cutmix_alpha = float(cfg.get("cutmix_alpha", 0.0))
        self.prob = float(cfg.get("prob", 1.0))
        self.switch_prob = float(cfg.get("switch_prob", 0.5))
        if self.alpha <= 0.0 and self.cutmix_alpha <= 0.0:
            raise ValueError("mixup config needs alpha > 0 and/or cutmix_alpha > 0")

    def draw(self, shape, generator: torch.Generator, device=None) -> dict:
        """A step's draws for a batch of ``shape`` (B, H, W, C): ``apply``
        (bool, chance ``prob``), ``use_cutmix`` (bool), ``lam0`` (f32, the
        Beta draw of the mode taken) and the box centre ``cy``, ``cx``
        (int64, uniform over the rows and columns)."""
        device = generator.device if device is None else device
        h, w = shape[1], shape[2]
        apply = torch.rand((), generator=generator, device=device) < self.prob
        if self.alpha <= 0.0:
            use_cutmix = torch.ones((), dtype=torch.bool, device=device)
        elif self.cutmix_alpha <= 0.0:
            use_cutmix = torch.zeros((), dtype=torch.bool, device=device)
        else:
            use_cutmix = torch.rand((), generator=generator, device=device) < self.switch_prob
        lams = [_beta(a, generator, device) for a in (self.alpha, self.cutmix_alpha) if a > 0.0]
        lam0 = lams[0] if len(lams) == 1 else torch.where(use_cutmix, lams[1], lams[0])
        cy = torch.randint(0, h, (), generator=generator, device=device)
        cx = torch.randint(0, w, (), generator=generator, device=device)
        return {"apply": apply, "use_cutmix": use_cutmix, "lam0": lam0.float(), "cy": cy,
                "cx": cx}

    def apply(self, x, mask, draws: dict, peer=None):
        """(mixed, lam, partner) of the NHWC batch ``x`` under ``draws``:
        ``mixed`` in ``x``'s dtype (mixup blends in f32), ``lam`` an f32
        scalar (1 where the step does not mix), ``partner`` the row each row
        mixed with.

        ``peer`` = (x, mask) of another rank's rows, under a data-parallel
        step: the global batch's reversal pairs this rank's rows with the
        reversed rows of rank N−1−r, which ``peer`` holds (a padded peer row
        leaves its partner unmixed). ``partner`` then indexes the rows of
        ``x`` followed by those of ``peer``."""
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        dev = x.device
        d = {k: v.to(dev) for k, v in draws.items()}
        rev = torch.arange(b - 1, -1, -1, device=dev)
        if peer is None:
            partner = rev if mask is None else torch.where(mask[rev].bool(), rev,
                                                           torch.arange(b, device=dev))
            flipped = x[partner]
        else:
            px, pmask = peer
            take = (torch.ones(b, dtype=torch.bool, device=dev) if pmask is None
                    else pmask[rev].bool())
            partner = torch.where(take, b + rev, torch.arange(b, device=dev))
            flipped = torch.where(take[:, None, None, None], px[rev], x)
        lam0 = d["lam0"].float()
        mixed_m = (lam0 * x.float() + (1.0 - lam0) * flipped.float()).to(x.dtype)
        # cutmix: nkbx's integer box (truncated sides, halves floored, clipped)
        cut = torch.sqrt(1.0 - lam0)
        ch, cw = (cut * h).to(torch.int32), (cut * w).to(torch.int32)
        cy, cx = d["cy"].to(torch.int32), d["cx"].to(torch.int32)
        y0, y1 = torch.clamp(cy - ch // 2, 0, h), torch.clamp(cy + ch // 2, 0, h)
        x0, x1 = torch.clamp(cx - cw // 2, 0, w), torch.clamp(cx + cw // 2, 0, w)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        box = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
        mixed_c = torch.where(box[None, :, :, None], flipped, x)
        # a divisor on the batch's device: CUDA divides by a host scalar through
        # its reciprocal, an ulp off nkbx's (and the CPU's) true division
        lam_c = 1.0 - ((y1 - y0) * (x1 - x0)).float() / torch.tensor(float(h * w), device=dev)
        mixed = torch.where(d["use_cutmix"], mixed_c, mixed_m)
        lam = torch.where(d["use_cutmix"], lam_c, lam0)
        mixed = torch.where(d["apply"], mixed, x)
        lam = torch.where(d["apply"], lam, torch.ones_like(lam))
        return mixed, lam, partner

    def __call__(self, x, mask=None, generator=None, draws=None, peer=None):
        if draws is None:
            draws = self.draw(tuple(x.shape), generator, x.device)
        return self.apply(x, mask, draws, peer)
