"""TrainState: the module (f32 master parameters), the optimizer state, the
step count and the device generator of the random device ops (counterpart
of ``nkbx/train/state.py``).

``master_dtype=torch.bfloat16`` (nkbx's ``bf16_master_weights``) casts the
module's floating parameters to bf16 in place: the optimizer moments and
the EMA shadow follow them; the BatchNorm running statistics stay f32. The
update then rounds as optax does in bf16 (:mod:`nkbx_torch.train.optim`).

PyTorch runs eagerly and updates in place, so the state is one mutable
object that the train step advances; nothing is donated or copied.

With ``ema=True`` the state also keeps the model's EMA shadow (nkbx's
``ema_params`` and ``ema_batch_stats``): a second module, a copy of the
first that starts at its weights, whose parameters and BatchNorm running
means and variances the train step moves toward the trained ones. The eval
step and the checkpoints take it as a model.

With ``fsdp=True`` over a ``mesh`` of more than one data rank (nkbx's
``state_shardings(mesh, state, fsdp=True)``) the parameters that nkbx's rule
scatters live as this rank's shards (:mod:`nkbx_torch.parallel.fsdp`): the
optimizer's tensors (``groups``), their moments and the EMA shadow's
parameters are shards, and the modules' parameters hold no storage outside
:meth:`TrainState.gathered`. Over one rank nothing scatters (nkbx's rule at
``n_data`` = 1).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from nkbx_torch.models.classifier import param_labels
from nkbx_torch.parallel.fsdp import Scattered
from nkbx_torch.parallel.mesh import FSDP_MIN_SIZE, param_shardings
from nkbx_torch.train.optim import GROUPS, GroupState, _c, init_opt_state

FSDP_NEEDS_MESH = "fsdp=True requires a mesh (e.g. mesh = {'data': 8})"


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    groups: Dict[str, list]  # {"backbone": [params], "classifier": [params]}
    opt_state: Dict[str, GroupState]
    generator: torch.Generator  # on the module's device: flips and other draws
    step: int = 0
    ema_module: Optional[nn.Module] = None  # the EMA shadow, or None
    names: Dict[str, list] = dataclasses.field(default_factory=dict)  # groups' parameter names
    scattered: tuple = ()  # fsdp: the Scattered of the module and of the EMA shadow
    _ema_pairs: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _ema_by_dtype: Optional[list] = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, model, seed: int = 0, ema: bool = False, master_dtype=None, mesh=None,
               fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE):
        """State for ``model`` (a ClassificationModel or a module): the
        parameter groups by ``param_labels``, zero moments (every optimizer
        kind keeps the same state), a generator on the parameters' device
        seeded with ``seed``, and with ``ema`` the EMA shadow at the
        module's weights. ``master_dtype`` casts the parameters first.
        ``fsdp`` scatters the state over ``mesh`` (every rank calls it with
        the same weights); without a mesh it raises nkbx's ValueError."""
        module = getattr(model, "module", model)
        if fsdp and mesh is None:
            raise ValueError(FSDP_NEEDS_MESH)
        if master_dtype is not None:
            for p in module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(master_dtype)
        shadow = make_shadow(module) if ema else None
        scattered = ()
        if fsdp and mesh.data > 1:
            specs = param_shardings(mesh, module, fsdp=True, fsdp_min_size=fsdp_min_size)
            scattered = tuple(Scattered(m, specs, mesh) for m in (module, shadow)
                              if m is not None)
        at_rest = scattered[0].tensors if scattered else dict(module.named_parameters())
        labels = param_labels(module)
        names = {g: [n for n in at_rest if labels[n] == g] for g in GROUPS}
        groups = {g: [at_rest[n] for n in ns] for g, ns in names.items()}
        device = next(module.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(module, groups, init_opt_state(groups), generator, ema_module=shadow,
                   names=names, scattered=scattered)

    def scatter_of(self, module) -> Optional[Scattered]:
        """The :class:`~nkbx_torch.parallel.fsdp.Scattered` of ``module``
        (the state's module or its EMA shadow), or None where it is whole."""
        return next((s for s in self.scattered if s.module is module), None)

    def gathered(self, module):
        """A context in which ``module``'s parameters are whole (every rank
        enters it); nothing to do for a module that is not scattered."""
        scat = self.scatter_of(module)
        return scat.gathered() if scat is not None else contextlib.nullcontext(module)

    def tensors(self) -> list:
        """The tensors the optimizer updates, every group's."""
        return [t for ts in self.groups.values() for t in ts]

    def param_shapes(self) -> dict:
        """{name: whole shape} of the module's parameters."""
        if self.scattered:
            return dict(self.scattered[0].shapes)
        return {n: tuple(p.shape) for n, p in self.module.named_parameters()}

    def local(self, owner, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full``, a whole tensor shaped like the
        parameter whose tensor at rest is ``owner``."""
        d = self.scattered[0].dim_of(owner) if self.scattered else None
        return full if d is None else self.scattered[0].local(full, d)

    def whole(self, owners: list, tensors: list) -> list:
        """``tensors`` (one per tensor at rest in ``owners``, shaped like
        it) whole: gathered where they are shards (every rank calls it)."""
        return self.scattered[0].gather_like(owners, tensors) if self.scattered else tensors

    def nbytes(self) -> int:
        """Bytes of the state on this rank at rest: the modules' parameters
        (empty where scattered) and buffers, the shards, the moments."""
        seen = {}
        for m in (self.module, self.ema_module):
            if m is None:
                continue
            for t in list(m.parameters()) + list(m.buffers()):
                seen[id(t)] = t
            scat = self.scatter_of(m)
            for t in (scat.tensors.values() if scat is not None else ()):
                seen[id(t)] = t
        for st in self.opt_state.values():
            for t in st.mu + st.nu:
                seen[id(t)] = t
        return sum(t.numel() * t.element_size() for t in seen.values())

    @torch.no_grad()
    def update_ema(self, decay: float):
        """``e <- e * decay + p * (1 - decay)`` over :meth:`ema_pairs`, two
        products and a sum as nkbx rounds them (engine.py:255-265)."""
        if self._ema_by_dtype is None:  # bf16 masters: bf16 parameters, f32 statistics
            shadow, live = self.ema_pairs()
            self._ema_by_dtype = [([e for e in shadow if e.dtype == dt],
                                   [t for t, e in zip(live, shadow) if e.dtype == dt])
                                  for dt in dict.fromkeys(e.dtype for e in shadow)]
        for s, p in self._ema_by_dtype:  # the scalars rounded to the dtype, as JAX does
            torch._foreach_mul_(s, _c(decay, s))
            torch._foreach_add_(s, torch._foreach_mul(p, _c(1.0 - decay, s)))

    def ema_pairs(self):
        """(shadow tensors, live tensors): the parameters, then the running
        means and variances, in the module's order (empty without EMA). The
        lists are made once: every update and load writes these tensors in
        place."""
        if self.ema_module is None:
            return [], []
        if self._ema_pairs is None:
            self._ema_pairs = tuple(_averaged(m, self.scatter_of(m))
                                    for m in (self.ema_module, self.module))
        return self._ema_pairs


def make_shadow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` (its weights and buffers, in eval mode, without
    gradients) to hold the EMA."""
    shadow = copy.deepcopy(module).eval()
    for p in shadow.parameters():
        p.requires_grad_(False)
        p.grad = None
    return shadow


_STATS = ("running_mean", "running_var")


def _averaged(module: nn.Module, scat: Optional[Scattered]):
    """The tensors of ``module`` that the EMA averages: every parameter (its
    shard where ``scat`` scatters it) and the BatchNorm running statistics
    (nkbx's ``params`` and ``batch_stats``), not the integer counters."""
    params = (list(scat.tensors.values()) if scat is not None
              else [p for p in module.parameters()])
    return ([p.data for p in params]
            + [b for n, b in module.named_buffers() if n.rsplit(".", 1)[-1] in _STATS])
