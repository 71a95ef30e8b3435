"""Scattered parameters: nkbx's ``fsdp`` over the port's data ranks (ZeRO-3,
gathered once a step).

nkbx puts a train state on :func:`~nkbx_torch.parallel.mesh.state_shardings`
and lets XLA insert the all-gathers and the gradients' reduce-scatter. The
port does it by hand, a step at a time. Each parameter that nkbx's rule
scatters lives on a rank as its shard: the contiguous block
``[r·k, (r+1)·k)`` of the chosen dimension (k = its size over the ranks; the
rule takes only dimensions that divide, so nothing is padded). At rest the
module's parameter holds no storage (an empty tensor); the shard is what the
optimizer updates, beside its moments and the EMA shadow's shard. A step:

- :meth:`Scattered.gather`: the full parameters, one bucketed all-gather,
  serving every microbatch of the step and remat's replay;
- the forward and backward leave full gradients in ``.grad``;
- :meth:`Scattered.scatter_grads`: their sums over the ranks, reduce-scattered
  into each shard's ``.grad`` (and the replicated parameters' all-reduced);
- the update and the EMA on the shards;
- :meth:`Scattered.release`: the full parameters and every gradient of a
  scattered parameter freed.

Gathers nest (:meth:`Scattered.gathered`): an eval epoch gathers once around
its steps. The BatchNorm running statistics stay replicated (ROADMAP.md §C).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from nkbx_torch.parallel import collectives


def _empty(t: torch.Tensor) -> torch.Tensor:
    return t.new_empty(0)


class Scattered:
    """``module``'s parameters scattered over ``mesh``'s data ranks by
    ``specs`` ({name: spec}, :func:`~nkbx_torch.parallel.mesh.param_shardings`);
    every rank makes one from the same full weights."""

    def __init__(self, module: nn.Module, specs: dict, mesh):
        self.module = module
        self.rank, self.ranks = mesh.rank, mesh.data
        self.tensors = {}  # name -> the tensor at rest: its shard, or the parameter
        self.shapes = {}  # name -> the parameter's full shape
        self.params = []  # (parameter, dim, shard) of the scattered parameters
        self.replicated = []  # the parameters kept whole
        self._dims = {}  # shard -> its dimension
        self._depth = 0
        with torch.no_grad():
            for name, p in module.named_parameters():
                self.shapes[name] = tuple(p.shape)
                spec = specs.get(name, ())
                if "data" not in spec:
                    self.tensors[name] = p
                    self.replicated.append(p)
                    continue
                d = spec.index("data")
                shard = self.local(p.detach(), d).clone()
                self.params.append((p, d, shard))
                self.tensors[name] = shard
                self._dims[shard] = d
                p.data = _empty(p)

    def local(self, full: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's block of ``full`` along dimension ``d`` (a view)."""
        k = full.shape[d] // self.ranks
        return full.narrow(d, self.rank * k, k)

    def dim_of(self, t: torch.Tensor):
        """The dimension along which ``t`` is a shard; None for a whole
        parameter."""
        return self._dims.get(t)

    def gather(self) -> None:
        """The full parameters into the module (every rank calls it); a
        nested call only counts."""
        if self._depth == 0:
            fulls = collectives.all_gather_shards([s for _, _, s in self.params],
                                                  [d for _, d, _ in self.params])
            for (p, _, _), full in zip(self.params, fulls):
                p.data = full
        self._depth += 1

    def release(self) -> None:
        """Free the full parameters and the gradients, whole and scattered,
        when the outermost gather ends (at rest a rank holds no gradient of
        a scattered parameter)."""
        self._depth -= 1
        if self._depth == 0:
            for p, _, shard in self.params:
                p.data = _empty(p)
                p.grad = shard.grad = None

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield self.module
        finally:
            self.release()

    def scatter_grads(self) -> None:
        """The full gradients summed over the ranks: each shard's ``.grad``
        its block of the sum (a reduce-scatter), each replicated parameter's
        ``.grad`` the whole sum (an all-reduce)."""
        live = [(p, d, s) for p, d, s in self.params if p.grad is not None]
        sums = collectives.reduce_scatter_grads([p.grad for p, _, _ in live],
                                                [d for _, d, _ in live])
        for (_, _, shard), g in zip(live, sums):
            shard.grad = g
        collectives.all_reduce_grads(self.replicated)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Load a whole module's state dict (a checkpoint of either layout):
        each shard takes this rank's block of its parameter."""
        for p, d, shard in self.params:
            shape = list(shard.shape)
            shape[d] *= self.ranks
            p.data = shard.new_empty(shape)
        try:
            self.module.load_state_dict(state_dict)
            for p, d, shard in self.params:
                shard.copy_(self.local(p.data, d))
        finally:
            for p, _, _ in self.params:
                p.data = _empty(p)

    def gather_like(self, owners: list, tensors: list) -> list:
        """``tensors`` whole (the moments of ``owners``, the tensors at rest
        they belong to, one each): every rank calls it."""
        idx = [i for i, o in enumerate(owners) if self.dim_of(o) is not None]
        fulls = collectives.all_gather_shards([tensors[i] for i in idx],
                                              [self.dim_of(owners[i]) for i in idx])
        out = list(tensors)
        for i, full in zip(idx, fulls):
            out[i] = full
        return out
