"""The rank geometry of the port's data parallelism (counterpart of
``nkbx/parallel/mesh.py``).

nkbx builds a ``('data', 'model')`` device mesh and shards the global batch
over ``data``; the port runs one process a GPU (``torchrun``), and a
:class:`Mesh` is the data axis over those ranks: ``mesh["data"]`` must equal
the world's rank count. The parameters are replicated on every rank, as
nkbx's trainer replicates them over its mesh, unless ``fsdp`` scatters them
over the data axis (:func:`param_shardings`, :func:`state_shardings`: nkbx's
rule, applied to the port's tensors; :mod:`nkbx_torch.parallel.fsdp` holds
the shards). A ``model`` axis larger than 1 and ``tensor_parallel=True``
raise by design (:data:`A10B`).

Batch geometry keeps nkbx's meaning of ``batch_size``: one process's (one
host's) batch. torchrun's node plays nkbx's process: the loader reads the
node's slice of each epoch's permutation (node rank and count), and each of
the node's ``local_world`` ranks keeps rows ``[l·b, (l+1)·b)`` of the node's
batch, b = ``batch_size / local_world``. The global batch is then the
ranks' rows in rank order, which is nkbx's global array on the same data.
"""

from __future__ import annotations

import dataclasses
import os

from nkbx_torch.parallel import collectives

A10B = ("a mesh 'model' axis > 1 (or tensor_parallel=True) is refused by design (ROADMAP.md, "
        "A10b): nkbx's trainer only replicates the state over 'model', so a mesh "
        "{'data': D, 'model': M} computes what {'data': D} computes; use {'data': D}")
FSDP_MIN_SIZE = 2 ** 14  # nkbx's fsdp_min_size: smaller leaves stay replicated


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis over ``data`` ranks; this process is ``rank``, the
    ``local_rank``-th of its node's ``local_world``."""

    data: int
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1

    @property
    def node_count(self) -> int:
        return self.data // self.local_world

    @property
    def node_rank(self) -> int:
        return self.rank // self.local_world

    def rows(self, b_local: int) -> slice:
        """This rank's rows of the global batch of ``data`` local batches of
        ``b_local`` rows."""
        return slice(self.rank * b_local, (self.rank + 1) * b_local)


def local_geometry() -> tuple[int, int]:
    """(local rank, local world) of this process: torchrun's
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, else every rank on one node."""
    n, r = collectives.world(), collectives.rank()
    if n > 1 and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    return r, n


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The data axis over every rank of the process group (one rank without
    one). ``n_data`` defaults to the rank count and must equal it;
    ``n_model`` > 1 raises (A10b)."""
    if int(n_model or 1) != 1:
        raise NotImplementedError(f"mesh model={n_model}: {A10B}")
    world = collectives.world()
    n_data = world if n_data is None else int(n_data)
    if n_data != world:
        raise ValueError(f"mesh data={n_data} must equal the number of ranks ({world}): the "
                         "port runs one rank a device (launch with torchrun "
                         f"--nproc_per_node={n_data}, and distributed = True in the config)")
    local_rank, local_world = local_geometry()
    if world % local_world:
        raise ValueError(f"{world} ranks do not split into nodes of {local_world}")
    return Mesh(data=world, rank=collectives.rank(), local_rank=local_rank,
                local_world=local_world)


def mesh_from_cfg(cfg, default_all_devices: bool = False) -> Mesh | None:
    """The mesh of a config's ``mesh`` key (``{"data": N, "model": 1}``).
    Without the key: the trainer spans every rank
    (``default_all_devices=True``), eval and inference return None (they
    spread over ranks only when asked)."""
    mesh_cfg = cfg.get("mesh", None)
    if not mesh_cfg:
        return make_mesh() if default_all_devices else None
    return make_mesh(n_data=mesh_cfg.get("data"), n_model=mesh_cfg.get("model", 1))


def fsdp_dim(shape, n_data: int):
    """nkbx's ``_fsdp_dim``: the largest dimension of ``shape`` that
    ``n_data`` divides, the first on ties; None where none divides."""
    best = None
    for i, d in enumerate(shape):
        if d % n_data:
            continue
        if best is None or d > shape[best]:
            best = i
    return best


def leaf_spec(shape, n_data: int, fsdp: bool, fsdp_min_size: int):
    """nkbx's spec of one leaf (``PartitionSpec`` as a tuple): ``()``
    replicated, else ``None`` on every dimension but the scattered one,
    which says ``"data"``. A leaf scatters when ``fsdp``, more than one data
    rank, at least ``fsdp_min_size`` elements and a dimension that divides."""
    size = 1
    for d in shape:
        size *= int(d)
    if not fsdp or n_data <= 1 or size < fsdp_min_size:
        return ()
    i = fsdp_dim(shape, n_data)
    if i is None:
        return ()
    return tuple("data" if j == i else None for j in range(len(shape)))


def param_shardings(mesh: Mesh, module, tensor_parallel: bool = False, fsdp: bool = False,
                    fsdp_min_size: int = FSDP_MIN_SIZE) -> dict:
    """nkbx's ``param_shardings`` over a module's parameters: {name: spec},
    a spec as :func:`leaf_spec` makes it. Without ``fsdp`` every parameter
    is replicated. ``tensor_parallel=True`` raises (:data:`A10B`)."""
    if tensor_parallel:
        raise NotImplementedError(f"tensor_parallel=True: {A10B}")
    return {name: leaf_spec(tuple(p.shape), mesh.data, fsdp, fsdp_min_size)
            for name, p in module.named_parameters()}


def state_shardings(mesh: Mesh, state, fsdp: bool = True,
                    fsdp_min_size: int = FSDP_MIN_SIZE) -> dict:
    """nkbx's ``state_shardings`` over a port :class:`TrainState`, as a tree
    of its checkpoint's parts (:mod:`nkbx_torch.train.checkpoint`):
    ``module`` and ``ema`` (the EMA shadow, where kept) {state-dict key:
    spec}, ``opt_state`` {group: {"mu": [spec], "nu": [spec]}}. The moments
    and the EMA shadow's parameters scatter as their parameters do; the
    BatchNorm running statistics and counters stay replicated (ROADMAP.md
    §C: nkbx's rule leaves every zoo BatchNorm vector replicated at its
    default ``fsdp_min_size``)."""
    shapes = state.param_shapes()
    specs = {n: leaf_spec(s, mesh.data, fsdp, fsdp_min_size) for n, s in shapes.items()}

    def module_specs(module):
        return {k: specs.get(k, ()) for k in module.state_dict()}

    out = {"module": module_specs(state.module),
           "opt_state": {label: {m: [specs[n] for n in state.names[label]]
                                 for m in ("mu", "nu")}
                         for label in state.opt_state}}
    if state.ema_module is not None:
        out["ema"] = module_specs(state.ema_module)
    return out
