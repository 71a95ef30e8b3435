"""The rank geometry of the port's data parallelism (counterpart of
``nkbx/parallel/mesh.py``).

nkbx builds a ``('data', 'model')`` device mesh and shards the global batch
over ``data``; the port runs one process a GPU (``torchrun``), and a
:class:`Mesh` is the data axis over those ranks: ``mesh["data"]`` must equal
the world's rank count. The parameters are replicated on every rank, as
nkbx's trainer replicates them over its mesh. Sharding them (``fsdp``, a
``model`` axis larger than 1) is not ported: it raises, naming ROADMAP.md
A10b.

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

A10B = ("sharding the parameters (fsdp, a mesh 'model' axis > 1) is not ported to "
        "nkbx_torch yet (ROADMAP.md, A10b); the port replicates them on every rank")


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


def param_shardings(*args, **kwargs):
    """nkbx's per-leaf parameter shardings: the port replicates every
    parameter, and sharding them raises (A10b)."""
    raise NotImplementedError(A10B)


def state_shardings(*args, **kwargs):
    """nkbx's FSDP shardings of a train state: raises (A10b)."""
    raise NotImplementedError(A10B)
