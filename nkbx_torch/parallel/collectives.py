"""The collectives of the port's data parallelism: every collective of
``nkbx_torch`` goes through this module.

nkbx jits one step over the global batch and lets GSPMD place the
collectives (``nkbx/parallel/mesh.py``); the port runs one process a GPU,
each holding its own rows, and rebuilds the global batch's semantics with
the explicit collectives here, over ``torch.distributed``'s default group:

- :func:`all_reduce_` (sum or max, in place) and :func:`all_reduce_grads`
  (a sum over parameter gradients, flattened into f32 buckets in a fixed
  order, rounded back once);
- for scattered parameters (:mod:`nkbx_torch.parallel.fsdp`):
  :func:`reduce_scatter_grads` (the same sums, each rank keeping its block)
  and :func:`all_gather_shards` (the whole tensors from every rank's
  blocks);
- :func:`all_gather_rows` (every rank's rows, concatenated in rank order),
  :func:`all_gather_object` and :func:`broadcast_object` (Python objects,
  from rank 0), :func:`barrier`, :func:`agreed_any` (the OR of a flag),
  :func:`sum_count` (an integer's sum);
- :func:`sum_across_ranks`, a differentiable sum (its backward sums the
  gradients too), for BatchNorm's global statistics;
- :func:`defer_sum` and :func:`flush`: sums that can wait (the running
  statistics of ghost groups and chain tiles) queued and summed in one
  all-reduce after the backward, each then handed to its callback in the
  order queued.

Without a process group each of them is the identity; in a group of one
rank they run (NCCL then launches its kernels), so that a world of one
measures what the collectives cost. NCCL takes CUDA tensors; gloo takes
CPU tensors and, for every collective here, CUDA tensors too (it copies
them through host memory itself), so nothing stages around either.

:func:`data_parallel` declares the mesh a train step runs under: BatchNorm,
the device stage's draws and mixup read it through :func:`active`.
"""

from __future__ import annotations

import contextlib

import torch

_BUCKET_BYTES = 32 << 20  # f32 bytes a gradient all-reduce carries at once
_active = None  # the Mesh a train step runs under, in a process group
_pending = []  # (tensor, callback) of defer_sum, waiting for flush


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def grouped() -> bool:
    """Whether this process belongs to a process group (of any size)."""
    return _dist() is not None


def world() -> int:
    """Ranks of the default process group; 1 without one."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def backend() -> str | None:
    """``"nccl"`` or ``"gloo"``; None without a process group."""
    d = _dist()
    return str(d.get_backend()) if d is not None else None


def _comm_device():
    """Where a collective's own small tensors live: the current card under
    NCCL, the host under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def data_parallel(mesh):
    """Run the block as one rank of ``mesh``'s data axis (nothing changes
    for None, or without a process group)."""
    global _active
    prev = _active
    _active = mesh if mesh is not None and grouped() else None
    try:
        yield
    finally:
        _active = prev


def active():
    """The mesh the current train step runs under, or None."""
    return _active


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="sum"``) or maxed (``"max"``) over the ranks, in
    place; returns ``t``."""
    d = _dist()
    if d is not None:
        d.all_reduce(t, op=d.ReduceOp.SUM if op == "sum" else d.ReduceOp.MAX)
    return t


def defer_sum(t: torch.Tensor, done) -> None:
    """Queue ``t`` to be summed over the ranks at the next :func:`flush`,
    which calls ``done`` with the sum; without a process group ``done(t)``
    at once."""
    if not grouped():
        done(t)
        return
    _pending.append((t, done))


def flush() -> None:
    """Sum every queued tensor over the ranks in one f32 all-reduce, then
    hand each its sum, in the order they were queued."""
    global _pending
    if not _pending:
        return
    items, _pending = _pending, []
    flat = all_reduce_(torch.cat([t.reshape(-1).float() for t, _ in items]))
    for (t, done), part in zip(items, flat.split([t.numel() for t, _ in items])):
        done(part.view_as(t).to(t.dtype))


def all_reduce_grads(params) -> None:
    """Sum every ``p.grad`` of ``params`` over the ranks, in place: the
    gradients flattened in order into f32 buckets of up to 32 MB, one
    all-reduce a bucket, each sum rounded back to its gradient's dtype once.
    Every rank must hold a gradient for the same parameters."""
    if not grouped():
        return
    for bucket in _buckets([p.grad for p in params if p.grad is not None],
                           lambda g: g.numel() * 4):
        flat = all_reduce_(torch.cat([g.reshape(-1).float() for g in bucket]))
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def _buckets(tensors, nbytes):
    """``tensors`` in order, cut into runs of at most ``_BUCKET_BYTES`` by
    ``nbytes(t)`` (a tensor larger than that is a run of its own)."""
    out, size = [[]], 0
    for t in tensors:
        if out[-1] and size + nbytes(t) > _BUCKET_BYTES:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes(t)
    return [b for b in out if b]


def _block(t: torch.Tensor, d: int, r: int, n: int) -> torch.Tensor:
    """Block ``r`` of ``n`` of ``t`` along dimension ``d``."""
    k = t.shape[d] // n
    return t.narrow(d, r * k, k)


def reduce_scatter_grads(grads, dims) -> list:
    """The sums over the ranks of ``grads`` (whole gradients, the same
    shapes on every rank), each rank getting its block of each along its
    dimension in ``dims``: the gradients flattened in order into the f32
    buckets of :func:`all_reduce_grads` (32 MB of whole gradients), one
    reduce-scatter a bucket, each block rounded back to its gradient's dtype
    once. Returns the blocks."""
    d_, n, r = _dist(), world(), rank()
    out = []
    for bucket in _buckets(list(zip(grads, dims)), lambda gd: gd[0].numel() * 4):
        flat = torch.cat([_block(g, d, q, n).reshape(-1).float()
                          for q in range(n) for g, d in bucket])
        mine = flat.new_empty(flat.numel() // n)
        d_.reduce_scatter_tensor(mine, flat)
        sizes = [g.numel() // n for g, _ in bucket]
        for (g, d), part in zip(bucket, mine.split(sizes)):
            out.append(part.view(_block(g, d, r, n).shape).to(g.dtype))
    return out


def all_gather_shards(shards, dims) -> list:
    """The whole tensors of which each rank holds ``shards`` (blocks along
    ``dims``, in rank order), each a new tensor: the blocks flattened in
    order into buckets of one dtype and up to 32 MB of whole tensors, one
    all-gather a bucket."""
    n = world()
    out = [None] * len(shards)
    by_dtype = {}
    for i, s in enumerate(shards):
        by_dtype.setdefault(s.dtype, []).append(i)
    for idx in by_dtype.values():
        for bucket in _buckets(idx, lambda i: shards[i].numel() * shards[i].element_size() * n):
            parts = all_gather_rows(torch.cat([shards[i].reshape(-1) for i in bucket])).chunk(n)
            offset = 0
            for i in bucket:
                s, k = shards[i], shards[i].numel()
                out[i] = torch.cat([p[offset:offset + k].view(s.shape) for p in parts], dim=dims[i])
                offset += k
    return out


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim 0
    in rank order, on ``t``'s device."""
    d = _dist()
    n = world()
    if d is None:
        return t
    if t.dtype == torch.bool:  # gathered as bytes
        return all_gather_rows(t.to(torch.uint8)).bool()
    t = t.contiguous()
    if backend() == "nccl":
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        d.all_gather_into_tensor(out, t)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    d.all_gather(parts, t)
    return torch.cat(parts)


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    d = _dist()
    if d is None:
        return [obj]
    out = [None] * d.get_world_size()
    d.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    d = _dist()
    if d is None:
        return obj
    box = [obj]
    d.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    d = _dist()
    if d is not None:
        if backend() == "nccl":
            d.barrier(device_ids=[torch.cuda.current_device()])
        else:
            d.barrier()


def sum_count(n: int) -> int:
    """The sum of an integer ``n`` over the ranks."""
    if not grouped():
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64, device=_comm_device())
    return int(all_reduce_(t).item())


def agreed_any(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any rank: a MAX
    all-reduce of the 0/1 flag."""
    if not grouped():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=_comm_device())
    return bool(all_reduce_(t, op="max").item())


class _SumAcrossRanks(torch.autograd.Function):
    """y = Σ_ranks x on every rank; dx = Σ_ranks dy, since every rank's y
    reads every rank's x."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.contiguous().clone())


def sum_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: BatchNorm's global
    (Σx, Σx², count) in training."""
    if not grouped():
        return x
    return _SumAcrossRanks.apply(x)
