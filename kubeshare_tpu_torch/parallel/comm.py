"""The collectives of the parallel paths, and the one place that decides
how their bytes move (port-only: the reference gets them from
``shard_map``'s ``ppermute``, ``all_to_all`` and ``psum``, which XLA
lays on the interconnect).

Differentiable, each a ``torch.autograd.Function``:

- ``ppermute(x, group, shift)``: rank i of ``group`` sends x to rank
  ``i + shift`` (mod n) and returns what rank ``i - shift`` sent. Its
  backward is the inverse permute.
- ``all_gather(x, group)``: every rank's x stacked in rank order
  ([n, *x.shape]; slice j is rank j's x), in one call. Its backward is
  the reduce-scatter: slice j's gradient goes to rank j (one
  all-to-all), which sums what it gets. One autograd node, so the
  backward of a rank that used only some slices (a causal ring's early
  ranks) still takes part.
- ``all_to_all(x, group, split_dim, concat_dim)``: the reference's
  ``all_to_all(..., tiled=True)``: x splits into n chunks along
  ``split_dim``, chunk j goes to rank j, and the chunks received are
  concatenated along ``concat_dim`` in rank order. Its backward is the
  reverse all-to-all.
- ``all_reduce(x, group)``: the sum over the group; its backward sums
  the gradients (every rank's output feeds the objective: sequence
  parallelism's partial losses).
- ``copy_to(x, group)`` and ``reduce_from(x, group)``: Megatron's pair
  for a region whose ranks each hold a part of one sum. ``copy_to`` is
  the identity forward and sums the gradients backward (x replicated
  into the region, each rank's use a part of x's gradient);
  ``reduce_from`` sums forward and is the identity backward (a
  row-parallel product's partial outputs, after which every rank
  computes the SAME objective, so each part's gradient is that
  objective's gradient, once; ``all_reduce`` would give it n times).
- ``reduce_scatter(x, group, dim)``: the sum over the group, of which
  this rank keeps slice ``rank`` of n along ``dim``, in one all-to-all;
  its backward is the all-gather of the slices.

In place, not differentiable: ``all_reduce_`` (sum or max) and
``broadcast_``; and ``barrier`` and ``destroy``.

``group=None`` is a group of one rank, where each is the identity. On
NCCL the tensors go as they are. On gloo a CUDA tensor is staged: the
calling stream is drained, the tensor copied to a pinned host buffer,
the collective run on the host copy, and the result copied back
asynchronously on the calling stream. ``STATS`` counts the calls, the
bytes of each call's input on this rank, the bytes it staged (both directions), the host
seconds inside the collectives and the seconds spent draining the
stream first; ``reset_stats`` zeroes them, ``stats`` copies them.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "staged_bytes": 0,
                           "seconds": 0.0, "drain_seconds": 0.0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def stats() -> Dict[str, float]:
    return dict(STATS)


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _global_rank(group: Group, rank: int) -> int:
    return dist.get_process_group_ranks(group)[rank]


def _staged(x: torch.Tensor, group: Group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@contextmanager
def _counted(sent: int):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STATS["calls"] += 1
        STATS["bytes"] += sent
        STATS["seconds"] += time.perf_counter() - t0


class _Staging:
    """Host copies of the inputs of one collective on gloo, and the way
    back to the device. For a tensor that need not be staged, both
    directions are the identity."""

    def __init__(self, like: torch.Tensor, group: Group):
        self.device = like.device
        self.on = _staged(like, group)
        if self.on:
            t0 = time.perf_counter()
            torch.cuda.current_stream(self.device).synchronize()
            STATS["drain_seconds"] += time.perf_counter() - t0

    def host(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if not self.on:
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x)
        STATS["staged_bytes"] += _nbytes(x)
        return out

    def empty(self, shape, dtype) -> torch.Tensor:
        if self.on:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def back(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x
        STATS["staged_bytes"] += _nbytes(x)
        return x.to(self.device, non_blocking=True)


# ---- the raw collectives -------------------------------------------


def _ppermute(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return x
    me = group_rank(group)
    dst = _global_rank(group, (me + shift) % n)
    src = _global_rank(group, (me - shift) % n)
    stage = _Staging(x, group)
    with _counted(_nbytes(x)):
        send = stage.host(x)
        recv = stage.empty(send.shape, send.dtype)
        reqs = [dist.isend(send, dst, group=group),
                dist.irecv(recv, src, group=group)]
        for req in reqs:
            req.wait()
        return stage.back(recv)


def _all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x[None]
    stage = _Staging(x, group)
    with _counted(_nbytes(x)):
        send = stage.host(x)
        recv = stage.empty((n, *send.shape), send.dtype)
        dist.all_gather(list(recv.unbind(0)), send, group=group)
        return stage.back(recv)


def _all_to_all(x: torch.Tensor, group: Group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    stage = _Staging(x, group)
    with _counted(_nbytes(x)):
        # [n, *chunk]: row j goes to rank j, row i comes from rank i
        chunks = torch.stack(torch.chunk(x, n, dim=split_dim))
        send = stage.host(chunks)
        recv = stage.empty(send.shape, send.dtype)
        dist.all_to_all_single(recv, send, group=group)
        recv = stage.back(recv)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(x: torch.Tensor, group: Group = None,
                op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``group`` in place (``op`` "sum" or "max");
    returns x."""
    if group_size(group) == 1:
        return x
    stage = _Staging(x, group)
    with _counted(_nbytes(x)):
        buf = stage.host(x)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        if stage.on:
            x.copy_(stage.back(buf))
        elif buf.data_ptr() != x.data_ptr():
            x.copy_(buf)
    return x


def broadcast_(x: torch.Tensor, src: int = 0,
               group: Group = None) -> torch.Tensor:
    """Overwrite ``x`` on every rank of ``group`` with rank ``src``'s
    (a rank of the group); returns x."""
    if group_size(group) == 1:
        return x
    stage = _Staging(x, group)
    with _counted(_nbytes(x) if group_rank(group) == src else 0):
        buf = stage.host(x)
        dist.broadcast(buf, _global_rank(group, src), group=group)
        if stage.on:
            x.copy_(stage.back(buf))
        elif buf.data_ptr() != x.data_ptr():
            x.copy_(buf)
    return x


def world() -> Group:
    """The group of every rank of the world joined (None for one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def barrier(group: Group = None) -> None:
    """Wait until every rank of ``group`` has come here."""
    if group_size(group) > 1:
        dist.barrier(group=group)


def destroy() -> None:
    """Leave the world this process joined."""
    dist.destroy_process_group()


# ---- differentiable -------------------------------------------------


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # row i of the result: rank i's gradient for this rank's x
        return _all_to_all(g, ctx.group, 0, 0).sum(0), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    # row j of [n, *slice] goes to rank j; row i comes from rank i
    chunks = torch.stack(torch.chunk(x, n, dim=dim))
    return _all_to_all(chunks, group, 0, 0).sum(0)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        gathered = _all_gather(g.contiguous(), ctx.group)
        return torch.cat(list(gathered.unbind(0)), dim=ctx.dim), None, None


def ppermute(x: torch.Tensor, group: Group, shift: int = 1) -> torch.Tensor:
    return _PPermute.apply(x, group, shift)


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def all_reduce(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    return _ReduceScatter.apply(x, group, dim)


def all_gather_cat(x: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order (the
    inverse of keeping slice ``rank``); its backward keeps this rank's
    slice of the gradient's sum over the group (``reduce_scatter``)."""
    if group_size(group) == 1:
        return x
    return torch.cat(list(all_gather(x, group).unbind(0)), dim=dim)
