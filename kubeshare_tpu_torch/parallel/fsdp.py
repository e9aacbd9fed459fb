"""Fully sharded weights (ZeRO-3) on the rank mesh: the gather before
use and the reduce-scatter of the gradient (port-only: the reference
writes ``P("fsdp", ...)`` specs in ``kubeshare_tpu/parallel/sharding.py``
and XLA inserts the same collectives).

Each rank holds one slice of a weight along its fsdp dim (the spec's
``"fsdp"`` entry). ``fsdp_linear`` gathers the slices in the product's
dtype just before its product, keeps only the slice and the input for
the backward, gathers again there, and returns the slice's gradient as
the sum over the group of every rank's gradient for it: one
reduce-scatter in float32. So a layer's whole weights live only while
its product runs, forward and backward. ``gather_weight`` is the same
gather for a weight that is used outside a product (the lm head under
the vocab-chunked loss): it stays gathered until its backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import comm


def _gather(shard: torch.Tensor, group: comm.Group, dim: int,
            dtype: torch.dtype) -> torch.Tensor:
    parts = comm._all_gather(shard.detach().to(dtype), group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


class _FsdpLinear(torch.autograd.Function):
    """``x @ gather(shard).T`` for a [out, in] weight sharded over
    ``group`` along ``dim``: operands in ``dtype``, float32
    accumulation, output in ``dtype`` (``models.llama._matmul``)."""

    @staticmethod
    def forward(ctx, x, shard, group, dim, dtype):
        w = _gather(shard, group, dim, dtype)
        ctx.save_for_backward(x, shard)
        ctx.args = (group, dim, dtype)
        return F.linear(x.to(dtype), w)

    @staticmethod
    def backward(ctx, g):
        x, shard = ctx.saved_tensors
        group, dim, dtype = ctx.args
        w = _gather(shard, group, dim, dtype)
        g = g.to(dtype)
        dx = (g @ w).to(x.dtype)
        dw = g.reshape(-1, g.shape[-1]).t() @ x.to(dtype).reshape(
            -1, x.shape[-1])
        del w
        dshard = comm._reduce_scatter(dw.float(), group, dim)
        return dx, dshard.to(shard.dtype), None, None, None


def fsdp_linear(x: torch.Tensor, shard: torch.Tensor, group: comm.Group,
                dim: int, dtype: torch.dtype) -> torch.Tensor:
    return _FsdpLinear.apply(x, shard, group, dim, dtype)


def gather_weight(shard: torch.Tensor, group: comm.Group,
                  dim: int) -> torch.Tensor:
    """The whole weight, differentiable: its backward reduce-scatters
    the gradient back to the slices."""
    return comm.all_gather_cat(shard, group, dim)
