"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp``
ranks (port of ``kubeshare_tpu/parallel/pipeline.py``).

The reference runs the whole schedule as one ``lax.scan`` inside
``shard_map``; here each pp rank is a process that runs the same
schedule on its own stages, and activations hop rank to rank with the
differentiable ``comm.ppermute`` (its backward is the reverse hop). The
schedule is the reference's, step for step: M + P - 1 steps; position 0
feeds microbatch t (clamped past the end), every position applies its
contiguous chain of v = S / P stages to what it holds, the last position
keeps microbatch t - (P - 1)'s result, and every activation hops one
position forward (the wrap link's garbage is overwritten by position
0's feed). At the end the outputs are shared from the last position.

Stage parameters are flat dicts of tensors. ``stack_stage_params``
stacks S of them into leaves [S, ...]; ``shard_stacked_params`` keeps
this rank's contiguous block of S / P stages (a ``StageBlock``), the
layout ``pipeline_apply`` consumes. ``pipeline_apply`` also takes the
whole stack and cuts the block itself.

Every rank keeps the reference's selects (position 0 chooses between
its feed and the hop it received, the last position between a result
and the output it holds) as ``torch.where`` on every rank: each rank's
autograd graph is then the same, so every hop's backward runs on every
rank or on none, and no rank waits in a collective its peer skips. The
input is replicated over the pp ranks and only position 0 reads it, so
its gradient is summed over them (``comm.copy_to``); the outputs are
summed forward from the last position and every rank computes the same
objective from them, so their backward is the identity
(``comm.reduce_from``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from . import comm
from .mesh import Mesh

Stages = Mapping[str, torch.Tensor]


class StageBlock(dict):
    """This pp rank's contiguous block of a stacked tree: leaves
    [S / P, ...] of stages ``first .. first + S / P - 1`` of
    ``num_stages``."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], num_stages: int,
                 first: int):
        super().__init__(leaves)
        self.num_stages = num_stages
        self.first = first


def stack_stage_params(per_stage: Sequence[Stages]) -> Dict[str, torch.Tensor]:
    """S per-stage dicts of leaves [...] -> one dict of leaves [S, ...]
    (differentiable: the stack's gradient flows to each stage)."""
    names = list(per_stage[0])
    for stage in per_stage:
        if list(stage) != names:
            raise ValueError(f"stage leaves {list(stage)} differ from "
                             f"{names}")
    return {k: torch.stack([stage[k] for stage in per_stage])
            for k in names}


def _num_stages(stacked: Stages) -> int:
    leading = {leaf.shape[0] for leaf in stacked.values()}
    if len(leading) != 1:
        raise ValueError(
            f"stacked params have mixed leading dims {sorted(leading)}")
    return leading.pop()


def _block_of(stacked: Stages, mesh: Mesh) -> StageBlock:
    if isinstance(stacked, StageBlock):
        _num_stages(stacked)
        return stacked
    num_stages = _num_stages(stacked)
    devices = mesh.shape["pp"]
    if num_stages % devices:
        raise ValueError(
            f"{num_stages} stages not divisible over the mesh's "
            f"pp={devices} devices")
    v = num_stages // devices
    first = mesh.coords["pp"] * v
    return StageBlock({k: leaf[first:first + v]
                       for k, leaf in stacked.items()}, num_stages, first)


def shard_stacked_params(stacked: Stages, mesh: Mesh) -> StageBlock:
    """Place stacked stage params on the pp axis: this rank keeps the
    contiguous block of S / P consecutive stages, as new leaf tensors
    (with gradients where the stack had them), the block
    ``pipeline_apply`` runs."""
    block = _block_of(stacked, mesh)
    return StageBlock({k: leaf.detach().clone().requires_grad_(
                          leaf.requires_grad) for k, leaf in block.items()},
                      block.num_stages, block.first)


def pipeline_apply(stage_fn: Callable, stacked_params: Stages,
                   x: torch.Tensor, num_microbatches: int, mesh: Mesh,
                   remat: bool = True) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x_mb) -> y_mb`` as an S-stage
    pipeline over the mesh's ``pp`` ranks. Every pp rank calls it with
    the same x [B, ...] (B divisible by ``num_microbatches``) and either
    the whole stack (leaves [S, ...], S a multiple of the pp size) or
    its ``shard_stacked_params`` block; every rank gets the outputs
    [B, ...]. ``remat`` (default on) recomputes each chain application
    in the backward (``torch.utils.checkpoint``) instead of keeping its
    internals for every microbatch."""
    block = _block_of(stacked_params, mesh)
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{num_microbatches} microbatches")
    group = mesh.group("pp")
    positions = mesh.shape["pp"]
    here = mesh.coords["pp"]
    v = block.num_stages // positions

    def chain(h: torch.Tensor) -> torch.Tensor:
        for r in range(v):
            h = stage_fn({k: leaf[r] for k, leaf in block.items()}, h)
        return h

    run = ((lambda h: checkpoint(chain, h, use_reentrant=False))
           if remat else chain)
    x_mb = comm.copy_to(x, group).reshape(
        num_microbatches, batch // num_microbatches, *x.shape[1:])
    is_first = torch.tensor(here == 0, device=x.device)
    is_last = torch.tensor(here == positions - 1, device=x.device)
    incoming = torch.zeros_like(x_mb[0])
    outputs = [torch.zeros_like(x_mb[0]) for _ in range(num_microbatches)]
    steps = num_microbatches + positions - 1
    for t in range(steps):
        feed = x_mb[min(t, num_microbatches - 1)]
        y = run(torch.where(is_first, feed, incoming))
        out = t - (positions - 1)
        j = min(max(out, 0), num_microbatches - 1)
        write = torch.logical_and(is_last, torch.tensor(out >= 0,
                                                        device=x.device))
        outputs[j] = torch.where(write, y, outputs[j])
        if t < steps - 1:   # the last step's hop would reach no step
            incoming = comm.ppermute(y, group, 1)
    y_mb = torch.where(is_last, torch.stack(outputs), 0.0)
    y_mb = comm.reduce_from(y_mb, group)
    return y_mb.reshape(batch, *y_mb.shape[2:])
