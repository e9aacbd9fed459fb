"""Sharded training step over a dp x fsdp x tp (x sp) rank mesh (port
of ``kubeshare_tpu/parallel/train.py``).

Where the reference jits one GSPMD program and lets XLA lay the
collectives onto the mesh, each rank here runs its forward and backward
on its own block of the batch (dim 0 over ``(dp, fsdp)``) with its own
block of the weights (``shard_params`` by ``param_specs``, default the
reference's ``build_param_specs``): tensor parallelism and the fsdp
gathers and reduce-scatters run inside the model's forward and backward
(``models/llama.py``, ``parallel/fsdp.py``). Then each gradient is
summed over the batch axes it is not split over, dp and fsdp, and over
sp (a gradient split over fsdp was already summed over fsdp by its
reduce-scatter; tp ranks hold the whole gradient of what they share),
scaled by 1 / (dp x fsdp), with the loss, in one flat float32 buffer per
set of axes: one SUM all-reduce over the world when those axes span it,
else one over each axis. Then an ``AdamW`` update of each rank's blocks
with optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, weight decay
1e-4 (the port's ``models/train.py`` uses Adam, optax.adam's
counterpart). AdamW is elementwise, so updating the blocks is updating
the whole.

The loss function's contract, so that the sum is right: on each rank
``loss_fn(model, *batch_block)`` returns this rank's share of its
block's mean loss, which is the whole mean when the mesh has no sp axis,
and the partial of ``models.llama.make_llama_sp_loss`` when it has one
(the sp partials sum to the block's mean); tp ranks return the same
loss. The blocks are equal, so the sum scaled by 1 / (dp x fsdp) is the
global mean.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.train import accumulated_value_and_grad, check_accum_batch
from . import comm
from .mesh import Mesh
from .sharding import (
    BatchSharding, _axes, batch_sharding, build_param_specs, shard_params,
)

# The axes over which a gradient's partial sums lie: the batch's and the
# sequence's.
_SUMMED = ("dp", "fsdp", "sp")


def make_sharded_train_step(
    loss_fn: Callable,            # (model, *batch) -> scalar loss
    model: nn.Module,
    mesh: Mesh,
    learning_rate: float = 1e-3,
    fsdp: bool = True,
    param_specs: Optional[Dict] = None,
    batch_spec: Optional[BatchSharding] = None,
    accum_steps: int = 1,
):
    """``(step, model, opt_state)``. ``step(*batch)`` takes the GLOBAL
    batch, keeps this rank's block (``batch_spec``, default
    ``batch_sharding(mesh)``: dim 0 over dp and fsdp), runs one update
    of ``model`` in place and returns the global mean loss (the same
    scalar on every rank). ``step.local(*block)`` takes the block
    already cut, as a gang member that draws only its own data does;
    ``step.value_and_grad(*batch)`` returns the global mean loss and the
    summed gradients of this rank's blocks (in ``model.parameters()``
    order) without updating. ``opt_state`` is the ``torch.optim.AdamW``.

    ``model`` is placed here (``shard_params``: rank 0's weights, then
    each rank's block by ``param_specs``, a ``{parameter name: spec}``
    dict, default ``build_param_specs(model, fsdp)``). ``accum_steps > 1``
    folds the block through that many microbatches
    (``models.train.accumulated_value_and_grad``); the block's leading
    dim must divide by it."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if param_specs is None:
        param_specs = build_param_specs(model, fsdp)
    if batch_spec is None:
        batch_spec = batch_sharding(mesh)
    shard_params(model, mesh, fsdp, specs=param_specs)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    vg = accumulated_value_and_grad(loss_fn, accum_steps)
    scale = 1.0 / (mesh.shape["dp"] * mesh.shape["fsdp"])
    summed = tuple(a for a in _SUMMED if mesh.shape[a] > 1)
    # gradient indices by the axes they are summed over; the loss goes
    # with the fullest set
    buckets: Dict[Tuple[str, ...], List[int]] = {summed: []}
    for i, (name, _) in enumerate(named):
        split = {a for e in param_specs[name] for a in _axes(e)}
        buckets.setdefault(tuple(a for a in summed if a not in split),
                           []).append(i)

    def reduce(flat: torch.Tensor, axes: Sequence[str]) -> None:
        if math.prod(mesh.shape[a] for a in axes) == mesh.size:
            comm.all_reduce_(flat, comm.world())
        else:
            for axis in axes:
                comm.all_reduce_(flat, mesh.group(axis))

    def reduced(*block: torch.Tensor):
        check_accum_batch(block, accum_steps)
        loss, grads = vg(model, block)
        out: List[Optional[torch.Tensor]] = [None] * len(params)
        for axes, idx in buckets.items():
            parts = [grads[i].float().reshape(-1) for i in idx]
            if axes == summed:
                parts.append(loss.float().reshape(1))
            flat = torch.cat(parts)
            if scale != 1.0:
                flat /= 1.0 / scale
            if axes:
                reduce(flat, axes)
            offset = 0
            for i in idx:
                n = params[i].numel()
                out[i] = flat[offset:offset + n].view_as(params[i]).to(
                    params[i].dtype)
                offset += n
            if axes == summed:
                loss = flat[-1]
        return loss, out

    def local(*block: torch.Tensor) -> torch.Tensor:
        loss, grads = reduced(*block)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:   # the gradients are not kept between steps
            p.grad = None
        return loss

    def step(*batch: torch.Tensor) -> torch.Tensor:
        return local(*batch_spec.shard_all(batch))

    step.local = local
    step.value_and_grad = lambda *batch: reduced(*batch_spec.shard_all(batch))
    return step, model, opt
