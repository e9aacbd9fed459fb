"""Sharded training step over a dp x sp rank mesh (port of
``kubeshare_tpu/parallel/train.py``).

Where the reference jits one GSPMD program and lets XLA lay the
gradients' all-reduce onto the mesh, each rank here runs its forward
and backward on its own block of the batch, then one SUM all-reduce of
every gradient (and the loss) in one flat float32 buffer over the whole
world, scaled by 1 / dp, and an ``AdamW`` update with optax.adamw's
defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 (the port's
``models/train.py`` uses Adam, optax.adam's counterpart).

The loss function's contract, so that the sum is right: on each rank
``loss_fn(model, *batch_block)`` returns this rank's share of its dp
block's mean loss, which is the whole mean when the mesh has no sp
axis, and the partial of ``models.llama.make_llama_sp_loss`` when it
has one (the sp partials sum to the block's mean). The dp blocks are
equal, so the sum over the world scaled by 1 / dp is the global mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.train import accumulated_value_and_grad, check_accum_batch
from . import comm
from .mesh import Mesh
from .sharding import BatchSharding, batch_sharding, check_mesh, shard_params


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
    ``batch_sharding(mesh)``: dim 0 over dp), runs one update of
    ``model`` in place and returns the global mean loss (the same
    scalar on every rank). ``step.local(*block)`` takes the block
    already cut, as a gang member that draws only its own data does.
    ``opt_state`` is the ``torch.optim.AdamW``.

    Every rank's weights are made rank 0's here (``shard_params``).
    ``accum_steps > 1`` folds the block through that many microbatches
    (``models.train.accumulated_value_and_grad``); the block's leading
    dim must divide by it. ``param_specs`` (a layout of the weights)
    raises ``NotImplementedError``: every layout but replication needs
    fsdp or tp."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if param_specs is not None:
        raise NotImplementedError(
            "param_specs lays weights over fsdp or tp, which are not "
            "ported yet (ROADMAP Queue 1 item 5)")
    check_mesh(mesh)
    if batch_spec is None:
        batch_spec = batch_sharding(mesh)
    shard_params(model, mesh, fsdp)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    vg = accumulated_value_and_grad(loss_fn, accum_steps)
    dp = mesh.shape["dp"]
    world = comm.world()

    def local(*block: torch.Tensor) -> torch.Tensor:
        check_accum_batch(block, accum_steps)
        loss, grads = vg(model, block)
        flat = torch.cat([g.float().reshape(-1) for g in grads]
                         + [loss.float().reshape(1)])
        if dp > 1:
            flat /= dp
        comm.all_reduce_(flat, world)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
            offset += n
        opt.step()
        for p in params:   # the gradients are not kept between steps
            p.grad = None
        return flat[-1]

    def step(*batch: torch.Tensor) -> torch.Tensor:
        return local(*batch_spec.shard_all(batch))

    step.local = local
    return step, model, opt
