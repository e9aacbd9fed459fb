"""Elastic data-parallel training: resize the set of ranks between
steps (port of ``kubeshare_tpu/parallel/elastic.py``).

The reference's membership is a list of devices in one process, and a
resize re-places parameters and optimizer state on a new dp mesh. Here
a rank is a process of a ``torch.distributed`` world, and membership is
a subset of the world's ranks: ``resize(ranks)`` is called on every
rank of the world (forming a process group is collective), forms the
new group, and broadcasts the parameters and the AdamW state from a
survivor (the first member that was a member before, as TorchElastic
carries state from a surviving rank) to every member, which is what the
reference's replicated placement on the new mesh does. A rank outside
the set idles: its ``step`` does nothing and returns None. Each resize
bumps ``generation`` (TorchElastic's restart counter); ``steps`` counts
the updates, and a joining member takes the survivors' count.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from . import comm


class ElasticTrainer:
    """Data-parallel trainer whose members can change between steps.

    ``loss_fn(model, *batch) -> scalar``: the mean loss of a batch
    block. Parameters are replicated over the members, the batch split
    on its leading axis. Outside a world the one process is the only
    member."""

    def __init__(self, loss_fn: Callable, model: nn.Module,
                 learning_rate: float = 1e-3,
                 ranks: Optional[Sequence[int]] = None, steps: int = 0):
        """``ranks``: the first members (default: every rank of the
        world); ``steps`` resumes a checkpointed run's count."""
        self.loss_fn = loss_fn
        self.model = model
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)
        self._init_state()
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks: list = []
        self.group: comm.Group = None
        self.generation = -1
        self.dp = 0
        self.steps = steps
        self.resize(range(world) if ranks is None else ranks)

    def _init_state(self) -> None:
        """Create the AdamW state a first update would, so that a
        member that has not stepped yet can receive the survivor's."""
        for p in self.params:
            state = self.optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    def resize(self, ranks: Sequence[int]) -> None:
        """Re-form over ``ranks`` (the surviving and joining members).
        Every rank of the world calls it with the same ranks."""
        ranks = sorted(set(int(r) for r in ranks))
        if not ranks:
            raise ValueError("elastic resize to zero ranks")
        survivors = [r for r in ranks if r in self.ranks] or ranks
        source = survivors[0]
        world = comm.world()
        if world is None:
            group = None
        elif len(ranks) == comm.group_size(world):
            group = world
        else:
            group = dist.new_group(ranks)   # every rank of the world calls
        if self.rank in ranks and len(ranks) > 1:
            self._broadcast(ranks.index(source), group)
        self.ranks, self.group = ranks, group if len(ranks) > 1 else None
        self.dp = len(ranks)
        self.generation += 1

    def _broadcast(self, src: int, group: comm.Group) -> None:
        """Every member's parameters, AdamW state and step count made
        the survivor's, in one call."""
        tensors = []
        for p in self.params:
            state = self.optimizer.state[p]
            tensors += [p.data, state["exp_avg"], state["exp_avg_sq"]]
        device = self.params[0].device
        steps = torch.tensor([float(self.steps)] + [
            float(self.optimizer.state[p]["step"]) for p in self.params],
            device=device)
        flat = torch.cat([t.reshape(-1).float() for t in tensors] + [steps])
        comm.broadcast_(flat, src, group)
        offset = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        counts = flat[offset:].tolist()
        self.steps = int(counts[0])
        for p, count in zip(self.params, counts[1:]):
            self.optimizer.state[p]["step"].fill_(count)

    def step(self, batch) -> Optional[torch.Tensor]:
        """One optimizer step at the current membership. ``batch`` is a
        tensor or a tuple of tensors leading with the global batch axis
        (which must divide by the member count); every member passes the
        same one and gets the global mean loss. A non-member returns
        None."""
        batch = (batch,) if isinstance(batch, torch.Tensor) else tuple(batch)
        for x in batch:
            if x.shape[0] % self.dp:
                raise ValueError(f"global batch {x.shape[0]} not divisible "
                                 f"by dp={self.dp}")
        if not self.member:
            return None
        index = self.ranks.index(self.rank)
        block = tuple(x[index * (x.shape[0] // self.dp):
                        (index + 1) * (x.shape[0] // self.dp)]
                      for x in batch)
        loss = self.loss_fn(self.model, *block)
        grads = torch.autograd.grad(loss, self.params)
        flat = torch.cat([g.float().reshape(-1) for g in grads]
                         + [loss.detach().float().reshape(1)])
        if self.dp > 1:
            flat /= self.dp
        comm.all_reduce_(flat, self.group)
        offset = 0
        for p in self.params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
            offset += p.numel()
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.steps += 1
        return flat[-1]
