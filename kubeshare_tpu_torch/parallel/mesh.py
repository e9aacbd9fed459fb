"""The rank mesh over dp / pp / fsdp / sp / tp / ep axes (port of
``kubeshare_tpu/parallel/mesh.py``).

``MeshPlan`` and ``factorize_devices`` are the reference's arithmetic,
unchanged: the same six axes in the same order, the bandwidth-hungriest
innermost. Where the reference lays devices of one process out on a
``jax.sharding.Mesh``, the port lays the ranks of a
``torch.distributed`` world out on a grid of that shape, one rank a
device: rank r sits at the grid position whose row-major index is r,
as device r does in the reference's mesh.

``make_mesh`` builds one process group per slice of each axis of size
above 1 (the ranks that differ only in that axis' coordinate), and uses
the world's own group where one slice spans the world. It does not use
``torch.distributed.device_mesh.DeviceMesh``: that builds a group for
every axis, size 1 included, and binds one device type, while a mesh
whose ranks share one card runs on gloo with CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist


@dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1    # pipeline stages (neighbor ppermute; DCN-tolerant -> outer)
    ep: int = 1    # expert parallel (all-to-all heavy -> inner, near tp)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.sp, self.tp, self.ep)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "pp", "fsdp", "sp", "tp", "ep")

    @property
    def total(self) -> int:
        total = 1
        for d in self.shape:
            total *= d
        return total


def factorize_devices(n: int, tp_max: int = 8, fsdp_max: int = 8) -> MeshPlan:
    """Reasonable default split of n devices: tp up to tp_max (innermost,
    bandwidth-hungry), then fsdp up to fsdp_max, remainder dp."""
    tp = 1
    for candidate in (8, 4, 2, 1):
        if candidate <= tp_max and n % candidate == 0:
            tp = candidate
            break
    rest = n // tp
    fsdp = 1
    for candidate in (8, 4, 2, 1):
        if candidate <= min(fsdp_max, rest) and rest % candidate == 0:
            fsdp = candidate
            break
    dp = rest // fsdp
    return MeshPlan(dp=dp, fsdp=fsdp, tp=tp, sp=1)


class Mesh:
    """This rank's view of the world laid out on ``plan``: the grid of
    ranks, this rank's coordinate on each axis, and the process group of
    its slice along each axis (None for an axis of size 1, where every
    collective is the identity)."""

    def __init__(self, plan: MeshPlan, rank: int,
                 groups: Dict[str, Optional[dist.ProcessGroup]]):
        self.plan = plan
        self.rank = rank
        self.axis_names = plan.axis_names
        self.ranks = np.arange(plan.total).reshape(plan.shape)
        coords = np.argwhere(self.ranks == rank)[0]
        self.coords = dict(zip(plan.axis_names, (int(c) for c in coords)))
        self._groups = groups

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.plan.shape))

    @property
    def size(self) -> int:
        return self.plan.total

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(plan: Optional[MeshPlan] = None) -> Mesh:
    """The mesh of the initialised world on ``plan`` (default
    ``factorize_devices(world size)``). Every rank must call it, with
    the same plan: creating a process group is collective. Without an
    initialised world the world is this one process."""
    initialised = dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if plan is None:
        plan = factorize_devices(world)
    if plan.total != world:
        raise ValueError(
            f"mesh plan {plan.shape} needs {plan.total} devices, "
            f"have {world}"
        )
    rank = dist.get_rank() if initialised else 0
    ranks = np.arange(plan.total).reshape(plan.shape)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for i, axis in enumerate(plan.axis_names):
        size = plan.shape[i]
        groups[axis] = None
        if size == 1:
            continue
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        # every slice along this axis, in one order on every rank
        slices = np.moveaxis(ranks, i, -1).reshape(-1, size)
        for members in slices:
            group = dist.new_group([int(r) for r in members])
            if rank in members:
                groups[axis] = group
    return Mesh(plan, rank, groups)
