"""Multi-process init: gang pod env -> torch.distributed -> rank mesh
(port of ``kubeshare_tpu/parallel/multihost.py``).

``spec_from_env`` derives the (coordinator, world size, process id)
triple from what a gang-scheduled pod already has, with the reference's
env contract:

- coordinator: ``JAX_COORDINATOR_ADDRESS`` (``host:port``);
- world size: ``KUBESHARE_NUM_PROCESSES``, falling back to the gang
  headcount ``KUBESHARE_GROUP_HEADCOUNT``;
- process id: ``KUBESHARE_PROCESS_ID``, falling back to the Indexed-Job
  ``JOB_COMPLETION_INDEX``, falling back to a trailing ``-<n>`` ordinal
  in the pod hostname.

``maybe_initialize`` then joins the world with
``torch.distributed.init_process_group`` at ``tcp://<coordinator>``.
Before it does, every rank publishes its hostname and device count on
the rendezvous store, and ``choose_backend`` picks the backend from
them by one rule: NCCL when every rank on a node has a card of its own,
gloo when ranks share one (NCCL refuses two ranks on one device, and a
fractional gang packs its members on one card). A rank's device is
``cuda:(rank_on_node % device_count())``.

One process drives one device here, so a granule (the unit the dp axis
spans) is one process, as on the reference's CPU simulation:
``hybrid_mesh`` puts dp across the processes.
"""

from __future__ import annotations

import logging
import os
import re
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..constants import (
    ENV_COORDINATOR, ENV_GANG_HEADCOUNT, ENV_JOB_COMPLETION_INDEX,
    ENV_NUM_PROCESSES, ENV_PROCESS_ID,
)
from .mesh import Mesh, MeshPlan, make_mesh

log = logging.getLogger("kubeshare_tpu_torch.parallel")

_STORE_KEY = "kubeshare/node/{}"


@dataclass(frozen=True)
class DistSpec:
    coordinator: str
    num_processes: int
    process_id: int


@dataclass(frozen=True)
class Joined:
    """What joining a world chose: the backend, this rank's device, and
    its place among the ranks on its node."""
    rank: int
    world: int
    backend: str
    device: torch.device
    rank_on_node: int
    ranks_on_node: int


def _ordinal_from_hostname(hostname: str) -> Optional[int]:
    match = re.search(r"-(\d+)$", hostname)
    return int(match.group(1)) if match else None


def spec_from_env(
    environ: Optional[Mapping[str, str]] = None,
    hostname: str = "",
) -> Optional[DistSpec]:
    """Returns None when this pod is not part of a multi-process gang."""
    env = os.environ if environ is None else environ
    coordinator = env.get(ENV_COORDINATOR, "")
    if not coordinator:
        return None
    raw_n = env.get(ENV_NUM_PROCESSES) or env.get(ENV_GANG_HEADCOUNT) or ""
    try:
        num_processes = int(raw_n)
    except ValueError:
        return None
    if num_processes < 2:
        return None  # single process: nothing to initialize

    raw_id = env.get(ENV_PROCESS_ID) or env.get(ENV_JOB_COMPLETION_INDEX) or ""
    if raw_id:
        try:
            process_id = int(raw_id)
        except ValueError:
            return None
    else:
        if not hostname:
            hostname = socket.gethostname()
        ordinal = _ordinal_from_hostname(hostname)
        if ordinal is None:
            return None
        process_id = ordinal
    if not 0 <= process_id < num_processes:
        return None
    return DistSpec(coordinator, num_processes, process_id)


def choose_backend(nodes: Sequence[Tuple[str, int]],
                   device_type: str) -> Tuple[str, str]:
    """``(backend, reason)`` for a world whose rank r runs on host
    ``nodes[r][0]`` with ``nodes[r][1]`` CUDA devices: NCCL when the
    ranks run on CUDA and no node has more ranks than cards, else gloo."""
    if device_type != "cuda":
        return "gloo", f"{device_type} tensors"
    per_node = {}
    for host, cards in nodes:
        ranks, least = per_node.get(host, (0, cards))
        per_node[host] = (ranks + 1, min(least, cards))
    for host, (ranks, cards) in sorted(per_node.items()):
        if ranks > cards:
            return "gloo", (f"{ranks} ranks share {cards} card(s) on "
                            f"{host}")
    return "nccl", "a card per rank on every node"


def init_distributed(init_method: str, world: int, rank: int,
                     device_type: str = "cuda",
                     timeout_s: float = 300.0) -> Joined:
    """Join a ``world``-rank ``torch.distributed`` world at
    ``init_method`` (``tcp://host:port`` or ``file://path``) as
    ``rank``, with the backend ``choose_backend`` picks from every
    rank's hostname and device count, and make this rank's device the
    current one. The choice is logged and returned."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu'")
    timeout = timedelta(seconds=timeout_s)
    store, _, _ = next(dist.rendezvous(init_method, rank, world,
                                       timeout=timeout))
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    host = socket.gethostname()
    store.set(_STORE_KEY.format(rank), f"{cards} {host}")
    nodes: List[Tuple[str, int]] = []
    for r in range(world):
        raw_cards, raw_host = store.get(_STORE_KEY.format(r)).decode().split(
            " ", 1)
        nodes.append((raw_host, int(raw_cards)))
    backend, reason = choose_backend(nodes, device_type)
    on_node = [r for r, (h, _) in enumerate(nodes) if h == host]
    rank_on_node = on_node.index(rank)
    if device_type == "cuda":
        device = torch.device("cuda", rank_on_node % cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    log.info("rank %d/%d joined with %s (%s) on %s", rank, world, backend,
             reason, device)
    return Joined(rank, world, backend, device, rank_on_node, len(on_node))


def maybe_initialize(
    environ: Optional[Mapping[str, str]] = None,
    hostname: str = "",
    device_type: str = "cuda",
) -> Optional[Tuple[DistSpec, Joined]]:
    """Call before the first CUDA work. No-op (returns None) outside a
    gang; otherwise joins the world at ``tcp://<coordinator>`` and
    returns the spec used and what joining chose."""
    spec = spec_from_env(environ, hostname)
    if spec is None:
        return None
    joined = init_distributed(f"tcp://{spec.coordinator}",
                              spec.num_processes, spec.process_id,
                              device_type)
    return spec, joined


def granule_device_count() -> int:
    """Devices in one granule: what a per-granule ``MeshPlan``'s axes
    must multiply to. A process drives one device here, and a granule
    is a process."""
    return 1


def hybrid_mesh(plan: Optional[MeshPlan] = None) -> Mesh:
    """Mesh whose dp axis spans the processes and whose other axes stay
    within each granule. ``plan`` describes the PER-GRANULE layout
    (default ``MeshPlan()``); the world's process count multiplies into
    dp."""
    per_granule = granule_device_count()
    if plan is None:
        plan = MeshPlan()
    if plan.total != per_granule:
        raise ValueError(
            f"per-host plan {plan.shape} needs {plan.total} devices, "
            f"host has {per_granule}"
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(MeshPlan(dp=plan.dp * world, fsdp=plan.fsdp,
                              tp=plan.tp, sp=plan.sp, pp=plan.pp,
                              ep=plan.ep))
