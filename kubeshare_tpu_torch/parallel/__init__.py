"""Multi-rank training (port of ``kubeshare_tpu/parallel``): the rank
mesh, gang init from the pod env, the collectives, ring and Ulysses
sequence-parallel attention, the spec trees and the dp x sp train step.
A world of ranks is a ``torch.distributed`` world, one process a rank;
``launch.run_world`` spawns one on this host. Fully sharded data
parallelism, tensor and pipeline parallelism, elastic resizing and MoE
are not ported yet (ROADMAP Queue 1 item 5)."""

from .mesh import Mesh, MeshPlan, factorize_devices, make_mesh
from .multihost import (
    DistSpec, Joined, choose_backend, granule_device_count, hybrid_mesh,
    init_distributed, maybe_initialize, spec_from_env,
)
from .ring_attention import (
    make_ring_attention, ring_attention, ring_attention_with_lse,
)
from .sharding import (
    batch_sharding, build_param_specs, llama_param_spec, shard_params,
)
from .train import make_sharded_train_step
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "Mesh", "MeshPlan", "factorize_devices", "make_mesh",
    "DistSpec", "Joined", "choose_backend", "granule_device_count",
    "hybrid_mesh", "init_distributed", "maybe_initialize", "spec_from_env",
    "make_ring_attention", "ring_attention", "ring_attention_with_lse",
    "make_ulysses_attention", "ulysses_attention",
    "batch_sharding", "build_param_specs", "llama_param_spec",
    "shard_params", "make_sharded_train_step",
]
