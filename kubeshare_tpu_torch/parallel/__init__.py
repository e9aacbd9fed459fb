"""Multi-rank training (port of ``kubeshare_tpu/parallel``): the rank
mesh, gang init from the pod env, the collectives, ring and Ulysses
sequence-parallel attention, the spec trees and their placement (tensor
parallelism and fully sharded weights), the dp x fsdp x tp (x sp) train
step, the GPipe pipeline and the elastic trainer. A world of ranks is a
``torch.distributed`` world, one process a rank; ``launch.run_world``
spawns one on this host."""

from .elastic import ElasticTrainer
from .mesh import Mesh, MeshPlan, factorize_devices, make_mesh
from .multihost import (
    DistSpec, Joined, choose_backend, granule_device_count, hybrid_mesh,
    init_distributed, maybe_initialize, spec_from_env,
)
from .pipeline import pipeline_apply, shard_stacked_params, stack_stage_params
from .ring_attention import (
    make_ring_attention, ring_attention, ring_attention_with_lse,
)
from .sharding import (
    LlamaShards, batch_sharding, build_param_specs, llama_param_spec,
    shard_params, shard_tensor,
)
from .train import make_sharded_train_step
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "Mesh", "MeshPlan", "factorize_devices", "make_mesh",
    "DistSpec", "Joined", "choose_backend", "granule_device_count",
    "hybrid_mesh", "init_distributed", "maybe_initialize", "spec_from_env",
    "make_ring_attention", "ring_attention", "ring_attention_with_lse",
    "make_ulysses_attention", "ulysses_attention",
    "LlamaShards", "batch_sharding", "build_param_specs",
    "llama_param_spec", "shard_params", "shard_tensor",
    "make_sharded_train_step",
    "pipeline_apply", "shard_stacked_params", "stack_stage_params",
    "ElasticTrainer",
]
