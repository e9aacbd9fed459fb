"""Partition specs of the model families, and what this port applies of
them (port of ``kubeshare_tpu/parallel/sharding.py``).

The spec trees are the reference's, kept as data: weights
tensor-parallel over ``tp`` (column-parallel up-projections,
row-parallel down-projections), optionally sharded over ``fsdp`` on the
other dimension; the batch over ``(dp, fsdp)``, the sequence over
``sp``. The port stores matmul weights as ``nn.Linear`` does,
[out, in], the transpose of the reference's [in, out], so each matmul
weight's spec has its two entries swapped: the reference's
``wq: P(fsdp, tp)`` is ``("tp", fsdp)`` here.

What runs: dp and sp replicate every weight (``shard_params`` makes the
replicas identical by a broadcast from rank 0). A mesh whose ``fsdp``,
``tp``, ``pp`` or ``ep`` axis is above 1 raises ``NotImplementedError``:
fully sharded data parallelism and tensor parallelism read these specs
in a later slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from . import comm
from .mesh import Mesh


class P(tuple):
    """A partition spec: one mesh axis name (or None: replicated) per
    tensor dimension; ``P()`` replicates the whole tensor."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


NOT_PORTED_AXES = ("fsdp", "tp", "pp", "ep")


def check_mesh(mesh: Mesh) -> None:
    """Refuse a mesh this slice cannot run: dp and sp only."""
    over = {a: mesh.shape[a] for a in NOT_PORTED_AXES if mesh.shape[a] > 1}
    if over:
        raise NotImplementedError(
            f"mesh axes {over} are not ported yet: this port runs dp and sp "
            "(fully sharded data parallelism, tensor, pipeline and expert "
            "parallelism are ROADMAP Queue 1 item 5)")


def llama_param_spec(fsdp: bool = True) -> Dict:
    """Spec tree of a ``Llama``'s parameters, keyed by their names
    (``layers.<i>.<name>`` use the ``__layers__`` entry). Patterns, on
    the port's [out, in] weights:

    - wq/wk/wv, w_gate/w_up: column-parallel -> P('tp', fsdp?)
    - wo, w_down:            row-parallel    -> P(fsdp?, 'tp')
    - embed [vocab, dim] and lm_head [vocab, dim]: vocab-sharded on tp
    - norms: replicated
    """
    f = "fsdp" if fsdp else None

    def layer_spec():
        return {
            "attn_norm": P(),
            "wq": P("tp", f),
            "wk": P("tp", f),
            "wv": P("tp", f),
            "wo": P(f, "tp"),
            "mlp_norm": P(),
            "w_gate": P("tp", f),
            "w_up": P("tp", f),
            "w_down": P(f, "tp"),
        }

    return {
        "embed": P("tp", None),
        "final_norm": P(),
        "lm_head": P("tp", f),
        "__layers__": layer_spec,
    }


def build_param_specs(model: nn.Module, fsdp: bool = True) -> Dict[str, P]:
    """``{parameter name: spec}`` for a concrete model: a ``Llama``'s by
    ``llama_param_spec``, every other parameter replicated."""
    template = llama_param_spec(fsdp)
    layer = template["__layers__"]()
    specs: Dict[str, P] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) == 3 and parts[2] in layer:
            specs[name] = layer[parts[2]]
        elif name in template and name != "__layers__":
            specs[name] = template[name]
        else:
            specs[name] = P()
    return specs


def apply_specs(params: Dict[str, torch.Tensor], specs: Dict[str, P],
                fn: Callable[[torch.Tensor, P], torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``{name: fn(param, spec)}`` over a flat name -> tensor dict."""
    return {name: fn(p, specs[name]) for name, p in params.items()}


def shard_params(model: nn.Module, mesh: Mesh, fsdp: bool = True,
                 src: int = 0) -> nn.Module:
    """Place ``model`` on ``mesh``: on the axes this slice runs (dp, sp)
    every weight is replicated, so every rank's copy is overwritten in
    place with rank ``src``'s. Returns the model. ``fsdp`` is the
    reference's flag; with the fsdp axis at 1 it changes nothing."""
    check_mesh(mesh)
    group = comm.world()
    with torch.no_grad():
        for p in model.parameters():
            comm.broadcast_(p.data, src, group)
    return model


@dataclass(frozen=True)
class BatchSharding:
    """Where a batch's dims go: dim 0 over ``batch_axes`` (together),
    dim 1 over ``seq_axis`` when it is set."""
    mesh: Mesh
    batch_axes: Tuple[str, ...] = ("dp", "fsdp")
    seq_axis: Optional[str] = None

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a GLOBAL batch tensor."""
        shards, index = 1, 0
        for axis in self.batch_axes:
            shards *= self.mesh.shape[axis]
            index = index * self.mesh.shape[axis] + self.mesh.coords[axis]
        if x.shape[0] % shards:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{shards} ranks of {self.batch_axes}")
        rows = x.shape[0] // shards
        x = x[index * rows:(index + 1) * rows]
        if self.seq_axis is not None:
            n = self.mesh.shape[self.seq_axis]
            if x.shape[1] % n:
                raise ValueError(f"sequence {x.shape[1]} does not split "
                                 f"over {n} ranks of {self.seq_axis}")
            cols = x.shape[1] // n
            lo = self.mesh.coords[self.seq_axis] * cols
            x = x[:, lo:lo + cols]
        return x

    def shard_all(self, batch: Sequence[torch.Tensor]) -> Tuple:
        return tuple(self.shard(x) for x in batch)


def batch_sharding(mesh: Mesh, seq_axis: Optional[str] = None
                   ) -> BatchSharding:
    """Tokens [B, T]: batch over (dp, fsdp), optionally sequence over
    sp."""
    return BatchSharding(mesh, ("dp", "fsdp"), seq_axis)
