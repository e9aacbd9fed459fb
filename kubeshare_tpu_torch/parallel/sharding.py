"""Partition specs of the model families, and their placement on the
rank mesh (port of ``kubeshare_tpu/parallel/sharding.py``).

The spec trees are the reference's, kept as data: weights
tensor-parallel over ``tp`` (column-parallel up-projections,
row-parallel down-projections), optionally sharded over ``fsdp`` on the
other dimension (ZeRO-3); the batch over ``(dp, fsdp)``, the sequence
over ``sp``. The port stores matmul weights as ``nn.Linear`` does,
[out, in], the transpose of the reference's [in, out], so each matmul
weight's spec has its two entries swapped: the reference's
``wq: P(fsdp, tp)`` is ``("tp", fsdp)`` here.

``shard_params`` makes every rank's weights rank ``src``'s (a broadcast)
and then keeps each rank's block of every weight by its spec
(``shard_tensor``). Where the reference lets GSPMD insert the
collectives a layout implies, the port's forward must know the layout:
a ``Llama``'s placement is recorded in ``model.shards`` (a
``LlamaShards``), which ``models/llama.py`` reads to run its blocks
tensor-parallel (local heads, ``comm.copy_to`` / ``comm.reduce_from``
around each column / row pair, the vocab-sharded embedding and loss)
and to gather its fsdp shards around each product (``parallel/fsdp.py``).
Any other model runs only replicated weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from . import comm
from .fsdp import fsdp_linear, gather_weight
from .mesh import Mesh


class P(tuple):
    """A partition spec: one mesh axis name (or None: replicated) per
    tensor dimension; ``P()`` replicates the whole tensor."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):   # pickles as P(*axes), not P(axes)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def check_specs(specs: Mapping[str, P], mesh: Mesh) -> None:
    """Refuse a spec that names an axis the mesh does not have, or one
    axis twice."""
    for name, spec in specs.items():
        seen = [a for entry in spec for a in _axes(entry)]
        unknown = set(seen) - set(mesh.axis_names)
        if unknown or len(seen) != len(set(seen)):
            raise ValueError(f"{name}: spec {spec} on mesh axes "
                             f"{mesh.axis_names}")


def shard_tensor(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` laid out by ``spec`` on ``mesh``: dim i
    split over the axes of ``spec[i]`` (several together in row-major
    order, as ``P(("dp", "fsdp"))``), a new contiguous tensor. A dim
    that does not split evenly raises (GSPMD would pad it)."""
    for dim, entry in enumerate(spec):
        shards, index = 1, 0
        for axis in _axes(entry):
            shards *= mesh.shape[axis]
            index = index * mesh.shape[axis] + mesh.coords[axis]
        if shards == 1:
            continue
        if x.shape[dim] % shards:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {shards} ranks of {entry}")
        size = x.shape[dim] // shards
        x = x.narrow(dim, index * size, size)
    return x.clone(memory_format=torch.contiguous_format)


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


@dataclass(frozen=True)
class LlamaShards:
    """Where a ``Llama``'s weights lie on the rank mesh
    (``shard_params`` records it as ``model.shards``). Each of the
    ``tp`` ranks of ``tp_group`` holds its ``1 / tp`` of the heads, the
    MLP's hidden units and the vocabulary rows, at rank ``tp_rank``; each
    leaf named in ``fsdp_dims`` (``wq``, ``lm_head`` ...) is further split
    over ``fsdp_group`` along that dim and gathered around its use."""
    tp_group: comm.Group = None
    tp: int = 1
    tp_rank: int = 0
    fsdp_group: comm.Group = None
    fsdp_dims: Mapping[str, int] = field(default_factory=dict)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into the tp region (column-parallel products follow)."""
        return comm.copy_to(x, self.tp_group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """Out of the tp region: the row-parallel partial sums, summed."""
        return comm.reduce_from(x, self.tp_group)

    def whole(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """Leaf ``name``'s tp-local weight, gathered over fsdp."""
        if name in self.fsdp_dims:
            return gather_weight(w, self.fsdp_group, self.fsdp_dims[name])
        return w

    def project(self, name: str, x: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """``x @ w.T`` of an fsdp-split leaf (``name in fsdp_dims``)."""
        return fsdp_linear(x, w, self.fsdp_group, self.fsdp_dims[name],
                           dtype)


# The tp dim of each Llama leaf that tp splits (column-parallel
# projections split their output rows, row-parallel ones their input
# columns; the embedding and the lm head split the vocabulary).
_LLAMA_TP_DIM = {"wq": 0, "wk": 0, "wv": 0, "w_gate": 0, "w_up": 0,
                 "wo": 1, "w_down": 1, "embed": 0, "lm_head": 0}


def _llama_shards(model, specs: Mapping[str, P], mesh: Mesh) -> LlamaShards:
    cfg, tp = model.cfg, mesh.shape["tp"]
    if tp > 1 and (cfg.num_heads % tp or cfg.num_kv_heads % tp):
        raise ValueError(f"{cfg.num_heads} heads and {cfg.num_kv_heads} kv "
                         f"heads do not split over tp={tp}")
    fsdp_dims: Dict[str, int] = {}
    for name, spec in specs.items():
        leaf = name.split(".")[-1]
        placed = {a: dim for dim, entry in enumerate(spec)
                  for a in _axes(entry) if mesh.shape[a] > 1}
        other = set(placed) - {"tp", "fsdp"}
        if other:
            raise ValueError(f"{name}: a Llama's weights split over tp and "
                             f"fsdp only, not {sorted(other)}")
        if placed.get("tp") != (_LLAMA_TP_DIM.get(leaf) if tp > 1 else None):
            raise ValueError(f"{name}: spec {spec} is not the reference's "
                             "tensor-parallel layout (llama_param_spec)")
        if "fsdp" in placed:
            if fsdp_dims.setdefault(leaf, placed["fsdp"]) != placed["fsdp"]:
                raise ValueError(f"{name}: every layer's {leaf} must split "
                                 "over fsdp along one dim")
        elif leaf in fsdp_dims:
            raise ValueError(f"{name}: every layer's {leaf} must split "
                             "over fsdp alike")
    return LlamaShards(mesh.group("tp"), tp, mesh.coords["tp"],
                       mesh.group("fsdp"), fsdp_dims)


def shard_params(model: nn.Module, mesh: Mesh, fsdp: bool = True,
                 src: int = 0, specs: Optional[Mapping[str, P]] = None
                 ) -> nn.Module:
    """Place ``model`` on ``mesh`` in place and return it: every rank's
    weights are first made rank ``src``'s (a broadcast over the world),
    then each rank keeps its block of every weight by ``specs`` (default
    ``build_param_specs(model, fsdp)``). A ``Llama`` records the layout
    in ``model.shards`` (``LlamaShards``); any other model must stay
    replicated."""
    from ..models.llama import Llama

    if specs is None:
        specs = build_param_specs(model, fsdp)
    names = {name for name, _ in model.named_parameters()}
    if set(specs) != names:
        raise ValueError(f"specs for {sorted(set(specs) ^ names)} do not "
                         "match the model's parameters")
    check_specs(specs, mesh)
    split = {name for name, spec in specs.items()
             if any(mesh.shape[a] > 1 for e in spec for a in _axes(e))}
    if isinstance(model, Llama):
        shards = _llama_shards(model, specs, mesh)
    elif split:
        raise ValueError(f"{sorted(split)}: only a Llama runs on split "
                         "weights")
    group = comm.world()
    with torch.no_grad():
        for name, p in model.named_parameters():
            comm.broadcast_(p.data, src, group)
            if name in split:
                p.data = shard_tensor(p.data, specs[name], mesh)
    if isinstance(model, Llama):
        model.shards = shards if split else None
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
