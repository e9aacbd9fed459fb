"""AfMoE decoder (Arcee's Trinity models, ``model_type`` ``afmoe``),
inference through the KV cache; no reference in the JAX package (the
benchmark's plain reference is ``perfbench/reference/afmoe_ref.py``).

A layer is either a sliding-window layer, whose attention sees the last
``window`` positions and applies the half-split rotary embedding, or a
full layer, causal over the whole context and without rotary. Each
block has sandwich norms:

    x = x + post_attn_norm(attention(attn_norm(x)))
    x = x + post_mlp_norm(mlp(mlp_norm(x)))

The attention projects q, k and v, RMS-normalises q and k per head
(``q_norm``, ``k_norm`` over the head dim), attends with grouped-query
heads and multiplies its output by ``sigmoid(w_attn_gate h)`` (h the
attention's input) before the output projection. The first
``dense_layers`` blocks have a SwiGLU MLP; the others the dropless
expert layer of ``models/moe.py`` (a sigmoid router with a selection
bias, top-k of every expert, the weights normalised and scaled) plus a
shared expert. The embedding is multiplied by sqrt(dim) (muP), then a
final RMSNorm and an untied head. Weights are stored as for an inference
``Llama``: matrices in ``cfg.dtype`` in the [out, in] layout, norm
scales, router and bias in float32. Each product takes its operands in
``cfg.dtype``; the residual stream, the norms and the router stay
float32.

The cache (``models/llama.py::init_kv_cache``) holds a ring of
``window`` slots for each sliding layer and ``max_seq_len`` slots for
each full layer, so ``DecodeServer`` serves the model as it serves a
``Llama``: ``prefill_slot`` admits a prompt through ``apply_cached`` on
an empty row, and one decode step, captured as a CUDA graph, writes and
reads both kinds in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha
from ..utils.trace import SpanLog
from .common import rmsnorm
from .llama import (
    _attend_ring, _matmul, _rope, cache_positions, cache_slots, store,
    write_index,
)
from .moe import dropless_moe, expert_slots

SLIDING = "sliding_attention"
FULL = "full_attention"


@dataclass(frozen=True)
class AfmoeConfig:
    """What the cached apply reads beside the weights, whose shapes give
    the widths, the experts and which blocks are dense."""
    dim: int
    layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    top_k: int
    layer_types: Tuple[str, ...]  # SLIDING or FULL, one a layer
    window: int
    max_seq_len: int              # the full layers' cache
    rope_theta: float = 10000.0
    eps: float = 1e-5
    route_scale: float = 1.0
    route_norm: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.layer_types) != self.layers:
            raise ValueError(f"{len(self.layer_types)} layer types for "
                             f"{self.layers} layers")
        unknown = set(self.layer_types) - {SLIDING, FULL}
        if unknown:
            raise ValueError(f"layer types {sorted(unknown)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def windows(self) -> Tuple[int, ...]:
        """Each layer's window: ``window`` on a sliding layer, 0 (full
        causal) on a full one."""
        return tuple(self.window if t == SLIDING else 0
                     for t in self.layer_types)


def _frozen(w: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(w, requires_grad=False)


class AfmoeBlock(nn.Module):
    """One block's weights, under the names of ``ATTENTION`` and of
    ``DENSE`` or ``ROUTED``. ``experts``: a routed block's held experts'
    global ids, in the order of its expert weights (all of them by
    default); the block keeps each global expert's held index
    (``slots``)."""

    ATTENTION = ("attn_norm", "wq", "wk", "wv", "q_norm", "k_norm",
                 "w_attn_gate", "wo", "post_attn_norm", "mlp_norm",
                 "post_mlp_norm")
    DENSE = ("w_gate", "w_up", "w_down")
    ROUTED = ("router", "expert_bias", "experts_gate", "experts_up",
              "experts_down", "shared_gate", "shared_up", "shared_down")

    def __init__(self, experts: Optional[Sequence[int]] = None,
                 **weights: torch.Tensor):
        super().__init__()
        self.routed = "router" in weights
        names = self.ATTENTION + (self.ROUTED if self.routed else self.DENSE)
        if set(weights) != set(names):
            raise ValueError(f"block weights {sorted(weights)}; want "
                             f"{sorted(names)}")
        for name in names:
            setattr(self, name, _frozen(weights[name]))
        if self.routed:
            total = self.router.shape[0]
            held = torch.tensor(list(range(total)) if experts is None
                                else list(experts), dtype=torch.int64,
                                device=self.router.device)
            if len(held) != self.experts_gate.shape[0]:
                raise ValueError(f"{len(held)} expert ids for "
                                 f"{self.experts_gate.shape[0]} experts")
            self.register_buffer("slots", expert_slots(held, total))


class Afmoe(nn.Module):
    """The model: embedding [vocab, dim], the blocks, the final norm and
    the head [vocab, dim]. ``expert_load`` [routed layers, experts
    held] (int64, on the device) counts the routes each expert took;
    ``trace`` holds the ``moe.route`` spans of eager calls."""

    def __init__(self, cfg: AfmoeConfig, embed: torch.Tensor,
                 layers: Sequence[AfmoeBlock], final_norm: torch.Tensor,
                 lm_head: torch.Tensor):
        super().__init__()
        if len(layers) != cfg.layers:
            raise ValueError(f"{len(layers)} blocks for a {cfg.layers}-layer "
                             "config")
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        routed = [b for b in layers if b.routed]
        held = routed[0].experts_gate.shape[0] if routed else 0
        self.register_buffer("expert_load", torch.zeros(
            len(routed), held, dtype=torch.int64, device=embed.device))
        self.trace = SpanLog()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def apply_cached(self, tokens, cache, live=None):
        return afmoe_apply_cached(self, tokens, cache, live)


def _mlp(block: AfmoeBlock, h: torch.Tensor, cfg: AfmoeConfig, load,
         live, trace) -> torch.Tensor:
    """The block's MLP on h [B, T, dim]."""
    dtype = cfg.torch_dtype
    if not block.routed:
        gate = F.silu(_matmul(h, block.w_gate, dtype))
        return _matmul(gate * _matmul(h, block.w_up, dtype), block.w_down,
                       dtype)
    flat = h.reshape(-1, h.shape[-1])
    out = dropless_moe(
        flat, block.router, block.expert_bias, block.experts_gate,
        block.experts_up, block.experts_down, block.slots, cfg.top_k,
        cfg.route_scale, cfg.route_norm,
        shared=(block.shared_gate, block.shared_up, block.shared_down),
        load=load, live=live, trace=trace)
    return out.view(h.shape)


def afmoe_apply_cached(model: Afmoe, tokens: torch.Tensor, cache: Dict,
                       live: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Run [B, T] new tokens against the cache and write them into it;
    returns (float32 logits [B, T, vocab], cache), the cache updated in
    place as ``llama_apply_cached``'s is. ``live`` [B, T] (bool) marks
    the tokens ``model.expert_load`` counts (all when None): not a
    prompt's bucket padding, not a decode step's idle lanes.

    T == 1 decodes (a scalar or a per-slot length): each layer stores
    the position, then attends over its cache. T > 1 prefills an EMPTY
    cache (length 0, as ``prefill_slot``'s row is): attention over the
    chunk alone (``mha``: the flash kernels on the card), then the
    chunk is stored; continuing a filled cache with a chunk is not
    supported."""
    cfg = model.cfg
    dtype = cfg.torch_dtype
    batch, seq = tokens.shape
    hd = cfg.head_dim
    start = cache["length"]
    per_slot = start.dim() == 1
    if per_slot and seq != 1:
        raise ValueError("per-slot cache accepts seq == 1 only; admit "
                         "prompts via prefill_slot")
    if seq > cache_slots(cfg):
        raise ValueError(f"cannot prefill {seq} positions into a "
                         f"{cache_slots(cfg)}-slot ring")
    positions = cache_positions(start, seq)
    rows = torch.arange(batch, device=tokens.device) if per_slot else None
    trace = model.trace if seq > 1 else None
    if live is not None:
        live = live.reshape(-1)
    # the residual stream stays float32 between the products, so the
    # router chooses on a state rounded only where a product rounds it
    x = model.embed.to(dtype)[tokens].float() * math.sqrt(cfg.dim)
    routed = 0
    for i, (block, window) in enumerate(zip(model.layers, cfg.windows)):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        slots = k_cache.shape[2]
        h = rmsnorm(block.attn_norm, x, cfg.eps)
        q = _matmul(h, block.wq, dtype).view(batch, seq, cfg.num_heads, hd)
        k = _matmul(h, block.wk, dtype).view(batch, seq, cfg.num_kv_heads, hd)
        v = _matmul(h, block.wv, dtype).view(batch, seq, cfg.num_kv_heads, hd)
        q = rmsnorm(block.q_norm, q, cfg.eps).transpose(1, 2)
        k = rmsnorm(block.k_norm, k, cfg.eps).transpose(1, 2)
        v = v.transpose(1, 2)
        if window > 0:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
        write = write_index(positions, slots)
        store(k_cache, k, write, rows)
        store(v_cache, v, write, rows)
        if seq == 1:
            out = _attend_ring(q, k_cache, v_cache, start + 1, cfg.num_heads,
                               cfg.num_kv_heads, window)
        else:
            out = mha(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=True, window=window)
        out = out.to(dtype).transpose(1, 2).reshape(batch, seq, -1)
        gate = torch.sigmoid(_matmul(h, block.w_attn_gate, dtype).float())
        out = (out.float() * gate).to(dtype)
        x = x + rmsnorm(block.post_attn_norm,
                        _matmul(out, block.wo, dtype).float(), cfg.eps)
        h = rmsnorm(block.mlp_norm, x, cfg.eps)
        load = model.expert_load[routed] if block.routed else None
        routed += block.routed
        x = x + rmsnorm(block.post_mlp_norm,
                        _mlp(block, h, cfg, load, live, trace).float(),
                        cfg.eps)
    x = rmsnorm(model.final_norm, x, cfg.eps)
    logits = _matmul(x, model.lm_head, dtype).float()
    start.add_(seq)
    return logits, cache
