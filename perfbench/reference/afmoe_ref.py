"""The plain reference of the afmoe family (``families/afmoe.py``; Arcee's
Trinity models, ``model_type`` ``afmoe``): the model as its configuration
file describes it, in float32 with plain ``torch`` operations (TF32
off), one sequence at a time, no cache, no kernels, no batching. It
imports only ``torch``; nothing of the program under test.

The model, as the published configuration and Hugging Face's
``modeling_afmoe.py`` describe it:
- the embedding times sqrt(hidden) (``mup_enabled``);
- each block with sandwich norms: RMSNorm -> attention -> RMSNorm ->
  residual; RMSNorm -> MLP -> RMSNorm -> residual;
- attention: q, k, v projections (heads of ``head_dim``, which need not
  divide hidden); an RMSNorm over the head dim of each q and k head;
  on a ``sliding_attention`` layer the half-split rotary embedding
  (``rope_theta``; angles in float64) and a window W (key j is seen from
  query i when i - W < j <= i); on a ``full_attention`` layer no rotary
  and every earlier key; grouped-query heads (query head h reads kv
  head h // (H / Hkv)), softmax(q k^T / sqrt(head_dim)); the heads'
  output times sigmoid(gate_proj(h)), h the attention's input, then the
  output projection;
- the MLP: SwiGLU of ``intermediate_size`` on the first
  ``num_dense_layers`` layers; after them the routed experts: scores
  s = sigmoid(router h) over all ``num_experts``, a token's experts the
  ``num_experts_per_tok`` largest s + bias (the bias selects only),
  weighted by their s normalised to sum 1 (``route_norm``) times
  ``route_scale``, each expert a SwiGLU of ``moe_intermediate_size``;
  plus one shared SwiGLU expert (``num_shared_experts`` x
  ``moe_intermediate_size`` wide) for every token;
- a final RMSNorm and an untied head.

Departures, each from what a run needs, none from the equations: the
attention is computed in blocks of ``QUERY_BLOCK`` queries, so that a
context of ten thousand tokens fits on the card (the same numbers as
one softmax over all keys); the experts run one after another over the
tokens that chose them; ``held`` keeps only the routed experts a rank
holds (the chip's share of a deployment that divides each layer's
experts; every expert by default), whose partial result goes on to the
next layer, as the program's. ``quant`` (the control) is applied to
both operands of every product, the router's and the attention's
included, along their contraction axis: ``common.fp8`` rounds to
float8 (e4m3) with a scale per row.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]
QUERY_BLOCK = 512


def _q(quant: Quant, x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if quant is None else quant(x, dim)


def linear(x: torch.Tensor, w: torch.Tensor, quant: Quant = None):
    """x [..., in] @ w[out, in]^T."""
    return _q(quant, x, -1) @ _q(quant, w, -1).t()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [H, T, D]: the first and second halves of D rotated as pairs."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    angles = positions.to(torch.float64)[:, None] * freqs
    cos, sin = angles.cos().float(), angles.sin().float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, window: int, quant: Quant = None):
    """q [H, T, D], k and v [Hkv, T, D] -> [H, T, D], causal, limited to
    the last ``window`` keys when it is > 0; QUERY_BLOCK queries at a
    time."""
    groups = q.shape[0] // k.shape[0]
    k = _q(quant, k.repeat_interleave(groups, dim=0), -1)
    v = _q(quant, v.repeat_interleave(groups, dim=0), -2)
    t = q.shape[1]
    j = torch.arange(t, device=q.device)[None, :]
    out = []
    for lo in range(0, t, QUERY_BLOCK):
        qb = _q(quant, q[:, lo:lo + QUERY_BLOCK], -1)
        scores = qb @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        i = torch.arange(lo, lo + qb.shape[1], device=q.device)[:, None]
        seen = j <= i
        if window > 0:
            seen &= j > i - window
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), -1)
        out.append(_q(quant, probs, -1) @ v)
    return torch.cat(out, dim=1)


def swiglu(h, gate, up, down, quant: Quant = None):
    return linear(F.silu(linear(h, gate, quant)) * linear(h, up, quant),
                  down, quant)


def experts(spec, w: Dict[str, torch.Tensor], h: torch.Tensor,
            held: Optional[Sequence[int]] = None,
            quant: Quant = None) -> torch.Tensor:
    """The expert layer on h [T, dim]: the routed experts in ``held``
    (global ids, in the order of ``w``'s expert weights; every expert
    when None), plus the shared expert."""
    scores = torch.sigmoid(linear(h, w["router"], quant))          # [T, E]
    chosen = torch.topk(scores + w["expert_bias"], spec.top_k, -1).indices
    weights = scores.gather(-1, chosen)
    if spec.route_norm:
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * spec.route_scale
    out = swiglu(h, w["shared_gate"], w["shared_up"], w["shared_down"],
                 quant)
    ids = range(scores.shape[-1]) if held is None else held
    for local, expert in enumerate(ids):
        token, route = (chosen == expert).nonzero(as_tuple=True)
        if len(token):
            y = swiglu(h[token], w["experts_gate"][local],
                       w["experts_up"][local], w["experts_down"][local],
                       quant)
            out = out.index_add(0, token, y * weights[token, route, None])
    return out


def block(spec, w: Dict[str, torch.Tensor], x: torch.Tensor, layer: int,
          held: Optional[Sequence[int]] = None,
          quant: Quant = None) -> torch.Tensor:
    """Block ``layer`` on one sequence's hidden states x [T, dim]."""
    t = x.shape[0]
    h = rmsnorm(x, w["attn_norm"], spec.eps)
    q = linear(h, w["wq"], quant).view(t, spec.heads, -1)
    k = linear(h, w["wk"], quant).view(t, spec.kv_heads, -1)
    v = linear(h, w["wv"], quant).view(t, spec.kv_heads, -1)
    q = rmsnorm(q, w["q_norm"], spec.eps).transpose(0, 1)
    k = rmsnorm(k, w["k_norm"], spec.eps).transpose(0, 1)
    v = v.transpose(0, 1)
    window = spec.windows[layer]
    if window > 0:
        positions = torch.arange(t, device=x.device)
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    out = attend(q, k, v, window, quant).transpose(0, 1).reshape(t, -1)
    out = out * torch.sigmoid(linear(h, w["w_attn_gate"], quant))
    x = x + rmsnorm(linear(out, w["wo"], quant), w["post_attn_norm"],
                    spec.eps)
    h = rmsnorm(x, w["mlp_norm"], spec.eps)
    if "router" in w:
        y = experts(spec, w, h, held, quant)
    else:
        y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"], quant)
    return x + rmsnorm(y, w["post_mlp_norm"], spec.eps)


@torch.no_grad()
def logits_at(spec, embed: torch.Tensor,
              layer_weights: Callable[[int], Dict[str, torch.Tensor]],
              final_norm: torch.Tensor, head: torch.Tensor,
              sequences: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor],
              quant: Quant = None,
              held: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Float32 logits [len(p), vocab] at ``positions`` p of each sequence
    (token ids [T]), layer by layer: ``layer_weights(i)`` gives block i's
    weights in float32, drawn once for all the sequences."""
    xs = [embed[s].float() * math.sqrt(spec.dim) for s in sequences]
    for i in range(spec.layers):
        w = layer_weights(i)
        xs = [block(spec, w, x, i, held, quant) for x in xs]
        del w
    return [linear(rmsnorm(x[p], final_norm, spec.eps), head, quant)
            for x, p in zip(xs, positions)]
