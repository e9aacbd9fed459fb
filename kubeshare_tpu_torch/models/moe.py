"""Mixture-of-Experts FFN with expert parallelism, GShard/Switch style
(port of ``kubeshare_tpu/models/moe.py``).

Top-k routing as one-hot dispatch and combine einsums (static shapes,
no gather or scatter), capacity-factor token dropping, and the Switch
load-balancing auxiliary loss, as the reference computes them. The
weights are a dict of float32 tensors in the port's [out, in] layout:
``router`` [E, D], ``w_gate`` and ``w_up`` [E, H, D], ``w_down``
[E, D, H] (the reference's [D, E], [E, D, H] and [E, H, D] with the last
two dims swapped; ``models/convert.py`` maps them).

Expert parallelism follows the reference's specs (``moe_param_spec``:
experts over ``ep``, the hidden dim over ``tp``) with the tokens
replicated over ``ep``: every rank computes the same router, dispatch
and combine from the whole batch, so capacity counts the global tokens
and every rank drops exactly the tokens the reference drops; each rank
runs only its ``E / ep`` experts (and its ``H / tp`` hidden slice), and
the partial outputs are summed over ``ep`` and ``tp``
(``comm.reduce_from``). In the backward the tokens' and the combine
weights' gradients, which each rank holds only for its experts, are
summed over the same ranks (``comm.copy_to``) before they reach the
router, so every rank ends with the whole gradient of x and the router.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import DeviceLike, resolve_device
from .common import init_generator


@dataclass(frozen=True)
class MoeConfig:
    dim: int = 256
    mlp_dim: int = 512
    experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_moe_ffn(cfg: MoeConfig, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random float32 weights from ``generator`` (default: seed 0 on
    ``device``): N(0, 1/D) router and up-projections, N(0, 1/H) down."""
    device = resolve_device(device)
    generator = init_generator(generator, device)

    def normal(*shape, fan_in):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32) * fan_in ** -0.5

    e, d, h = cfg.experts, cfg.dim, cfg.mlp_dim
    return {"router": normal(e, d, fan_in=d),
            "w_gate": normal(e, h, d, fan_in=d),
            "w_up": normal(e, h, d, fan_in=d),
            "w_down": normal(e, d, h, fan_in=h)}


def moe_capacity(cfg: MoeConfig, tokens: int) -> int:
    """Capacity slots per expert, from the whole batch's token count."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.experts))


def _dispatch_tensors(probs: torch.Tensor, cfg: MoeConfig, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [S, E] -> (dispatch [S, E, C] of 0/1, combine [S, E, C]).

    Iterative top-k: each round takes every token's best remaining
    expert, assigns a capacity slot via a running per-expert counter,
    and masks that expert out for the next round."""
    tokens = probs.shape[0]
    dispatch = probs.new_zeros((tokens, cfg.experts, capacity))
    combine = probs.new_zeros((tokens, cfg.experts, capacity))
    remaining = probs
    # slots already used per expert by earlier rounds: [E]
    used = torch.zeros(cfg.experts, dtype=torch.int64, device=probs.device)
    for _ in range(cfg.top_k):
        gate = remaining.amax(dim=1)                       # [S]
        idx = remaining.argmax(dim=1)     # the first best, as jnp.argmax
        onehot = F.one_hot(idx, cfg.experts).to(probs.dtype)   # [S, E]
        # position of each token within its chosen expert this round
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
        pos = pos.sum(dim=1).to(torch.int64) + used[idx]
        keep = pos < capacity
        slot = F.one_hot(torch.where(keep, pos, capacity),
                         capacity + 1)[:, :capacity].to(probs.dtype)
        contrib = (onehot[:, :, None] * slot[:, None, :]
                   * keep[:, None, None].to(probs.dtype))
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, None, None]
        used = used + onehot.sum(dim=0).to(torch.int64)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def moe_ffn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: MoeConfig, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D], aux_loss scalar).

    Dropped tokens (over capacity) pass through as zeros: the caller's
    residual connection carries them unchanged, the standard Switch
    behaviour. With ``mesh`` (a rank mesh whose ``ep`` and ``tp`` axes
    lay out the weights, ``moe_param_spec``) ``params`` holds this
    rank's experts and hidden slice, and x, y and aux are the whole
    batch's on every rank."""
    from ..parallel import comm

    dtype = cfg.torch_dtype
    batch, seq, dim = x.shape
    tokens = batch * seq
    xf = x.reshape(tokens, dim)
    logits = xf.float() @ params["router"].t()            # [S, E]
    probs = torch.softmax(logits, dim=-1)
    capacity = moe_capacity(cfg, tokens)
    dispatch, combine = _dispatch_tensors(probs, cfg, capacity)

    local = params["w_gate"].shape[0]
    first = 0
    groups = []
    if mesh is not None:
        first = mesh.coords["ep"] * local
        groups = [g for g in (mesh.group("ep"), mesh.group("tp"))
                  if g is not None]
    # each rank's gradient of x and of the combine weights covers its
    # experts (and hidden slice) only: summed over the ranks backward
    x_in, weights = xf, combine
    for group in groups:
        x_in = comm.copy_to(x_in, group)
        weights = comm.copy_to(weights, group)
    weights = weights[:, first:first + local]
    # route tokens to this rank's expert buffers: [E_local, C, D]
    expert_in = torch.einsum("sec,sd->ecd",
                             dispatch[:, first:first + local].to(dtype),
                             x_in.to(dtype))
    gate = F.silu(torch.einsum("ecd,ehd->ech", expert_in,
                               params["w_gate"].to(dtype)))
    up = torch.einsum("ecd,ehd->ech", expert_in, params["w_up"].to(dtype))
    out = torch.einsum("ech,edh->ecd", gate * up, params["w_down"].to(dtype))
    y = torch.einsum("sec,ecd->sd", weights.to(dtype), out)
    if groups:      # the partial outputs summed in float32
        y = y.float()
    for group in groups:
        y = comm.reduce_from(y, group)

    # load-balancing aux: E * mean_e(frac_tokens_e * frac_probs_e)
    frac_tokens = dispatch.sum(dim=(0, 2)) / max(1, tokens * cfg.top_k)
    frac_probs = probs.mean(dim=0)
    aux = cfg.experts * torch.sum(frac_tokens * frac_probs)
    return y.reshape(batch, seq, dim).to(x.dtype), aux


def moe_param_spec():
    """Partition specs of the port's [out, in] weights: experts over
    ep, the hidden dim over tp, the router replicated (the reference's
    specs with the last two dims swapped)."""
    from ..parallel.sharding import P

    return {
        "router": P(),
        "w_gate": P("ep", "tp", None),
        "w_up": P("ep", "tp", None),
        "w_down": P("ep", None, "tp"),
    }


def expert_slots(experts: torch.Tensor, total: int) -> torch.Tensor:
    """[total] int64: each expert's index among ``experts`` (the global
    ids a rank holds), or ``len(experts)`` for one held elsewhere."""
    slots = torch.full((total,), len(experts), dtype=torch.int64,
                       device=experts.device)
    slots[experts] = torch.arange(len(experts), device=experts.device)
    return slots


def _grouped(x: torch.Tensor, w: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [N, in] grouped by ``offsets`` (group g ends at row
    offsets[g]) times group g's [out, in] weight of ``w`` [G, out, in];
    rows past the last offset come back undefined."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offsets)


def dropless_moe(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, slots: torch.Tensor, top_k: int,
                 route_scale: float, route_norm: bool = True,
                 shared: Optional[Tuple[torch.Tensor, ...]] = None,
                 load: Optional[torch.Tensor] = None,
                 live: Optional[torch.Tensor] = None,
                 trace=None) -> torch.Tensor:
    """x [N, D] -> [N, D] in x's dtype: the routed experts this rank
    holds, plus the shared expert.

    ``router`` [E, D] and ``bias`` [E] (float32) score every expert:
    ``s = sigmoid(router x)``; a token's experts are the ``top_k``
    largest ``s + bias`` (the bias selects only), weighted by their
    ``s``, normalised to sum 1 with ``route_norm``, times
    ``route_scale``. ``w_gate``, ``w_up`` [E_held, H, D] and ``w_down``
    [E_held, D, H] are the held experts' SwiGLU weights, in the order of
    ``slots`` (``expert_slots``: each global expert's held index, or
    E_held). Routes to an expert held elsewhere add nothing here: the
    partial result of this rank's share. ``shared``: (gate, up, down)
    of the shared expert ([H_s, D], [H_s, D], [D, H_s]), computed for
    every token. ``load`` [E_held] (int64), when given, gains the routes
    each held expert took from the tokens ``live`` [N] (bool) marks,
    every token when None. ``trace`` (a ``SpanLog``) records the
    router and the sort as ``moe.route``; leave it None inside a CUDA
    graph's capture."""
    tokens, dim = x.shape
    held = w_gate.shape[0]
    dtype = w_gate.dtype
    span = trace.span("moe.route").start() if trace is not None else None
    scores = torch.sigmoid(F.linear(x.float(), router))            # [N, E]
    chosen = torch.topk(scores + bias, top_k, dim=-1).indices      # [N, k]
    weights = scores.gather(-1, chosen)
    if route_norm:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    weights = weights * route_scale
    local = slots[chosen].flatten()                                # [N k]
    order = torch.argsort(local, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, local, torch.ones_like(local))
    offsets = torch.cumsum(counts[:held], 0).to(torch.int32)
    rows = torch.div(order, top_k, rounding_mode="floor")          # token
    if span is not None:
        span.end()
    xs = x.to(dtype)[rows]
    h = F.silu(_grouped(xs, w_gate, offsets)) * _grouped(xs, w_up, offsets)
    ys = _grouped(h, w_down, offsets).float()
    mine = (local[order] < held)[:, None]
    ys = torch.where(mine, ys * weights.flatten()[order][:, None], 0.0)
    out = torch.zeros(tokens, dim, dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, ys)
    if shared is not None:
        gate, up, down = (w.to(dtype) for w in shared)
        xd = x.to(dtype)
        out += F.linear(F.silu(F.linear(xd, gate)) * F.linear(xd, up),
                        down).float()
    if load is not None:
        taken = counts if live is None else torch.zeros_like(
            counts).scatter_add_(0, local, live.to(torch.int64)
                                 .repeat_interleave(top_k))
        load.add_(taken[:held])
    return out.to(x.dtype)
