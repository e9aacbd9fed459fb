"""The plain reference of the dense family (``families/dense.py``): a
decoder-only transformer as its configuration file describes it, in
float32 with plain ``torch`` operations (TF32 off), one sequence at a
time, no cache, no kernels, no batching. It imports only ``torch``;
nothing of the program under test. Another family brings its own
reference beside this one; what they share (exact float32, the
control's rounding) is in ``reference/common.py``.

The block (pre-norm): RMSNorm -> q, k, v projections -> rotary
embedding (half-split, ``rope_theta``; angles in float64) ->
grouped-query attention (query head h reads kv head h // (H / Hkv)),
causal and, with ``sliding_window`` W > 0, limited to the last W
positions (key j is seen from query i when i - W < j <= i) -> output
projection -> residual; RMSNorm -> SwiGLU (silu(gate) * up -> down) ->
residual. Final RMSNorm, an untied head, softmax cross entropy for the
next-token loss. Adam as ``torch.optim.Adam`` computes it (betas 0.9 and
0.999, eps 1e-8, no weight decay).

``spec`` is the dense family's ``ModelSpec``. ``quant`` (the control): a
function applied to both operands of every product, the attention's
included, along their contraction axis; ``common.fp8`` is the float8
(e4m3) rounding with a scale per row, the precision one step below the
configurations' bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


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
    """q [H, T, D], k and v [Hkv, T, D] -> [H, T, D]."""
    groups = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(groups, dim=0)
    v = v.repeat_interleave(groups, dim=0)
    t = q.shape[1]
    scores = (_q(quant, q, -1) @ _q(quant, k, -1).transpose(-1, -2)
              ) / math.sqrt(q.shape[-1])
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    seen = j <= i
    if window > 0:
        seen &= j > i - window
    probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
    return _q(quant, probs, -1) @ _q(quant, v, -2)


def block(spec, w: Dict[str, torch.Tensor], x: torch.Tensor,
          quant: Quant = None) -> torch.Tensor:
    """One block on one sequence's hidden states x [T, dim]."""
    t = x.shape[0]
    h = rmsnorm(x, w["attn_norm"], spec.eps)
    q = linear(h, w["wq"], quant).view(t, spec.heads, -1).transpose(0, 1)
    k = linear(h, w["wk"], quant).view(t, spec.kv_heads, -1).transpose(0, 1)
    v = linear(h, w["wv"], quant).view(t, spec.kv_heads, -1).transpose(0, 1)
    positions = torch.arange(t, device=x.device)
    q, k = rope(q, positions, spec.rope_theta), rope(k, positions,
                                                     spec.rope_theta)
    out = attend(q, k, v, spec.window, quant).transpose(0, 1).reshape(t, -1)
    x = x + linear(out, w["wo"], quant)
    h = rmsnorm(x, w["mlp_norm"], spec.eps)
    gate = F.silu(linear(h, w["w_gate"], quant))
    return x + linear(gate * linear(h, w["w_up"], quant), w["w_down"], quant)


@torch.no_grad()
def logits_at(spec, embed: torch.Tensor,
              layer_weights: Callable[[int], Dict[str, torch.Tensor]],
              final_norm: torch.Tensor, head: torch.Tensor,
              sequences: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor],
              quant: Quant = None) -> List[torch.Tensor]:
    """Float32 logits [len(p), vocab] at ``positions`` p of each sequence
    (token ids [T]), layer by layer: ``layer_weights(i)`` gives block i's
    weights in float32, drawn once for all the sequences."""
    xs = [embed[s].float() for s in sequences]
    for i in range(spec.layers):
        w = layer_weights(i)
        xs = [block(spec, w, x, quant) for x in xs]
        del w
    return [linear(rmsnorm(x[p], final_norm, spec.eps), head, quant)
            for x, p in zip(xs, positions)]


def sequence_loss(spec, params: Dict[str, torch.Tensor],
                  row: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """Mean next-token loss of one row of T + 1 token ids. ``params``:
    ``embed``, ``head``, ``final_norm`` and ``layers.<i>.<name>``."""
    x = params["embed"][row[:-1]]
    for i in range(spec.layers):
        w = {name: params[f"layers.{i}.{name}"]
             for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
                          "w_gate", "w_up", "w_down")}
        x = block(spec, w, x, quant)
    logits = linear(rmsnorm(x, params["final_norm"], spec.eps),
                    params["head"], quant)
    return F.cross_entropy(logits, row[1:])


def adam_train(spec, params: Dict[str, torch.Tensor],
               batches: Sequence[torch.Tensor], lr: float,
               quant: Quant = None, rows_used: int = 0) -> Dict:
    """Adam over ``batches`` ([rows, T + 1] each), one row's forward and
    backward at a time, the gradients of the batch's mean loss summed.
    ``rows_used`` > 0 keeps only the first rows of each batch (a fault
    the check must catch). Updates ``params`` in place; returns each
    step's loss and the first step's gradient norm by leaf."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        rows = batch[:rows_used] if rows_used else batch
        grads = {n: torch.zeros_like(params[n]) for n in names}
        loss_sum = 0.0
        for row in rows:
            for p in params.values():
                p.requires_grad_(True)
            loss = sequence_loss(spec, params, row, quant) / len(rows)
            for n, g in zip(names, torch.autograd.grad(
                    loss, [params[n] for n in names])):
                grads[n] += g
            loss_sum += loss.item()
        losses.append(loss_sum)
        if step == 1:
            first_grad = {n: grads[n].norm().item() for n in names}
        with torch.no_grad():
            for n in names:
                p = params[n]
                p.requires_grad_(False)
                m[n].lerp_(grads[n], 1 - b1)
                v[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
        del grads
    return {"losses": losses, "first_grad": first_grad}
