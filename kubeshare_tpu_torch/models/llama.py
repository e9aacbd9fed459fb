"""Llama-style decoder transformer, inference (port of
``kubeshare_tpu/models/llama.py``).

RMSNorm, rotary embeddings, SwiGLU MLP, grouped-query attention. The
model is an ``nn.Module`` (``Llama`` of ``LlamaBlock``s) whose matmul
weights are stored in ``cfg.dtype`` in the ``nn.Linear`` layout
[out, in]; the reference keeps float32 [in, out] and casts on every
call, which gives the same operands (an 8B model is 16 GB, not 32).
Norm scales stay float32. Full-sequence attention goes through
``ops.attention.mha``, which sends it to the CUDA flash kernel.

The KV-cache path (``llama_apply_cached`` and friends) is plain torch,
as the reference's is plain jnp. Unlike the reference it updates the
cache IN PLACE: the k/v buffers of the cache passed in are written and
the same dict comes back with its new length. A cache must not be
reused after it has been passed. Stores and masks use device index
tensors, so a decode step does not wait on the device.

Training (``llama_loss``, the sequence-parallel and pipeline trunks) is
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import _NEG_INF, matmul_f32, mha
from ..utils.device import DeviceLike, resolve_device
from .common import embed_init, rmsnorm, rmsnorm_init
from .quant import Int8Weight, is_quantized


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 256
    layers: int = 2
    num_heads: int = 8
    num_kv_heads: int = 4
    mlp_dim: int = 688           # ~8/3 * dim rounded
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    # > 0 = sliding-window attention: each position sees only the last
    # ``window`` positions; the KV cache is then a rolling ring of
    # ``window`` slots (init_kv_cache)
    window: int = 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(
        vocab=128256, dim=4096, layers=32, num_heads=32, num_kv_heads=8,
        mlp_dim=14336, max_seq_len=8192,
    )


def llama_param_count(cfg: LlamaConfig) -> int:
    """Analytic parameter count for a config, without allocating it."""
    hd = cfg.dim // cfg.num_heads
    per_layer = (
        2 * cfg.dim                               # attn + mlp rmsnorm
        + cfg.dim * cfg.num_heads * hd            # wq
        + 2 * cfg.dim * cfg.num_kv_heads * hd     # wk, wv
        + cfg.num_heads * hd * cfg.dim            # wo
        + 3 * cfg.dim * cfg.mlp_dim               # w_gate, w_up, w_down
    )
    return (
        cfg.vocab * cfg.dim                       # embed
        + cfg.layers * per_layer
        + cfg.dim                                 # final norm
        + cfg.dim * cfg.vocab                     # lm_head
    )


def _weight(w):
    return w if isinstance(w, Int8Weight) else nn.Parameter(
        w, requires_grad=False)


class LlamaBlock(nn.Module):
    """One pre-norm transformer block's weights; ``llama_block`` runs it."""

    def __init__(self, attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up,
                 w_down):
        super().__init__()
        self.attn_norm = nn.Parameter(attn_norm, requires_grad=False)
        self.mlp_norm = nn.Parameter(mlp_norm, requires_grad=False)
        self.wq, self.wk, self.wv, self.wo = map(_weight, (wq, wk, wv, wo))
        self.w_gate, self.w_up, self.w_down = map(
            _weight, (w_gate, w_up, w_down))


class Llama(nn.Module):
    """The whole model: embedding table [vocab, dim], the blocks, the
    final norm and the lm head [vocab, dim]."""

    def __init__(self, cfg: LlamaConfig, embed: torch.Tensor,
                 layers: Sequence[LlamaBlock], final_norm: torch.Tensor,
                 lm_head):
        super().__init__()
        if len(layers) != cfg.layers:
            raise ValueError(f"{len(layers)} blocks for a {cfg.layers}-layer "
                             "config")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = _weight(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, positions=None, use_flash=None):
        return llama_apply(self, tokens, positions, use_flash)


def _linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                 dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(out_dim, in_dim, generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * in_dim ** -0.5).to(dtype)


def init_llama(cfg: LlamaConfig = LlamaConfig(),
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Llama:
    """Random weights from ``generator`` (default: seed 0 on ``device``),
    drawn on the device itself: N(0, 1/in) matmul weights, N(0, 0.02^2)
    embedding, unit norms."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    elif torch.device(generator.device) != device:
        raise ValueError(f"generator is on {generator.device}, the model on "
                         f"{device}")
    dtype = cfg.torch_dtype
    hd = cfg.dim // cfg.num_heads
    embed = embed_init(cfg.vocab, cfg.dim, generator, dtype)
    layers = []
    for _ in range(cfg.layers):
        layers.append(LlamaBlock(
            attn_norm=rmsnorm_init(cfg.dim, device),
            wq=_linear_init(generator, cfg.dim, cfg.num_heads * hd, dtype),
            wk=_linear_init(generator, cfg.dim, cfg.num_kv_heads * hd, dtype),
            wv=_linear_init(generator, cfg.dim, cfg.num_kv_heads * hd, dtype),
            wo=_linear_init(generator, cfg.num_heads * hd, cfg.dim, dtype),
            mlp_norm=rmsnorm_init(cfg.dim, device),
            w_gate=_linear_init(generator, cfg.dim, cfg.mlp_dim, dtype),
            w_up=_linear_init(generator, cfg.dim, cfg.mlp_dim, dtype),
            w_down=_linear_init(generator, cfg.mlp_dim, cfg.dim, dtype),
        ))
    return Llama(cfg, embed, layers, rmsnorm_init(cfg.dim, device),
                 _linear_init(generator, cfg.dim, cfg.vocab, dtype))


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved). x [B, H, T, D];
    positions [T], or [B, T] when sequences sit at different absolute
    positions (per-slot serving). float32 math."""
    head_dim = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device)
        / head_dim))
    angles = positions.float()[..., None] * freqs   # [..., T, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.dim() == 2:
        cos, sin = cos[:, None], sin[:, None]      # [B, 1, T, D/2]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` for a [out, in] weight: operands in ``dtype``, float32
    accumulation, output in ``dtype``. An int8 weight enters the
    product exactly (float32 operands) and its per-output-channel scale
    multiplies the float32 accumulator, as in the reference."""
    if is_quantized(w):
        y = F.linear(x.to(dtype).float(), w.w_q.float())
        return (y * w.scale).to(dtype)
    return F.linear(x.to(dtype), w.to(dtype))


def llama_block(layer: LlamaBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: LlamaConfig,
                use_flash: Optional[bool] = None) -> torch.Tensor:
    """One pre-norm transformer block: [B, T, dim] -> [B, T, dim]."""
    dtype = cfg.torch_dtype
    batch, seq = x.shape[0], x.shape[1]
    hd = cfg.dim // cfg.num_heads
    h = rmsnorm(layer.attn_norm, x)
    q = _matmul(h, layer.wq, dtype).view(batch, seq, cfg.num_heads, hd)
    k = _matmul(h, layer.wk, dtype).view(batch, seq, cfg.num_kv_heads, hd)
    v = _matmul(h, layer.wv, dtype).view(batch, seq, cfg.num_kv_heads, hd)
    q = _rope(q.transpose(1, 2), positions, cfg.rope_theta)   # [B, H, T, D]
    k = _rope(k.transpose(1, 2), positions, cfg.rope_theta)
    v = v.transpose(1, 2).contiguous()
    out = mha(q, k, v, causal=True, use_flash=use_flash, window=cfg.window)
    out = out.transpose(1, 2).reshape(batch, seq, cfg.num_heads * hd)
    x = x + _matmul(out, layer.wo, dtype)

    h = rmsnorm(layer.mlp_norm, x)
    gate = F.silu(_matmul(h, layer.w_gate, dtype))
    up = _matmul(h, layer.w_up, dtype)
    return x + _matmul(gate * up, layer.w_down, dtype)


def llama_hidden(model: Llama, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 use_flash: Optional[bool] = None) -> torch.Tensor:
    """The trunk: tokens [B, T] -> final-norm hidden [B, T, dim]."""
    cfg = model.cfg
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.embed.to(cfg.torch_dtype)[tokens]
    for layer in model.layers:
        x = llama_block(layer, x, positions, cfg, use_flash)
    return rmsnorm(model.final_norm, x)


def llama_apply(model: Llama, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                use_flash: Optional[bool] = None) -> torch.Tensor:
    """tokens [B, T] -> float32 logits [B, T, vocab] (the lm head's
    output in cfg.dtype, then cast)."""
    x = llama_hidden(model, tokens, positions, use_flash)
    return _matmul(x, model.lm_head, model.cfg.torch_dtype).float()


# ---- KV-cache inference -------------------------------------------------
#
# Cache: [layers, B, KvH, S, head_dim] k/v buffers plus a length (a
# scalar, or one per batch row for continuous batching). For full-causal
# models S = max_seq_len and positions write at their absolute index;
# for sliding-window models the cache is a rolling ring of
# S = min(window, max_seq_len) slots and position p lives in slot p % S.


def cache_slots(cfg: LlamaConfig) -> int:
    """Ring size: full history, or the window for SWA models."""
    if cfg.window > 0:
        return min(cfg.window, cfg.max_seq_len)
    return cfg.max_seq_len


def init_kv_cache(cfg: LlamaConfig, batch: int, dtype=None,
                  per_slot: bool = False,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``per_slot=True`` gives each batch row its own length: the
    continuous-batching layout of ``DecodeServer``. Lengths are int64
    (torch's index dtype)."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    hd = cfg.dim // cfg.num_heads
    shape = (cfg.layers, batch, cfg.num_kv_heads, cache_slots(cfg), hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,) if per_slot else (),
                              dtype=torch.int64, device=device),
    }


def _ring_positions(length: torch.Tensor, slots: int) -> torch.Tensor:
    """Absolute position held by each ring slot once ``length``
    positions have been written: the newest p = i (mod slots) with
    p < length; untouched slots come out negative. ``length`` scalar
    -> [S]; [B] -> [B, S]. Floor-mod of negative numbers is what makes
    untouched slots negative: ``torch.remainder``, never ``fmod``."""
    i = torch.arange(slots, device=length.device)
    if length.dim() == 1:
        length = length[:, None]
    return (length - 1) - torch.remainder(length - 1 - i, slots)


def _masked_attend(qg, k_all, v_all, p, q_abs, window: int):
    """Grouped-query attention over position-tagged K/V: visible is
    ``0 <= p <= q_abs`` and, with ``window > 0``, ``p > q_abs - window``.
    qg [B, KvH, G, Tq, D]; k_all/v_all [B, KvH, S, D]; p [S] (or [B, S]);
    q_abs [Tq] (or [B, Tq]). Returns [B, KvH, G, Tq, D] in v's dtype.
    Scores are float32 and divided by sqrt(D) (``attention`` multiplies
    by D**-0.5 instead: each keeps the reference's form)."""
    batch, kv_heads, groups, t_q, hd = qg.shape
    slots = k_all.shape[2]
    scores = matmul_f32(
        qg.reshape(batch, kv_heads, groups * t_q, hd),
        k_all.to(qg.dtype).transpose(-1, -2),
    ).view(batch, kv_heads, groups, t_q, slots) / (hd ** 0.5)
    p = p[:, None, None, None, :] if p.dim() == 2 else p
    q_abs = (q_abs[:, None, None, :, None] if q_abs.dim() == 2
             else q_abs[:, None])
    mask = (p >= 0) & (p <= q_abs)
    if window > 0:
        mask &= p > q_abs - window
    weights = torch.softmax(torch.where(mask, scores, _NEG_INF), dim=-1)
    out = torch.matmul(
        weights.to(v_all.dtype).view(batch, kv_heads, groups * t_q, slots),
        v_all,
    )
    return out.view(batch, kv_heads, groups, t_q, hd)


def _attend_cached(q, k_ring, v_ring, k_new, v_new, length_before,
                   num_heads, num_kv_heads, window: int = 0):
    """q [B, H, Tq, D] against [old ring cache ; current chunk]: the
    chunk's K/V ride alongside the ring, not through it, so a wrapping
    prefill cannot evict in-band keys its own earlier queries need."""
    groups = num_heads // num_kv_heads
    batch, _, t_q, hd = q.shape
    qg = q.reshape(batch, num_kv_heads, groups, t_q, hd)
    k_all = torch.cat([k_ring.to(q.dtype), k_new.to(q.dtype)], dim=2)
    v_all = torch.cat([v_ring, v_new.to(v_ring.dtype)], dim=2)
    chunk = length_before + torch.arange(t_q, device=q.device)
    p = torch.cat([_ring_positions(length_before, k_ring.shape[2]), chunk])
    out = _masked_attend(qg, k_all, v_all, p, chunk, window)
    return out.reshape(batch, num_heads, t_q, hd)


def _attend_ring(q, k_ring, v_ring, length_after, num_heads,
                 num_kv_heads, window: int = 0):
    """Decode hot path: the new positions are already stored, so attend
    over the ring alone (no cache-sized concat per layer per token)."""
    groups = num_heads // num_kv_heads
    batch, _, t_q, hd = q.shape
    qg = q.reshape(batch, num_kv_heads, groups, t_q, hd)
    p = _ring_positions(length_after, k_ring.shape[2])
    steps = torch.arange(t_q, device=q.device)
    if length_after.dim() == 1:   # per-slot lengths -> [B, Tq] query abs
        q_abs = length_after[:, None] - t_q + steps
    else:
        q_abs = length_after - t_q + steps
    out = _masked_attend(qg, k_ring, v_ring, p, q_abs, window)
    return out.reshape(batch, num_heads, t_q, hd)


def llama_apply_cached(
    model: Llama, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run [B, T] new tokens against the KV cache and write them into it.

    T == prompt length for prefill, T == 1 for decode; returns (float32
    logits [B, T, vocab], cache). The cache is updated IN PLACE and
    returned. Writes are ring writes (slot = position % S), except a
    multi-token prefill into a full-history cache, which writes at the
    absolute positions and raises (CPU) or fails a device assert (CUDA)
    past the end, where the reference would clamp."""
    cfg = model.cfg
    dtype = cfg.torch_dtype
    batch, seq = tokens.shape
    hd = cfg.dim // cfg.num_heads
    slots = cache["k"].shape[3]
    if seq > slots:
        raise ValueError(
            f"cannot write {seq} positions into a {slots}-slot cache "
            "in one call (chunk the prefill to the window size)"
        )
    start = cache["length"]
    per_slot = start.dim() == 1
    if per_slot and seq != 1:
        raise ValueError(
            "per-slot cache accepts seq == 1 only; admit prompts via "
            "prefill_slot"
        )
    steps = torch.arange(seq, device=tokens.device)
    full_history = slots == cfg.max_seq_len
    if per_slot:
        positions = start[:, None] + steps               # [B, 1]
        write_idx = torch.remainder(positions[:, 0], slots)
        rows = torch.arange(batch, device=tokens.device)
    else:
        positions = start + steps
        write_idx = (positions if full_history and seq > 1
                     else torch.remainder(positions, slots))

    def _store(buf, new):
        # buf [B, KvH, S, hd] is a view into the cache: written in place
        new = new.to(buf.dtype)
        if per_slot:
            # (row, slot) index pairs; the indexed dim comes first, as
            # in the reference's buf.at[arange(B), :, write_idx, :]
            buf[rows, :, write_idx, :] = new[:, :, 0, :]
        else:
            buf.index_copy_(2, write_idx, new)

    x = model.embed.to(dtype)[tokens]
    for i, layer in enumerate(model.layers):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rmsnorm(layer.attn_norm, x)
        q = _matmul(h, layer.wq, dtype).view(batch, seq, cfg.num_heads, hd)
        k = _matmul(h, layer.wk, dtype).view(batch, seq, cfg.num_kv_heads, hd)
        v = _matmul(h, layer.wv, dtype).view(batch, seq, cfg.num_kv_heads, hd)
        q = _rope(q.transpose(1, 2), positions, cfg.rope_theta)
        k = _rope(k.transpose(1, 2), positions, cfg.rope_theta)
        v = v.transpose(1, 2)
        if seq == 1 or full_history:
            # store first, attend over the ring alone: the write cannot
            # evict in-band keys (decode's one evicted slot is out of the
            # band; a full-history cache never evicts)
            _store(k_cache, k)
            _store(v_cache, v)
            out = _attend_ring(q, k_cache, v_cache, start + seq,
                               cfg.num_heads, cfg.num_kv_heads, cfg.window)
        else:
            # wrapping-capable prefill chunk: attend over [old ring ; own
            # k/v] BEFORE storing
            out = _attend_cached(q, k_cache, v_cache, k, v, start,
                                 cfg.num_heads, cfg.num_kv_heads, cfg.window)
            _store(k_cache, k)
            _store(v_cache, v)
        out = out.to(dtype).transpose(1, 2).reshape(
            batch, seq, cfg.num_heads * hd)
        x = x + _matmul(out, layer.wo, dtype)

        h = rmsnorm(layer.mlp_norm, x)
        gate = F.silu(_matmul(h, layer.w_gate, dtype))
        up = _matmul(h, layer.w_up, dtype)
        x = x + _matmul(gate * up, layer.w_down, dtype)
    x = rmsnorm(model.final_norm, x)
    logits = _matmul(x, model.lm_head, dtype).float()
    cache["length"] = start + seq
    return logits, cache


def prefill_slot(model: Llama, tokens: torch.Tensor,
                 cache: Dict[str, torch.Tensor], slot: int):
    """Admit one sequence into batch row ``slot`` of a per-slot cache:
    prefill its prompt ([1, T] tokens; pad to a bucket) through the
    scalar-cache path on a view of that row, then set the row's length.
    Returns (prompt logits [1, T, vocab], cache); under padding the
    caller samples at its TRUE last position. Other rows are untouched."""
    if tokens.shape[0] != 1:
        raise ValueError("prefill_slot admits one sequence at a time")
    row = {
        "k": cache["k"][:, slot:slot + 1],
        "v": cache["v"][:, slot:slot + 1],
        "length": torch.zeros((), dtype=torch.int64, device=tokens.device),
    }
    logits, row = llama_apply_cached(model, tokens, row)
    cache["length"][slot] = row["length"]
    return logits, cache


def retire_slot(cache: Dict[str, torch.Tensor], slot: int):
    """Free batch row ``slot``: length 0 re-masks every ring position
    (p < 0 in _ring_positions), so stale keys can never leak into a
    later tenant's attention; no buffer zeroing needed."""
    cache["length"][slot] = 0
    return cache


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """One sampling decision over [B, vocab] logits. temperature <= 0 =
    greedy (first index on ties, like jnp.argmax); ``top_k > 0``
    restricts the draw to the k highest logits. Draws come from
    ``generator``, so they differ from the reference's jax.random."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if top_k < 0 or top_k > logits.shape[-1]:
        raise ValueError(
            f"top_k={top_k} out of range for vocab {logits.shape[-1]}"
        )
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def llama_generate(model: Llama, prompt: torch.Tensor, steps: int,
                   temperature: float = 0.0, top_k: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Decode ``steps`` tokens after a [B, T] prompt. Greedy by default;
    ``temperature > 0`` samples (optionally top-k) from ``generator``
    (default: seed 0 on the prompt's device)."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    if prompt_len + steps > cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + steps {steps} exceeds max_seq_len "
            f"{cfg.max_seq_len}"
        )
    if steps <= 0:
        return torch.zeros((batch, 0), dtype=prompt.dtype,
                           device=prompt.device)
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    cache = init_kv_cache(cfg, batch, device=prompt.device)
    # prompts longer than the rolling ring prefill in ring-sized chunks
    slots = cache_slots(cfg)
    for lo in range(0, prompt_len, slots):
        logits, cache = llama_apply_cached(model, prompt[:, lo:lo + slots],
                                           cache)
    token = _sample_token(logits[:, -1], generator, temperature,
                          top_k).to(prompt.dtype)
    out = [token]
    for _ in range(steps - 1):
        logits, cache = llama_apply_cached(model, token[:, None], cache)
        token = _sample_token(logits[:, -1], generator, temperature,
                              top_k).to(prompt.dtype)
        out.append(token)
    return torch.stack(out, dim=1)
