"""Llama-style decoder transformer, inference and training (port of
``kubeshare_tpu/models/llama.py``).

RMSNorm, rotary embeddings, SwiGLU MLP, grouped-query attention. The
model is an ``nn.Module`` (``Llama`` of ``LlamaBlock``s) whose matmul
weights are stored in the ``nn.Linear`` layout [out, in]. An inference
model stores them in ``cfg.dtype`` with no gradient; the reference keeps
float32 [in, out] and casts on every call, which gives the same
operands (an 8B model is 16 GB, not 32). A trainable model
(``trainable=True``) keeps the reference's float32 master weights, with
gradients, and casts them to ``cfg.dtype`` inside every product. Norm
scales stay float32. Full-sequence attention goes through
``ops.attention.mha``, which sends it to the CUDA flash kernels (forward
and, under autograd, backward).

The KV-cache path (``llama_apply_cached`` and friends) is plain torch,
as the reference's is plain jnp. Unlike the reference it updates the
cache IN PLACE: the k/v buffers and the length tensor of the cache
passed in are written, and the same dict comes back. A cache must not
be reused after it has been passed. Stores and masks use device index
tensors, so a decode step does not wait on the device and can be
captured as a CUDA graph.

Training: ``llama_loss`` (dense, or vocab-chunked through
``ops.xent.chunked_linear_xent``) with ``remat`` per block; the
optimizer step is ``models/train.py``. ``attn_fn`` swaps the attention
core, and ``make_llama_sp_loss`` runs the trunk sequence-parallel
through it (``parallel/``). ``llama_pipeline_hidden`` runs the blocks as
a pipeline over the ``pp`` ranks (``parallel/pipeline.py``).

Tensor parallelism and fully sharded weights: a model placed by
``parallel.shard_params`` holds only this rank's block of each weight
and records the layout in ``model.shards`` (``parallel.sharding.
LlamaShards``; None for a whole model, where every path below is the
one-process path, tensor for tensor). Its blocks then run the heads and
hidden units this tp rank holds (the head counts come from the weights'
shapes), with Megatron's ``copy_to`` before each column-parallel pair
and ``reduce_from`` after each row-parallel product; the embedding is a
masked lookup of the rank's vocabulary rows, summed over tp; the loss is
the vocab-parallel cross-entropy (its row max and sum of exponentials
reduced over tp, the target logit taken from the rank that owns it),
dense or through the chunked loss. Weights split over fsdp are gathered
around each product (``parallel/fsdp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import _NEG_INF, matmul_f32, mha
from ..ops.xent import chunked_linear_xent
from ..utils.device import DeviceLike, resolve_device
from .common import (
    cross_entropy_loss, embed_init, init_generator, rmsnorm, rmsnorm_init,
)
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

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def windows(self) -> Tuple[int, ...]:
        """Each layer's window (0: full causal): the one ``window``."""
        return (self.window,) * self.layers


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


def _weight(w, trainable: bool = False):
    return w if isinstance(w, Int8Weight) else nn.Parameter(
        w, requires_grad=trainable)


class LlamaBlock(nn.Module):
    """One pre-norm transformer block's weights; ``llama_block`` runs it.
    ``trainable`` gives every weight a gradient."""

    def __init__(self, attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up,
                 w_down, trainable: bool = False):
        super().__init__()
        self.attn_norm = _weight(attn_norm, trainable)
        self.mlp_norm = _weight(mlp_norm, trainable)
        self.wq, self.wk, self.wv, self.wo = (
            _weight(w, trainable) for w in (wq, wk, wv, wo))
        self.w_gate, self.w_up, self.w_down = (
            _weight(w, trainable) for w in (w_gate, w_up, w_down))


class Llama(nn.Module):
    """The whole model: embedding table [vocab, dim], the blocks, the
    final norm and the lm head [vocab, dim]."""

    def __init__(self, cfg: LlamaConfig, embed: torch.Tensor,
                 layers: Sequence[LlamaBlock], final_norm: torch.Tensor,
                 lm_head, trainable: bool = False):
        super().__init__()
        if len(layers) != cfg.layers:
            raise ValueError(f"{len(layers)} blocks for a {cfg.layers}-layer "
                             "config")
        self.cfg = cfg
        self.embed = _weight(embed, trainable)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _weight(final_norm, trainable)
        self.lm_head = _weight(lm_head, trainable)
        # the layout on a rank mesh (parallel.shard_params); None: whole
        self.shards = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, positions=None, use_flash=None):
        return llama_apply(self, tokens, positions, use_flash)

    def apply_cached(self, tokens, cache, live=None):
        """``llama_apply_cached``: the serving entry ``DecodeServer`` and
        ``prefill_slot`` call on any decoder (``live``, the rows a model
        with experts counts, is not read: a Llama counts nothing)."""
        return llama_apply_cached(self, tokens, cache)


def _linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                 dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(out_dim, in_dim, generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * in_dim ** -0.5).to(dtype)


def init_llama(cfg: LlamaConfig = LlamaConfig(),
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None, trainable: bool = False) -> Llama:
    """Random weights from ``generator`` (default: seed 0 on ``device``),
    drawn on the device itself: N(0, 1/in) matmul weights, N(0, 0.02^2)
    embedding, unit norms. ``trainable=True`` keeps every weight in
    float32 with a gradient (the training master copy); otherwise they
    are stored in ``cfg.dtype`` for inference."""
    device = resolve_device(device)
    generator = init_generator(generator, device)
    dtype = torch.float32 if trainable else cfg.torch_dtype
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
            trainable=trainable,
        ))
    return Llama(cfg, embed, layers, rmsnorm_init(cfg.dim, device),
                 _linear_init(generator, cfg.dim, cfg.vocab, dtype),
                 trainable=trainable)


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


def _project(shards, name: str, x: torch.Tensor, w,
             dtype: torch.dtype) -> torch.Tensor:
    """``_matmul`` of leaf ``name``, gathered around the product when
    the layout splits it over fsdp."""
    if shards is not None and name in shards.fsdp_dims:
        return shards.project(name, x, w, dtype)
    return _matmul(x, w, dtype)


def _whole(shards, name: str, w: torch.Tensor) -> torch.Tensor:
    return w if shards is None else shards.whole(name, w)


def llama_block(layer: LlamaBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: LlamaConfig, use_flash: Optional[bool] = None,
                attn_fn: Optional[Callable] = None,
                shards=None) -> torch.Tensor:
    """One pre-norm transformer block: [B, T, dim] -> [B, T, dim].

    ``attn_fn`` overrides the causal attention core: a callable
    ``(q [B,H,T,D], k, v [B,Hkv,T,D]) -> [B,H,T,D]`` with causality and
    the window baked in, which carries the window it bakes as
    ``.window``: the hook the sequence-parallel trunks use to swap in
    ring or Ulysses attention (``make_llama_sp_loss``). A window that
    disagrees with ``cfg.window`` either way is refused. ``shards`` is
    the model's layout on a rank mesh (module docstring); ``layer`` may
    be any object with the block's weights as attributes."""
    dtype = cfg.torch_dtype
    batch, seq = x.shape[0], x.shape[1]
    hd = cfg.dim // cfg.num_heads
    h = rmsnorm(_whole(shards, "attn_norm", layer.attn_norm), x)
    if shards is not None:
        h = shards.enter(h)
    # this rank's heads: all of them unless tp splits them
    q = _project(shards, "wq", h, layer.wq, dtype).view(batch, seq, -1, hd)
    k = _project(shards, "wk", h, layer.wk, dtype).view(batch, seq, -1, hd)
    v = _project(shards, "wv", h, layer.wv, dtype).view(batch, seq, -1, hd)
    q = _rope(q.transpose(1, 2), positions, cfg.rope_theta)   # [B, H, T, D]
    k = _rope(k.transpose(1, 2), positions, cfg.rope_theta)
    v = v.transpose(1, 2).contiguous()
    if attn_fn is not None:
        if getattr(attn_fn, "window", 0) != cfg.window:
            raise ValueError(
                f"cfg.window={cfg.window} but attn_fn bakes window="
                f"{getattr(attn_fn, 'window', 0)}: build the SP core "
                "with the model's window (make_llama_sp_loss does)"
            )
        out = attn_fn(q, k, v)
    else:
        out = mha(q, k, v, causal=True, use_flash=use_flash,
                  window=cfg.window)
    out = out.transpose(1, 2).reshape(batch, seq, -1)
    out = _project(shards, "wo", out, layer.wo, dtype)
    x = x + (out if shards is None else shards.leave(out))

    h = rmsnorm(_whole(shards, "mlp_norm", layer.mlp_norm), x)
    if shards is not None:
        h = shards.enter(h)
    gate = F.silu(_project(shards, "w_gate", h, layer.w_gate, dtype))
    up = _project(shards, "w_up", h, layer.w_up, dtype)
    out = _project(shards, "w_down", gate * up, layer.w_down, dtype)
    return x + (out if shards is None else shards.leave(out))


def _embed(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings [B, T, dim] in cfg.dtype; under tp a masked
    lookup of this rank's vocabulary rows, summed over the tp ranks."""
    shards = model.shards
    table = _whole(shards, "embed", model.embed).to(model.cfg.torch_dtype)
    if shards is None or shards.tp == 1:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - shards.tp_rank * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    return shards.leave(torch.where(mine[..., None], x, 0.0))


def llama_hidden(model: Llama, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 use_flash: Optional[bool] = None,
                 remat: bool = False,
                 attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """The trunk: tokens [B, T] -> final-norm hidden [B, T, dim].

    ``remat=True`` checkpoints each block: the backward recomputes the
    block's forward instead of keeping its activations (the flash
    forward then runs twice per block and step). The gradients are the
    same bits either way. The reference keeps each block's matmul
    outputs (``dots_with_no_batch_dims_saveable``); here the whole block
    is recomputed. ``attn_fn`` as in ``llama_block``."""
    cfg, shards = model.cfg, model.shards
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(model, tokens)
    for layer in model.layers:
        if remat:
            x = checkpoint(llama_block, layer, x, positions, cfg, use_flash,
                           attn_fn, shards, use_reentrant=False)
        else:
            x = llama_block(layer, x, positions, cfg, use_flash, attn_fn,
                            shards)
    return rmsnorm(_whole(shards, "final_norm", model.final_norm), x)


def llama_apply(model: Llama, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                use_flash: Optional[bool] = None,
                remat: bool = False,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """tokens [B, T] -> float32 logits [B, T, vocab] (the lm head's
    output in cfg.dtype, then cast); under tp each rank's vocabulary
    slice, gathered."""
    x = llama_hidden(model, tokens, positions, use_flash, remat, attn_fn)
    logits = _local_logits(model, x)
    shards = model.shards
    if shards is not None and shards.tp > 1:
        from ..parallel import comm

        logits = comm.all_gather_cat(logits, shards.tp_group, dim=-1)
    return logits


def _local_logits(model: Llama, hidden: torch.Tensor) -> torch.Tensor:
    """Float32 logits of this rank's vocabulary rows (all of them
    without tp)."""
    shards = model.shards
    if shards is not None:
        hidden = shards.enter(hidden)
    return _project(shards, "lm_head", hidden, model.lm_head,
                    model.cfg.torch_dtype).float()


def _vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                         shards) -> torch.Tensor:
    """Mean cross entropy of float32 logits [N, V / tp] holding this tp
    rank's vocabulary slice: the row max and the sum of exponentials
    reduced over tp, the label's logit from the rank that owns it. The
    max only shifts the exponentials (no gradient); the sums leave the
    tp region (``reduce_from``), since every rank computes the same
    loss from them."""
    from ..parallel import comm

    rows = logits.shape[-1]
    m = comm.all_reduce_(logits.detach().amax(dim=-1), shards.tp_group,
                         op="max")
    s = shards.leave(torch.exp(logits - m[:, None]).sum(dim=-1))
    local = labels - shards.tp_rank * rows
    mine = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[:, None])[:, 0]
    gold = shards.leave(torch.where(mine, gold, 0.0))
    return torch.mean(torch.log(s) + m - gold)


def _next_token_loss(model: Llama, inputs: torch.Tensor,
                     targets: torch.Tensor, positions, vocab_chunk: int,
                     remat: bool, use_flash: Optional[bool],
                     attn_fn: Optional[Callable]) -> torch.Tensor:
    """Mean next-token loss of ``inputs`` [B, T] against ``targets``."""
    if is_quantized(model.lm_head):
        raise ValueError(
            "quantized weights are inference-only (models/quant.py): int8 "
            "weights cannot be trained; keep the float model for llama_loss"
        )
    shards = model.shards
    tp = shards is not None and shards.tp > 1
    hidden = llama_hidden(model, inputs, positions, use_flash, remat,
                          attn_fn)
    n = hidden.shape[0] * hidden.shape[1]
    if vocab_chunk > 0:
        dtype = model.cfg.torch_dtype
        head = _whole(shards, "lm_head", model.lm_head)
        if shards is not None:
            hidden = shards.enter(hidden)
        return chunked_linear_xent(
            hidden.reshape(n, -1).to(dtype),
            head.to(dtype).t(),                     # [dim, vocab (/ tp)]
            targets.reshape(n),
            vocab_chunk,
            group=shards.tp_group if tp else None,
            vocab_start=shards.tp_rank * head.shape[0] if tp else 0,
        )
    logits = _local_logits(model, hidden)
    if tp:
        return _vocab_parallel_xent(logits.reshape(n, -1),
                                    targets.reshape(n), shards)
    return cross_entropy_loss(logits, targets)


# a block's weights, in LlamaBlock's order
LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                "w_up", "w_down")


def llama_stack_layers(model: Llama) -> Dict[str, torch.Tensor]:
    """The trunk's per-layer weights stacked into pipeline stages
    (leaves [layers, ...]). Do this ONCE at setup and keep this rank's
    block (``parallel.shard_stacked_params``): stacking inside the step
    would copy every trunk weight on every call."""
    from ..parallel.pipeline import stack_stage_params

    return stack_stage_params([{name: getattr(layer, name)
                                for name in LAYER_LEAVES}
                               for layer in model.layers])


def llama_pipeline_hidden(model: Llama, tokens: torch.Tensor, mesh,
                          num_microbatches: int,
                          use_flash: Optional[bool] = None,
                          stacked_layers=None,
                          remat: bool = True) -> torch.Tensor:
    """The trunk with its blocks run as a pipeline over the mesh's
    ``pp`` ranks (``parallel/pipeline.py``): the layers are the stages
    (``cfg.layers`` may exceed the pp size: each rank then chains a
    contiguous block of layers), microbatched over the batch dim. The
    embedding and the final norm run on every rank, outside the
    pipeline. Same math as ``llama_hidden`` (``llama_block`` is shared).
    The reference's ``(params, tokens, cfg, mesh, ...)`` is ``(model,
    tokens, mesh, ...)`` here: the model carries its config.

    Pass ``stacked_layers`` (``llama_stack_layers`` at setup, placed with
    ``shard_stacked_params``) in training loops; None stacks the model's
    layers on every call."""
    from ..parallel.pipeline import pipeline_apply

    if model.shards is not None:
        raise ValueError("the pipeline runs whole layers, not a model "
                         "placed over tp or fsdp")
    cfg = model.cfg
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.embed.to(cfg.torch_dtype)[tokens]
    if stacked_layers is None:
        stacked_layers = llama_stack_layers(model)

    def stage(layer, xb):
        return llama_block(SimpleNamespace(**layer), xb, positions, cfg,
                           use_flash)

    x = pipeline_apply(stage, stacked_layers, x, num_microbatches, mesh,
                       remat=remat)
    return rmsnorm(model.final_norm, x)


def llama_loss(model: Llama, tokens: torch.Tensor, vocab_chunk: int = 0,
               remat: bool = False,
               use_flash: Optional[bool] = None,
               attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token LM loss on a [B, T] batch: the trunk sees
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``.

    ``vocab_chunk > 0`` goes through the chunked linear cross-entropy
    (``ops/xent.py``): the [B, T, vocab] logits are never held, and its
    tile products run in ``cfg.dtype`` like the dense path's lm head.
    ``remat`` checkpoints each block (``llama_hidden``); ``use_flash``
    as in ``mha``; ``attn_fn`` as in ``llama_block``."""
    return _next_token_loss(model, tokens[:, :-1], tokens[:, 1:], None,
                            vocab_chunk, remat, use_flash, attn_fn)


def make_llama_sp_loss(cfg: LlamaConfig, mesh, axis_name: str = "sp",
                       impl: str = "ring", use_flash: Optional[bool] = None,
                       vocab_chunk: int = 0, remat: bool = False
                       ) -> Callable:
    """Sequence-parallel training loss ``(model, tokens) -> scalar`` over
    the ``axis_name`` group of ``mesh`` (``parallel.make_mesh``), with
    the attention core run as ring (K/V hops) or Ulysses (all-to-all
    head scatter) attention.

    ``tokens`` is the [B, n * T_local + 1] batch (every rank of the
    group passes the same one). Rank r of the group trains on its shard
    ``tokens[:, :-1][:, r*T_local:(r+1)*T_local]`` against the same
    columns of ``tokens[:, 1:]``, at RoPE positions
    ``r * T_local + arange(T_local)``, and returns its partial sum of
    the token losses over the GLOBAL token count B * n * T_local: a SUM
    all-reduce over the group gives ``llama_loss``'s mean, and summed
    gradients give its gradients (``parallel.make_sharded_train_step``
    sums them). ``use_flash=None`` is ``mha``'s rule: the kernels on
    the card, the plain version on the CPU. Ring + flash + window is
    refused when the core is built."""
    if impl == "ring":
        from ..parallel.ring_attention import make_ring_attention

        attn = make_ring_attention(mesh, axis_name, causal=True,
                                   use_flash=use_flash, window=cfg.window)
    elif impl == "ulysses":
        from ..parallel.ulysses import make_ulysses_attention

        attn = make_ulysses_attention(mesh, axis_name, causal=True,
                                      use_flash=use_flash,
                                      window=cfg.window)
    else:
        raise ValueError(f"impl must be 'ring' or 'ulysses', got {impl!r}")
    n = mesh.shape[axis_name]
    rank = mesh.coords[axis_name]

    def loss(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("the model's config is not the loss's")
        t = tokens.shape[1] - 1
        if t % n:
            raise ValueError(f"{t} training positions do not split over "
                             f"{n} ranks (feed n * T_local + 1 tokens)")
        t_local = t // n
        lo = rank * t_local
        positions = torch.arange(lo, lo + t_local, device=tokens.device)
        mean = _next_token_loss(
            model, tokens[:, lo:lo + t_local],
            tokens[:, lo + 1:lo + t_local + 1], positions, vocab_chunk,
            remat, None, attn)
        return mean / n

    return loss


# ---- KV-cache inference -------------------------------------------------
#
# Cache: per layer a [B, KvH, S, head_dim] k/v buffer (``cache["k"][i]``),
# plus a length (a scalar, or one per batch row for continuous
# batching). A layer with a window keeps a rolling ring of
# S = min(window, max_seq_len) slots, position p in slot p % S; a full
# layer keeps S = max_seq_len slots, each position at its absolute
# index. Every layer of a Llama has the one window, so its layers share
# one cache kind and one stacked [layers, B, KvH, S, head_dim] buffer;
# a model whose layers differ (``models/afmoe.py``) keeps one stacked
# buffer a kind and hands each layer a view of its own.


def layer_slots(cfg) -> Tuple[int, ...]:
    """Each layer's cache size, from its window (``cfg.windows``)."""
    return tuple(min(w, cfg.max_seq_len) if w > 0 else cfg.max_seq_len
                 for w in cfg.windows)


def cache_slots(cfg) -> int:
    """The smallest layer cache (a Llama's ring: full history, or the
    window for SWA models): the most positions one prefill may write."""
    return min(layer_slots(cfg))


def init_kv_cache(cfg, batch: int, dtype=None,
                  per_slot: bool = False,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``per_slot=True`` gives each batch row its own length: the
    continuous-batching layout of ``DecodeServer``. Lengths are int64
    (torch's index dtype). One cache kind (every layer the same size)
    is one stacked buffer each of k and v; several are a list of
    per-layer views, one stacked buffer a kind beneath."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    slots = layer_slots(cfg)

    def buffer(layers: int, size: int) -> torch.Tensor:
        return torch.zeros((layers, batch, cfg.num_kv_heads, size,
                            cfg.head_dim), dtype=dtype, device=device)

    if len(set(slots)) == 1:
        k, v = buffer(len(slots), slots[0]), buffer(len(slots), slots[0])
    else:
        kinds = {size: (buffer(slots.count(size), size),
                        buffer(slots.count(size), size))
                 for size in sorted(set(slots))}
        k, v = [], []
        for i, size in enumerate(slots):
            j = slots[:i].count(size)
            k.append(kinds[size][0][j])
            v.append(kinds[size][1][j])
    return {
        "k": k,
        "v": v,
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


def cache_positions(start: torch.Tensor, seq: int) -> torch.Tensor:
    """The positions of ``seq`` new tokens after the cache's length:
    [B, seq] after per-slot lengths [B], [seq] after a scalar one."""
    steps = torch.arange(seq, device=start.device)
    return start[:, None] + steps if start.dim() == 1 else start + steps


def write_index(positions: torch.Tensor, slots: int,
                absolute: bool = False) -> torch.Tensor:
    """The slots of an ``slots``-slot layer cache that ``positions`` are
    written to: position p in slot p % slots (a ring), or in slot p
    (``absolute``: a multi-token prefill into a full-history cache, which
    fails past the end where a ring would wrap). Per-slot positions
    [B, 1] give one slot a row."""
    if positions.dim() == 2:
        return torch.remainder(positions[:, 0], slots)
    return positions if absolute else torch.remainder(positions, slots)


def store(buf: torch.Tensor, new: torch.Tensor, write_idx: torch.Tensor,
          rows: Optional[torch.Tensor] = None) -> None:
    """Write new k or v [B, KvH, T, hd] into ``buf`` [B, KvH, S, hd], a
    view into the cache, in place: at slots ``write_idx``, or, for a
    per-slot cache (T == 1, ``rows`` = arange(B)), at the (row, slot)
    pairs."""
    new = new.to(buf.dtype)
    if rows is not None:
        # the indexed dim comes first, as in the reference's
        # buf.at[arange(B), :, write_idx, :]
        buf[rows, :, write_idx, :] = new[:, :, 0, :]
    else:
        buf.index_copy_(2, write_idx, new)


def llama_apply_cached(
    model: Llama, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run [B, T] new tokens against the KV cache and write them into it.

    T == prompt length for prefill, T == 1 for decode; returns (float32
    logits [B, T, vocab], cache). The cache is updated IN PLACE and
    returned: its k/v buffers and its ``length`` tensor are the same
    tensors after the call, so a decode step captures as a CUDA graph
    (``models/graph.py``). Writes are ring writes (slot = position % S), except a
    multi-token prefill into a full-history cache, which writes at the
    absolute positions and raises (CPU) or fails a device assert (CUDA)
    past the end, where the reference would clamp."""
    cfg = model.cfg
    if model.shards is not None:
        raise ValueError("the KV-cache path runs a whole model, not one "
                         "placed on a rank mesh")
    dtype = cfg.torch_dtype
    batch, seq = tokens.shape
    hd = cfg.dim // cfg.num_heads
    slots = cache["k"][0].shape[2]
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
    full_history = slots == cfg.max_seq_len
    positions = cache_positions(start, seq)
    write_idx = write_index(positions, slots, full_history and seq > 1)
    rows = torch.arange(batch, device=tokens.device) if per_slot else None

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
            store(k_cache, k, write_idx, rows)
            store(v_cache, v, write_idx, rows)
            out = _attend_ring(q, k_cache, v_cache, start + seq,
                               cfg.num_heads, cfg.num_kv_heads, cfg.window)
        else:
            # wrapping-capable prefill chunk: attend over [old ring ; own
            # k/v] BEFORE storing
            out = _attend_cached(q, k_cache, v_cache, k, v, start,
                                 cfg.num_heads, cfg.num_kv_heads, cfg.window)
            store(k_cache, k, write_idx, rows)
            store(v_cache, v, write_idx, rows)
        out = out.to(dtype).transpose(1, 2).reshape(
            batch, seq, cfg.num_heads * hd)
        x = x + _matmul(out, layer.wo, dtype)

        h = rmsnorm(layer.mlp_norm, x)
        gate = F.silu(_matmul(h, layer.w_gate, dtype))
        up = _matmul(h, layer.w_up, dtype)
        x = x + _matmul(gate * up, layer.w_down, dtype)
    x = rmsnorm(model.final_norm, x)
    logits = _matmul(x, model.lm_head, dtype).float()
    # in place, so that a CUDA graph of this call replays on the same
    # tensor; ``positions`` and ``write_idx`` were taken from ``start``
    # (the same tensor) above, before this add
    start.add_(seq)
    return logits, cache


def prefill_slot(model, tokens: torch.Tensor,
                 cache: Dict[str, torch.Tensor], slot: int,
                 live: Optional[torch.Tensor] = None):
    """Admit one sequence into batch row ``slot`` of a per-slot cache:
    prefill its prompt ([1, T] tokens; pad to a bucket) through the
    model's scalar-cache path (``model.apply_cached``) on a view of that
    row, every layer's, from length 0, then set the row's length.
    Returns (prompt logits [1, T, vocab], cache); under padding the
    caller samples at its TRUE last position; ``live`` [1, T] (bool)
    marks the prompt's tokens, for the model's own counts. Other rows are
    untouched."""
    if tokens.shape[0] != 1:
        raise ValueError("prefill_slot admits one sequence at a time")
    row = {
        "k": [k[slot:slot + 1] for k in cache["k"]],
        "v": [v[slot:slot + 1] for v in cache["v"]],
        "length": torch.zeros((), dtype=torch.int64, device=tokens.device),
    }
    logits, row = model.apply_cached(tokens, row, live)
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
    ``generator``, so they differ from the reference's jax.random.

    The draw is ``torch.multinomial``'s own one-sample method, argmax of
    p / q with q ~ Exp(1), written out: the same numbers from the same
    generator, without ``multinomial``'s host-side checks, which wait
    for the device and so cannot be captured in a CUDA graph."""
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
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1)


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
