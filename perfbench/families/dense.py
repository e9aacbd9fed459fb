"""The dense family: a decoder-only transformer with SwiGLU, RMSNorm,
half-split rotary embeddings, grouped-query attention and one window
for every layer (Llama, Mistral, Phi-3 without its fused projections),
as a configuration file's published ``config.json`` keys describe it.

A family is what the harness asks of an architecture (``Catalog.family``
loads it by path from ``<paths[0]>/families/<family>.py``, the name the
configuration file gives under ``"family"``):
- ``spec(name, cfg)``: a ``torch``-free description of the model;
- ``build(spec, seed, pod, device, trainable)``: the program's model
  over the benchmark's seeded weights;
- ``loss()``: the program's training loss, for ``make_train_step``;
- ``program_leaves(model)``: the program's trained leaves by the
  reference's names, and ``initial_leaves(spec, seed, pod, device)``:
  their float32 initial values, part by part;
- ``reference_logits(...)``, ``reference_training(...)``: the plain
  reference, each with the control's ``quant``;
- ``forward_flops(spec, first, count)``: a forward pass's operations,
  for the ``mfu.*`` readers;
- ``attention_calls(spec, rows, seq_len)``: the flash calls of one
  training forward, for ``flash_*_roofline``.

The program is imported only inside the functions that build or train
its model, so importing a family loads nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from perfbench.lib.weights import generator
from perfbench.reference import llama_ref


@dataclass(frozen=True)
class ModelSpec:
    name: str
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    rope_theta: float
    window: int
    eps: float
    dtype: str
    max_positions: int

    def layer_shapes(self):
        """A block's matrices as (name, out, in), in the order they are
        drawn from the layer's generator."""
        q, kv = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return (("wq", q, self.dim), ("wk", kv, self.dim),
                ("wv", kv, self.dim), ("wo", self.dim, q),
                ("w_gate", self.ff, self.dim), ("w_up", self.ff, self.dim),
                ("w_down", self.dim, self.ff))

    def matmul_params(self) -> int:
        """Parameters that enter a product once per token: every block's
        matrices and the head (the embedding is a lookup)."""
        per_layer = sum(o * i for _, o, i in self.layer_shapes())
        return self.layers * per_layer + self.vocab * self.dim


def spec(name: str, cfg: dict) -> ModelSpec:
    """A ``ModelSpec`` from a configuration file's keys; refuses what the
    family's model does not have."""
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{name}: hidden_act {cfg['hidden_act']!r}")
    if cfg.get("tie_word_embeddings", False):
        raise ValueError(f"{name}: tied embeddings are not modelled")
    dim, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim") or dim // heads
    if head_dim * heads != dim:
        raise ValueError(f"{name}: head_dim {head_dim} x {heads} heads is "
                         f"not hidden_size {dim}")
    return ModelSpec(
        name=name, vocab=cfg["vocab_size"], dim=dim,
        layers=cfg["num_hidden_layers"], heads=heads,
        kv_heads=cfg.get("num_key_value_heads") or heads, head_dim=head_dim,
        ff=cfg["intermediate_size"], rope_theta=float(cfg["rope_theta"]),
        window=int(cfg.get("sliding_window") or 0),
        eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"],
        max_positions=cfg["max_position_embeddings"])


# Seeded weights of one pod, drawn on the device. Each part (the
# embedding, each block, the head) has a generator of its own, so a part
# can be drawn again alone, as the reference does layer by layer once
# the program's state is freed. A block is one ``randn`` call in the
# dtype the weights are used in, cut into its matrices: N(0, 1/in) for
# the products (nn.Linear's [out, in] layout), N(0, 0.02^2) for the
# embedding, unit RMSNorm scales.

def embedding(spec: ModelSpec, seed: int, pod: int, dtype, device):
    table = torch.randn(spec.vocab, spec.dim, dtype=dtype, device=device,
                        generator=generator(device, seed, pod, "embed"))
    return table.mul_(0.02)


def head(spec: ModelSpec, seed: int, pod: int, dtype, device):
    w = torch.randn(spec.vocab, spec.dim, dtype=dtype, device=device,
                    generator=generator(device, seed, pod, "head"))
    return w.mul_(spec.dim ** -0.5)


def block(spec: ModelSpec, seed: int, pod: int, layer: int, dtype,
          device) -> Dict[str, torch.Tensor]:
    """Block ``layer``'s matrices {name: [out, in]} and its two norm
    scales (float32)."""
    shapes = spec.layer_shapes()
    flat = torch.randn(sum(o * i for _, o, i in shapes), dtype=dtype,
                       device=device,
                       generator=generator(device, seed, pod, "layer", layer))
    out, offset = {}, 0
    for name, rows, cols in shapes:
        out[name] = flat[offset:offset + rows * cols].view(rows, cols).mul_(
            cols ** -0.5).clone()
        offset += rows * cols
    del flat
    out["attn_norm"] = torch.ones(spec.dim, device=device)
    out["mlp_norm"] = torch.ones(spec.dim, device=device)
    return out


def final_norm(spec: ModelSpec, device) -> torch.Tensor:
    return torch.ones(spec.dim, device=device)


def build(spec: ModelSpec, seed: int, pod: int, device, trainable: bool):
    """The program's ``Llama`` over the seeded weights: float32 master
    weights for training, the configuration's dtype for serving."""
    from kubeshare_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab=spec.vocab, dim=spec.dim, layers=spec.layers,
        num_heads=spec.heads, num_kv_heads=spec.kv_heads, mlp_dim=spec.ff,
        max_seq_len=spec.max_positions, rope_theta=spec.rope_theta,
        dtype=spec.dtype, window=spec.window)
    dtype = torch.float32 if trainable else getattr(torch, spec.dtype)
    blocks = [llama.LlamaBlock(trainable=trainable,
                               **block(spec, seed, pod, i, dtype, device))
              for i in range(spec.layers)]
    return llama.Llama(cfg, embedding(spec, seed, pod, dtype, device),
                       blocks, final_norm(spec, device),
                       head(spec, seed, pod, dtype, device),
                       trainable=trainable)


def loss():
    """The program's next-token loss, ``loss(model, tokens)``."""
    from kubeshare_tpu_torch.models import llama

    return llama.llama_loss


def program_leaves(model) -> Dict[str, torch.Tensor]:
    """The program's trained leaves by the reference's names (the
    program's ``lm_head`` is the reference's ``head``)."""
    return {("head" if n == "lm_head" else n): p
            for n, p in model.named_parameters()}


def initial_leaves(spec: ModelSpec, seed: int, pod: int, device):
    """(name, tensor) of a trainer's initial float32 leaves, part by part."""
    f32 = torch.float32
    yield "embed", embedding(spec, seed, pod, f32, device)
    for i in range(spec.layers):
        for name, t in block(spec, seed, pod, i, f32, device).items():
            yield f"layers.{i}.{name}", t
    yield "final_norm", final_norm(spec, device)
    yield "head", head(spec, seed, pod, f32, device)


def reference_logits(spec: ModelSpec, seed: int, pod: int, sequences,
                     positions, device, quant=None) -> List[torch.Tensor]:
    """The reference's float32 logits at ``positions`` of each sequence,
    over pod ``pod``'s weights as served (drawn in the configuration's
    dtype), layer by layer."""
    dtype = getattr(torch, spec.dtype)

    def layer(i):
        return {k: v.float() for k, v in
                block(spec, seed, pod, i, dtype, device).items()}

    return llama_ref.logits_at(
        spec, embedding(spec, seed, pod, dtype, device).float(), layer,
        final_norm(spec, device), head(spec, seed, pod, dtype,
                                       device).float(),
        sequences, positions, quant)


# Adam over the batches, one row at a time (llama_ref.adam_train).
reference_training = llama_ref.adam_train


def attention_flops(spec: ModelSpec, first: int, count: int) -> float:
    """Forward operations of attention for ``count`` positions starting
    at absolute position ``first`` of one sequence, every layer: Q K^T
    and P V, 2 operations each per visible (query, key) pair and head
    dim."""
    keys = 0
    for p in range(first, first + count):
        keys += min(p + 1, spec.window) if spec.window > 0 else p + 1
    return 4.0 * spec.layers * spec.heads * spec.head_dim * keys


def forward_flops(spec: ModelSpec, first: int, count: int) -> float:
    """A forward pass's operations for ``count`` tokens of one sequence
    at positions first .. first + count - 1: 2 per token and parameter
    of the products, and the attention over the live context."""
    return 2.0 * spec.matmul_params() * count + attention_flops(
        spec, first, count)


def attention_calls(spec: ModelSpec, rows: int, seq_len: int) -> List:
    """The flash calls of one training forward, one a layer, each as
    ``roofline.flash_bound_s`` takes it: (shape (B, H, Hkv, Tq, Tk, D)
    at the model's own head dim, dtype, causal, window)."""
    shape = (rows, spec.heads, spec.kv_heads, seq_len, seq_len,
             spec.head_dim)
    return [(shape, spec.dtype, True, spec.window)] * spec.layers
