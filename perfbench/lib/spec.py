"""A configuration file as the benchmark reads it: the published
``config.json`` keys of a decoder-only transformer with SwiGLU, RMSNorm,
half-split rotary embeddings and grouped-query attention (Llama,
Mistral, Phi-3 without its fused projections).

Only ``torch``-free Python here: the reference and the harness both
read a ``ModelSpec``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


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


def from_config(name: str, cfg: dict) -> ModelSpec:
    """A ``ModelSpec`` from a configuration file's keys; refuses what the
    benchmark's model does not have."""
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


def load(path: Path, name: str) -> ModelSpec:
    return from_config(name, json.loads(Path(path).read_text()))
