"""The afmoe family: Arcee's Trinity decoders (``model_type`` ``afmoe``):
sliding-window layers with rotary and full layers without, q/k head
norms, a sigmoid gate on the attention's output, sandwich norms, dense
SwiGLU layers first, then a dropless top-k of sigmoid-routed experts
beside a shared expert, the embedding scaled by sqrt(hidden); as a
configuration file's published ``config.json`` keys describe it. The
program's model is ``kubeshare_tpu_torch/models/afmoe.py``, its plain
reference ``reference/afmoe_ref.py``.

What the harness asks of a family is in ``families/dense.py``'s
docstring. This one serves only: a trainer pod (``build(...,
trainable=True)``, ``loss``, the training leaves and reference) is
refused. Beside the functions every family gives, it gives what the
expert layer's readers (``metrics/moe_*.serve.py``) read:
``expert_kernel(name)`` (whether a device operation of the trace is one
of the routed experts' grouped products) and ``expert_bound_s(spec,
tokens, shares)`` (their least time for one expert layer's call).

The program is imported only inside ``build``, so importing the family
loads nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from perfbench.lib import roofline
from perfbench.lib.weights import generator
from perfbench.reference import afmoe_ref

SLIDING, FULL = "sliding_attention", "full_attention"
# the router's selection bias, a trained buffer the configuration does
# not publish, is drawn N(0, BIAS_STD^2): a trained bias balances the
# experts' load, and a wide random one would unbalance it
BIAS_STD = 0.01
# the routed experts' grouped products, by their device kernels' names
# (torch._grouped_mm: CUTLASS's grouped GEMM over a GroupProblemShape)
EXPERT_KERNEL = "GroupProblemShape"


@dataclass(frozen=True)
class ModelSpec:
    name: str
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int                       # the dense layers' width
    moe_ff: int                   # each routed expert's width
    experts: int
    top_k: int
    shared_ff: int                # the shared expert's width
    dense_layers: int
    layer_types: Tuple[str, ...]
    window: int
    rope_theta: float
    eps: float
    route_scale: float
    route_norm: bool
    dtype: str
    max_positions: int            # the full layers' cache: the deployment's context

    @property
    def windows(self) -> Tuple[int, ...]:
        return tuple(self.window if t == SLIDING else 0
                     for t in self.layer_types)

    def routed(self, layer: int) -> bool:
        return layer >= self.dense_layers

    def layer_shapes(self, layer: int):
        """Block ``layer``'s matrices as (name, shape, fan in), in the
        order they are drawn from the layer's generator."""
        d, q = self.dim, self.heads * self.head_dim
        kv = self.kv_heads * self.head_dim
        shapes = [("wq", (q, d), d), ("wk", (kv, d), d), ("wv", (kv, d), d),
                  ("w_attn_gate", (q, d), d), ("wo", (d, q), q)]
        if not self.routed(layer):
            return shapes + [("w_gate", (self.ff, d), d),
                             ("w_up", (self.ff, d), d),
                             ("w_down", (d, self.ff), self.ff)]
        e, h, s = self.experts, self.moe_ff, self.shared_ff
        return shapes + [("experts_gate", (e, h, d), d),
                         ("experts_up", (e, h, d), d),
                         ("experts_down", (e, d, h), h),
                         ("shared_gate", (s, d), d), ("shared_up", (s, d), d),
                         ("shared_down", (d, s), s)]

    def token_params(self, layer: int) -> int:
        """Parameters of block ``layer`` that enter a product once per
        token: the attention's, and the dense MLP's or the router's,
        ``top_k`` routed experts' and the shared expert's."""
        total = 0
        for name, shape, _ in self.layer_shapes(layer):
            n = 1
            for s in shape:
                n *= s
            if name.startswith("experts_"):
                n = n // self.experts * self.top_k
            total += n
        return total + (self.experts * self.dim if self.routed(layer) else 0)


def spec(name: str, cfg: dict) -> ModelSpec:
    """A ``ModelSpec`` from a configuration file's keys; refuses what the
    family's model does not have. The layers are the first
    ``num_hidden_layers`` of ``layer_types``; the full layers' cache is
    ``max_model_len`` positions (the deployment's context limit)."""
    layers = cfg["num_hidden_layers"]
    for key, want in (("hidden_act", "silu"), ("score_func", "sigmoid"),
                      ("tie_word_embeddings", False), ("rope_scaling", None),
                      ("mup_enabled", True), ("num_expert_groups", 1),
                      ("n_group", 1), ("topk_group", 1)):
        if cfg.get(key, want) != want:
            raise ValueError(f"{name}: {key} {cfg[key]!r} is not modelled")
    types = tuple(cfg["layer_types"][:layers])
    if len(types) != layers or set(types) - {SLIDING, FULL}:
        raise ValueError(f"{name}: layer_types {types}")
    return ModelSpec(
        name=name, vocab=cfg["vocab_size"], dim=cfg["hidden_size"],
        layers=layers, heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        ff=cfg["intermediate_size"], moe_ff=cfg["moe_intermediate_size"],
        experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        shared_ff=cfg["num_shared_experts"] * cfg["moe_intermediate_size"],
        dense_layers=cfg["num_dense_layers"], layer_types=types,
        window=int(cfg["sliding_window"]),
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        route_scale=float(cfg["route_scale"]),
        route_norm=bool(cfg["route_norm"]), dtype=cfg["torch_dtype"],
        max_positions=int(cfg["max_model_len"]))


# Seeded weights of one pod, drawn on the device, each part from a
# generator of its own (as the dense family's): a block's matrices are
# one ``randn`` in the served dtype cut into N(0, 1/in) pieces, its
# router and bias one float32 ``randn`` (N(0, 1/dim), N(0, BIAS_STD^2)),
# its norm scales ones; the embedding N(0, 0.02^2), the head N(0, 1/dim).

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
    """Block ``layer``'s weights by ``models/afmoe.py``'s names."""
    shapes = spec.layer_shapes(layer)
    sizes = [torch.Size(shape).numel() for _, shape, _ in shapes]
    flat = torch.randn(sum(sizes), dtype=dtype, device=device,
                       generator=generator(device, seed, pod, "layer", layer))
    out, offset = {}, 0
    for (name, shape, fan_in), n in zip(shapes, sizes):
        out[name] = flat[offset:offset + n].view(shape).mul_(
            fan_in ** -0.5).clone()
        offset += n
    del flat
    if spec.routed(layer):
        router = torch.randn(spec.experts * (spec.dim + 1), device=device,
                             generator=generator(device, seed, pod, "router",
                                                 layer))
        out["router"] = router[:-spec.experts].view(
            spec.experts, spec.dim).mul(spec.dim ** -0.5)
        out["expert_bias"] = router[-spec.experts:].mul(BIAS_STD)
    for name in ("attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm"):
        out[name] = torch.ones(spec.dim, device=device)
    for name in ("q_norm", "k_norm"):
        out[name] = torch.ones(spec.head_dim, device=device)
    return out


def final_norm(spec: ModelSpec, device) -> torch.Tensor:
    return torch.ones(spec.dim, device=device)


def build(spec: ModelSpec, seed: int, pod: int, device, trainable: bool):
    """The program's ``Afmoe`` over the seeded weights, in the
    configuration's dtype, holding every expert."""
    from kubeshare_tpu_torch.models import afmoe

    if trainable:
        raise ValueError(f"{spec.name}: the afmoe family serves only")
    cfg = afmoe.AfmoeConfig(
        dim=spec.dim, layers=spec.layers, num_heads=spec.heads,
        num_kv_heads=spec.kv_heads, head_dim=spec.head_dim, top_k=spec.top_k,
        layer_types=spec.layer_types, window=spec.window,
        max_seq_len=spec.max_positions,
        rope_theta=spec.rope_theta, eps=spec.eps,
        route_scale=spec.route_scale, route_norm=spec.route_norm,
        dtype=spec.dtype)
    dtype = getattr(torch, spec.dtype)
    blocks = [afmoe.AfmoeBlock(**block(spec, seed, pod, i, dtype, device))
              for i in range(spec.layers)]
    return afmoe.Afmoe(cfg, embedding(spec, seed, pod, dtype, device),
                       blocks, final_norm(spec, device),
                       head(spec, seed, pod, dtype, device))


def reference_logits(spec: ModelSpec, seed: int, pod: int, sequences,
                     positions, device, quant=None) -> List[torch.Tensor]:
    """The reference's float32 logits at ``positions`` of each sequence,
    over pod ``pod``'s weights as served (drawn in the configuration's
    dtype), layer by layer."""
    dtype = getattr(torch, spec.dtype)

    def layer(i):
        return {k: v.float() for k, v in
                block(spec, seed, pod, i, dtype, device).items()}

    return afmoe_ref.logits_at(
        spec, embedding(spec, seed, pod, dtype, device).float(), layer,
        final_norm(spec, device), head(spec, seed, pod, dtype,
                                       device).float(),
        sequences, positions, quant)


def attention_flops(spec: ModelSpec, first: int, count: int) -> float:
    """Forward operations of attention for ``count`` positions starting
    at absolute position ``first`` of one sequence, every layer with its
    own window: Q K^T and P V, 2 operations each per visible (query,
    key) pair and head dim."""
    total = 0.0
    for window in spec.windows:
        keys = sum(min(p + 1, window) if window > 0 else p + 1
                   for p in range(first, first + count))
        total += 4.0 * spec.heads * spec.head_dim * keys
    return total


def forward_flops(spec: ModelSpec, first: int, count: int) -> float:
    """A forward pass's operations for ``count`` tokens of one sequence
    at positions first .. first + count - 1: 2 per token and parameter
    of the products a token enters (``top_k`` routed experts, the shared
    expert, the router, the head), and the attention over the live
    context of each layer."""
    params = sum(spec.token_params(i) for i in range(spec.layers))
    params += spec.vocab * spec.dim
    return 2.0 * params * count + attention_flops(spec, first, count)


def attention_calls(spec: ModelSpec, rows: int, seq_len: int) -> List:
    """The flash calls of one forward over ``rows`` sequences of
    ``seq_len``, one a layer at the model's head dim, each with its
    own window, as ``roofline.flash_bound_s`` takes them."""
    shape = (rows, spec.heads, spec.kv_heads, seq_len, seq_len,
             spec.head_dim)
    return [(shape, spec.dtype, True, w) for w in spec.windows]


def expert_kernel(name: str) -> bool:
    return EXPERT_KERNEL in name


def expert_work(spec: ModelSpec, tokens: int,
                shares=None) -> Tuple[float, float]:
    """(operations, bytes) of one expert layer's routed products (gate,
    up and down, grouped by expert) for ``tokens`` tokens: 2 operations
    a multiply-add of the ``top_k`` routes; each input read once and
    each output written once, in the served dtype: the weights of the
    experts the routes touch and the routed rows in and out of each
    product. ``shares``: each expert's chance to be among a token's
    ``top_k`` (summing to ``top_k``; uniform when None), from which the
    experts ``tokens`` tokens touch are expected."""
    routes = tokens * spec.top_k
    d, h, e = spec.dim, spec.moe_ff, spec.experts
    ops = 2.0 * 3 * d * h * routes
    if shares is None:
        shares = [spec.top_k / e] * e
    touched = sum(1.0 - (1.0 - min(q, 1.0)) ** tokens for q in shares)
    elem = 2 if spec.dtype in ("bfloat16", "float16") else 4
    n_bytes = elem * (3.0 * d * h * touched + routes * 3.0 * (d + h))
    return ops, n_bytes


def expert_bound_s(spec: ModelSpec, tokens: int, shares=None) -> float:
    """Least seconds of one expert layer's routed products on an H100:
    its bytes at the HBM rate against its operations at the peak rate of
    the served dtype."""
    ops, n_bytes = expert_work(spec, tokens, shares)
    return max(n_bytes / roofline.PEAK_BYTES,
               ops / roofline.PEAK_FLOPS[spec.dtype])
