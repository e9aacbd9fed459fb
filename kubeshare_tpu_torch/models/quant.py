"""Weight-only int8 quantization for inference (port of
``kubeshare_tpu/models/quant.py``).

Symmetric per-output-channel int8: an ``Int8Weight`` holds ``w_q``
[out, in] int8 (the ``nn.Linear`` layout; the reference stores
[in, out]) and ``scale`` [out] float32. The matmul reads the int8
weight and applies the scale to the float32 accumulator (llama.py
``_matmul``). Norms and the embedding table stay unquantized.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

# every 2D matmul weight in a llama layer + the lm head
_LAYER_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Int8Weight(nn.Module):
    """A quantized [out, in] weight: int8 values and float32 scales."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)


def quantize_linear(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[out, in] float weight -> {"w_q": int8 [out, in], "scale": f32[out]}.

    ``torch.round`` rounds half to even like ``jnp.round``, so ``w_q``
    equals the reference's (transposed) bit for bit."""
    if w.dim() != 2:
        raise ValueError(f"expected a 2D weight, got shape {tuple(w.shape)}")
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return {"w_q": w_q.to(torch.int8), "scale": scale}


def dequantize_linear(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Materialize the float32 [out, in] weight (tests/debug only)."""
    return q["w_q"].float() * q["scale"][:, None]


def is_quantized(w) -> bool:
    return isinstance(w, Int8Weight)


def _quantized(w: torch.Tensor) -> Int8Weight:
    return Int8Weight(**quantize_linear(w))


def quantize_llama(model):
    """A ``Llama`` whose matmul weights (every layer matrix and the lm
    head) are int8. The embedding and norms are shared with ``model``,
    which is left unchanged."""
    from .llama import Llama, LlamaBlock

    layers = [
        LlamaBlock(
            attn_norm=layer.attn_norm, mlp_norm=layer.mlp_norm,
            **{name: _quantized(getattr(layer, name)) for name in _LAYER_MATS},
        )
        for layer in model.layers
    ]
    return Llama(model.cfg, model.embed, layers, model.final_norm,
                 _quantized(model.lm_head))


def param_bytes(model: nn.Module) -> int:
    """Total bytes at rest of a (possibly quantized) model."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)
