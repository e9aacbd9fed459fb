"""Weights carried across from the reference.

``llama_from_jax`` is the one place that knows both layouts: the
reference's parameter tree (``init_llama`` or ``quantize_llama`` of
``kubeshare_tpu.models``, its leaves as numpy arrays) stores matmul
weights float32 [in, out] and int8 ``{"w_q": [in, out], "scale": [out]}``
pairs; the port stores [out, in] in ``cfg.dtype`` and ``Int8Weight``.
The conversion is exact: bf16 leaves (numpy ``ml_dtypes.bfloat16``) go
through float32, which holds every bf16 value.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .llama import Llama, LlamaBlock, LlamaConfig
from .quant import _LAYER_MATS, Int8Weight


def llama_from_jax(params: Mapping, cfg: LlamaConfig,
                   device: DeviceLike = None) -> Llama:
    """The port's ``Llama`` holding the reference tree's weights."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype

    def tensor(a, dtype=torch.float32):
        # torch.tensor copies: the arrays may be read-only views
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    def matrix(w):
        if isinstance(w, Mapping) and "w_q" in w:
            w_q = torch.tensor(np.asarray(w["w_q"], np.int8).T, device=device)
            return Int8Weight(w_q.contiguous(), tensor(w["scale"]))
        return tensor(np.asarray(w, np.float32).T, dtype).contiguous()

    layers = []
    for i in range(cfg.layers):
        layer = params[f"layer{i}"]
        layers.append(LlamaBlock(
            attn_norm=tensor(layer["attn_norm"]["scale"]),
            mlp_norm=tensor(layer["mlp_norm"]["scale"]),
            **{name: matrix(layer[name]) for name in _LAYER_MATS},
        ))
    return Llama(cfg, tensor(params["embed"]["table"], dtype), layers,
                 tensor(params["final_norm"]["scale"]),
                 matrix(params["lm_head"]))
