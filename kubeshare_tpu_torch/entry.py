"""The flagship forward (counterpart of ``__graft_entry__.entry()``).

    from kubeshare_tpu_torch.entry import entry
    forward, (model, tokens) = entry()     # on cuda; entry("cpu") on a CPU
    logits = forward(model, tokens)         # [2, 128, 2048] float32

The reference's own small Llama (vocab 2048, dim 256, 4 layers, 8 heads
and 4 kv heads: head dim 32; mlp 512, max_seq_len 512, bf16) with random
weights from seed 0, and its example batch, zeros [2, 128]. ``forward``
is ``llama_apply``: on the card each layer's attention runs the flash
forward kernel once (``ops/attention.py::mha``). The reference returns a
jittable function and its parameter tree; here the model is an
``nn.Module`` and PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .models.llama import Llama, LlamaConfig, init_llama, llama_apply
from .utils.device import DeviceLike, resolve_device

# __graft_entry__.py's config
ENTRY_CONFIG = LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                           num_kv_heads=4, mlp_dim=512, max_seq_len=512)
ENTRY_TOKENS = (2, 128)


def entry(device: DeviceLike = None) -> Tuple[Callable, Tuple[Llama,
                                                              torch.Tensor]]:
    """``(llama_apply, (model, tokens))`` on ``device`` (default: the
    first CUDA device; no CUDA device raises unless ``device="cpu"``)."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    model = init_llama(ENTRY_CONFIG, generator=generator, device=device)
    tokens = torch.zeros(ENTRY_TOKENS, dtype=torch.long, device=device)
    return llama_apply, (model, tokens)
