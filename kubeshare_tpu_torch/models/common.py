"""Shared layer primitives (port of ``kubeshare_tpu/models/common.py``).

Only what the Llama path uses so far: RMSNorm and the embedding. Norm
scales stay float32; the normalisation runs in float32 and the scale is
applied before the cast back to the input dtype, as in the reference.
"""

from __future__ import annotations

import torch

from ..utils.device import DeviceLike, resolve_device


def rmsnorm_init(dim: int, device: DeviceLike = None) -> torch.Tensor:
    return torch.ones(dim, dtype=torch.float32, device=resolve_device(device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


def embed_init(vocab: int, dim: int, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 0.02^2) table drawn in float32 on the generator's device."""
    table = torch.randn(vocab, dim, generator=generator,
                        device=generator.device, dtype=torch.float32)
    return (table * 0.02).to(dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return table.to(dtype)[ids]
