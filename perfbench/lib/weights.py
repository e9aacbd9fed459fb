"""Seeded weights of one pod, drawn on the device.

Each part of a model (the embedding, each block, the head) has a
generator of its own, seeded from the run's ``--seed``, the pod and the
part, so a part can be drawn again alone, as the reference does layer by
layer once the program's state is freed. A block is one ``randn`` call
in the dtype the weights are used in, cut into its matrices: N(0, 1/in)
for the products (nn.Linear's [out, in] layout), N(0, 0.02^2) for the
embedding, unit RMSNorm scales.

Imports only ``torch``: the reference reads these weights too.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from .spec import ModelSpec


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed for ``parts`` of a run with ``seed``."""
    key = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, *parts))
    return g


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
