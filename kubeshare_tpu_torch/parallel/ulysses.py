"""Ulysses all-to-all sequence parallelism over the ``sp`` axis (port of
``kubeshare_tpu/parallel/ulysses.py``).

The other long-context strategy beside the ring: an all-to-all
re-shards this rank's ``[B, H, T/n, D]`` q, k and v into
``[B, H/n, T, D]`` (the full sequence for a slice of heads), attention
runs locally, dense or through the flash kernels at full T, and a second
all-to-all restores sequence sharding on the output. Exact. Needs
``H % n == 0``; GQA k/v go as they are when ``Hkv % n == 0`` (q's head
slice i then lands on kv slice i) and are repeated to H heads before
the split otherwise.

Difference from the reference: q, k and v go in ONE all-to-all (their
head slices side by side), where the reference makes three; the
callable runs on this rank's shards, as ``ring_attention``'s does, so
it takes no ``batch_axis``, and its scale is ``head_dim ** -0.5``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.attention import _NEG_INF, _repeat_kv, flash_attention, matmul_f32
from . import comm
from .mesh import Mesh


def _dense_attention(q, k, v, causal: bool, scale: float,
                     window: int = 0) -> torch.Tensor:
    """float32 softmax attention on full-sequence shards (k, v already
    at q's head count)."""
    scores = matmul_f32(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        t = q.shape[2]
        kj = torch.arange(t, device=q.device)[None, :]
        qi = torch.arange(t, device=q.device)[:, None]
        mask = kj <= qi
        if window > 0:
            mask &= kj > qi - window
        scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return matmul_f32(p, v.float()).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: comm.Group, causal: bool = True,
                      use_flash: Optional[bool] = None,
                      window: int = 0) -> torch.Tensor:
    """This rank's shards: q [B, H, T_local, D], k/v [B, Hkv, T_local, D].
    ``use_flash=None`` is ``mha``'s rule (the kernels for CUDA tensors);
    ``window > 0`` is sliding-window banding (causal only), taken by
    both cores."""
    if window > 0 and not causal:
        raise ValueError("window requires causal attention")
    if use_flash is None:
        use_flash = q.is_cuda
    batch, heads, t_local, head_dim = q.shape
    n = comm.group_size(group)
    if heads % n:
        raise ValueError(f"{heads} heads do not split over {n} ranks")
    scale = head_dim ** -0.5
    if k.shape[1] % n:
        k, v = _repeat_kv(k, v, heads)
    kv_heads = k.shape[1]

    def by_rank(x):   # [B, h, T/n, D] -> [B, n, h/n, T/n, D]
        return x.reshape(batch, n, x.shape[1] // n, t_local, head_dim)

    # [B, n, (H + 2 Hkv)/n, T/n, D] -> [B, 1, (H + 2 Hkv)/n, T, D]
    qkv = comm.all_to_all(torch.cat([by_rank(q), by_rank(k), by_rank(v)],
                                    dim=2), group, split_dim=1, concat_dim=3)
    qh, kh, vh = torch.split(qkv[:, 0], [heads // n, kv_heads // n,
                                         kv_heads // n], dim=1)
    if use_flash:
        out = flash_attention(qh.contiguous(), kh.contiguous(),
                              vh.contiguous(), causal, scale, window)
    else:
        kh, vh = _repeat_kv(kh, vh, qh.shape[1])
        out = _dense_attention(qh, kh, vh, causal, scale, window)
    # [B, H/n, T, D] -> [B, H, T/n, D]
    return comm.all_to_all(out, group, split_dim=2, concat_dim=1)


def make_ulysses_attention(mesh: Mesh, axis_name: str = "sp",
                           causal: bool = True,
                           use_flash: Optional[bool] = None,
                           window: int = 0) -> Callable:
    """Ulysses attention over the ``axis_name`` group of ``mesh``, on
    this rank's shards; carries ``.window`` (see
    ``make_ring_attention``)."""
    if window > 0 and not causal:
        raise ValueError("window requires causal attention")
    group = mesh.group(axis_name)

    def sharded(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal,
                                 use_flash=use_flash, window=window)

    sharded.window = window
    return sharded
