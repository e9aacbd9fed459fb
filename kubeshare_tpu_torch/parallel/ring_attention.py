"""Ring attention: sequence-parallel exact attention over the ``sp`` axis
(port of ``kubeshare_tpu/parallel/ring_attention.py``).

Q/K/V are sharded along the sequence across the sp ranks; each rank
keeps its Q shard and takes the other ranks' K/V shards in hop order
(hop i is rank ``my - i``'s shard, as the reference's ring brings
them), merging each hop's normalised ``(out_h, lse_h)`` pair with
max-shifted float32 accumulators, so the result is exact. The dense hop
holds one ``T/n x T/n`` float32 score tile and repeats GQA heads inside
the hop; the flash hop runs the CUDA flash kernels
(``ops.attention.flash_attention_with_lse``): causal on the diagonal
hop, full for an earlier shard, and nothing for a later one. The merge
sends each flash hop's lse cotangent into the backward kernels.

Differences from the reference:
- The K/V shards are not rotated hop by hop: one ``comm.all_gather`` of
  the small ``[B, Hkv, T/n, D]`` tensors (K and V together) brings every
  shard at once, and its backward, one reduce-scatter, returns each
  shard's gradient to its owner. The reference's ``ppermute`` ring
  overlaps each hop's transfer with the previous hop's block on the
  interconnect; ranks that share a card through host staging gain
  nothing from that overlap and pay a drained, staged call per hop, so
  the port makes one call a layer each way. Every rank holds all n
  shards during the layer.
- A rank's index is a Python int, so a hop that is fully masked (a later
  shard under causality, or one entirely outside the window) does no
  work at all instead of contributing ``lse = -inf`` rows.
- The flash hop takes any ``T/n`` (the kernels mask ragged tiles); the
  reference's ``T_local % 128`` refusal is gone.
- The callable runs on this rank's shards, with the batch already split
  over dp by the caller (the train step), where the reference's
  ``shard_map`` takes full arrays; so it takes no ``batch_axis``, and
  the scale is always ``head_dim ** -0.5``, the only one the model uses.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from ..ops.attention import _repeat_kv, flash_attention_with_lse, matmul_f32
from . import comm
from .mesh import Mesh

_NEG_INF = -1e30

_WINDOW_REFUSAL = ("ring window support is dense+causal only (flash hop "
                   "bodies lack a query-offset input)")


def _merge(hops: Iterable[Tuple[torch.Tensor, torch.Tensor]],
           like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge normalised ``(out_h [B,H,T,D], lse_h [B,H,T,1])`` pairs in
    order with max-shifted float32 accumulators; rows with
    ``lse_h = -inf`` weigh exactly 0. The first pair must give every row
    a finite lse (the diagonal hop does). Returns the merged out (like's
    dtype) and lse (float32)."""
    batch, heads, t_local, head_dim = like.shape
    acc = torch.zeros(batch, heads, t_local, head_dim, dtype=torch.float32,
                      device=like.device)
    m_run = torch.full((batch, heads, t_local, 1), float("-inf"),
                       dtype=torch.float32, device=like.device)
    l_run = torch.zeros_like(m_run)
    for out_h, lse_h in hops:
        m_new = torch.maximum(m_run, lse_h)
        corr = torch.exp(m_run - m_new)
        w_h = torch.exp(lse_h - m_new)
        acc = acc * corr + out_h.float() * w_h
        l_run = l_run * corr + w_h
        m_run = m_new
    l_run = l_run.clamp_min(1e-30)
    return (acc / l_run).to(like.dtype), m_run + torch.log(l_run)


def _dense_hop(q32: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               my_idx: int, kv_idx: int, causal: bool, window: int):
    """One hop in float32 with the mask over GLOBAL positions. Rows with
    no visible key here get ``lse = -inf`` (their out is garbage that
    the merge weighs by 0)."""
    t_local = q32.shape[2]
    k, v = _repeat_kv(k, v, q32.shape[1])
    scores = matmul_f32(q32, k.float().transpose(-1, -2))
    if causal:
        pos = torch.arange(t_local, device=q32.device)
        gq = (my_idx * t_local + pos)[:, None]
        gk = (kv_idx * t_local + pos)[None, :]
        mask = gk <= gq
        if window > 0:
            mask &= gk > gq - window
        scores = torch.where(mask, scores, _NEG_INF)
    m_h = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m_h)
    l_h = p.sum(dim=-1, keepdim=True)
    out_h = matmul_f32(p, v.float()) / l_h.clamp_min(1e-30)
    lse_h = torch.where(m_h <= _NEG_INF / 2, float("-inf"),
                        m_h + torch.log(l_h.clamp_min(1e-30)))
    return out_h, lse_h


def _visible(my_idx: int, kv_idx: int, t_local: int, causal: bool,
             window: int) -> bool:
    """Whether any query of shard ``my_idx`` sees a key of shard
    ``kv_idx``."""
    if not causal:
        return True
    if kv_idx > my_idx:
        return False
    # the newest key of the shard against the oldest query's band
    return window <= 0 or kv_idx * t_local + t_local - 1 > (
        my_idx * t_local - window)


def ring_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group: comm.Group,
                            causal: bool = True,
                            use_flash: Optional[bool] = None,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's shards: q [B, H, T_local, D], k/v [B, Hkv, T_local, D]
    (GQA when Hkv < H: the gather carries the small tensors and the
    dense hop repeats them). Returns the output shard and its rows'
    log-sum-exp over every visible key [B, H, T_local, 1] (float32).
    ``use_flash=None`` is ``mha``'s rule: the kernels for CUDA tensors,
    the dense hop for CPU tensors, and the dense hop under a window,
    the one route that takes it; ``use_flash=True`` on CPU tensors runs
    the kernels' plain versions. ``window > 0`` is sliding-window
    banding over global positions, dense and causal only."""
    if use_flash is None:
        use_flash = q.is_cuda and window == 0
    if window > 0 and (use_flash or not causal):
        raise ValueError(_WINDOW_REFUSAL)
    t_local = q.shape[2]
    scale = q.shape[-1] ** -0.5
    n = comm.group_size(group)
    my_idx = comm.group_rank(group)
    kv = comm.all_gather(torch.stack([k, v]), group)  # [n, 2, B, Hkv, T, D]
    q32 = None if use_flash else q.float() * scale

    def hops():
        for i in range(n):
            kv_idx = (my_idx - i) % n
            if not _visible(my_idx, kv_idx, t_local, causal, window):
                continue
            k_cur, v_cur = kv[kv_idx, 0], kv[kv_idx, 1]
            if use_flash:
                yield flash_attention_with_lse(
                    q, k_cur, v_cur, causal and kv_idx == my_idx, scale)
            else:
                yield _dense_hop(q32, k_cur, v_cur, my_idx, kv_idx, causal,
                                 window)

    return _merge(hops(), q)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: comm.Group, causal: bool = True,
                   use_flash: Optional[bool] = None,
                   window: int = 0) -> torch.Tensor:
    """``ring_attention_with_lse``'s output shard alone."""
    return ring_attention_with_lse(q, k, v, group, causal, use_flash,
                                   window)[0]


def make_ring_attention(mesh: Mesh, axis_name: str = "sp",
                        causal: bool = True,
                        use_flash: Optional[bool] = None,
                        window: int = 0) -> Callable:
    """Ring attention over the ``axis_name`` group of ``mesh``:
    ``(q, k, v) -> out`` on this rank's shards, which carries ``.window``
    (``llama_block`` checks it). Ring + flash + window is refused here,
    at build time."""
    if window > 0 and (use_flash or not causal):
        raise ValueError(_WINDOW_REFUSAL)
    group = mesh.group(axis_name)

    def sharded(q, k, v):
        return ring_attention(q, k, v, group, causal=causal,
                              use_flash=use_flash, window=window)

    sharded.window = window
    return sharded
