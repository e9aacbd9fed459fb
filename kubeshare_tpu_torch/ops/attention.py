"""Attention: the plain version and the flash-attention kernels (port of
``kubeshare_tpu/ops/attention.py``).

``attention`` is the plain O(T^2)-memory version and runs anywhere.
``flash_attention`` / ``flash_attention_with_lse`` run hand-written CUDA
kernels on CUDA tensors: the forward ``csrc/flash_fwd.cu`` (the port of
the Pallas ``_flash_kernel``) and, under autograd, the backward
``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``). On CPU tensors they run the kernels' plain
PyTorch versions, ``flash_attention_reference`` and
``flash_backward_reference``. For a CUDA tensor a wrapper launches its
kernel or raises; nothing falls back.

Shapes as in the reference: q [B, H, Tq, D], k/v [B, Hkv, Tk, D] with H
a multiple of Hkv (grouped-query attention). The kernels read each kv
head once for its H/Hkv query heads; K/V are never repeated.

Head dims: the kernels are built for D in ``FLASH_HEAD_DIMS``; any other
D up to 128 runs them at the next of those, with q, k, v (and, in the
backward, out and dO) zero-padded on the last axis and the results
sliced back (``padded_forward``, ``padded_backward``). The scale stays
1/sqrt(D) of the true D. A CUDA tensor with D > 128 raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Head dims the CUDA kernels are compiled for (a template argument of
# csrc/flash_*.cu; 32 is the reference's own Llama entry and workload
# CLI, 16 its dry run's bf16 Llama). Any other head dim up to the last
# runs the kernels of the next one up on zero-padded inputs; above it a
# CUDA tensor raises: nothing falls back to plain attention.
FLASH_HEAD_DIMS = (16, 32, 64, 128)
# The key-tile width of the float32 kernels (BK in csrc/flash_common.cuh).
# The plain versions walk the same tiles, so the float32 forward's
# online-softmax rescaling happens at the same places; the bf16 forward
# rescales every FLASH_FWD_BLOCK_K keys, which moves where P is rounded to
# bf16 but not the function.
FLASH_BLOCK_K = 64
# The bf16 forward kernel's tiles (FWD_BM, FWD_BN in csrc/flash_fwd.cu):
# query rows per block (two warpgroups of 64) and keys per K/V tile.
FLASH_FWD_BLOCK_Q = 128
FLASH_FWD_BLOCK_K = 128
# The bf16 backward kernels' tiles (csrc/flash_bwd.cu). dq takes the
# forward's items of FLASH_FWD_BLOCK_Q rows with K/V tiles of
# FLASH_DQ_BLOCK_K keys (DQ_BN); dk/dv items of FLASH_DKV_BLOCK_K keys
# (DKV_BN) with q tiles of FLASH_DKV_BLOCK_Q rows (DKV_BM).
FLASH_DQ_BLOCK_K = 64
FLASH_DKV_BLOCK_K = 128
FLASH_DKV_BLOCK_Q = 64

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _repeat_kv(k, v, num_heads: int):
    h_kv = k.shape[1]
    if h_kv != num_heads:
        reps = num_heads // h_kv
        k = torch.repeat_interleave(k, reps, dim=1)
        v = torch.repeat_interleave(v, reps, dim=1)
    return k, v


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over equal batch dims, accumulated and returned in
    float32 whatever the operand dtype: the reference's
    ``preferred_element_type=jnp.float32``. The operands are not
    rounded further; a bf16 product of two bf16 values is exact in
    float32. Under autograd the operands are cast to float32 first
    (``bmm`` with ``out_dtype`` has no derivative), which gives the same
    sums."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda and not (torch.is_grad_enabled()
                          and (a.requires_grad or b.requires_grad)):
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*batch, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
              window: int = 0):
    """Plain attention. q [B,H,Tq,D], k/v [B,Hkv,Tk,D] -> [B,H,Tq,D].

    ``window > 0`` adds sliding-window masking on top of causal: query
    i sees keys j with ``i - window < j <= i`` (requires causal)."""
    *_, num_heads, t_q, head_dim = q.shape
    if window > 0 and not causal:
        raise ValueError("window requires causal attention")
    k, v = _repeat_kv(k, v, num_heads)
    t_k = k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    scores = matmul_f32(q, k.transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        visible = k_pos <= q_pos
        if window > 0:
            visible &= k_pos > q_pos - window
        scores = torch.where(visible, scores, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights.to(v.dtype), v).to(q.dtype)


def _check_flash_args(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes 4-D q, k, v")
    batch, heads, t_q, head_dim = q.shape
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != head_dim:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if heads % k.shape[1]:
        raise ValueError(f"{heads} heads is not a multiple of "
                         f"{k.shape[1]} kv heads")
    if window > 0 and not causal:
        raise ValueError("window requires causal attention")
    if causal and t_q > k.shape[2]:
        raise ValueError(f"causal attention needs Tq <= Tk, got {t_q} > "
                         f"{k.shape[2]}")


def _key_range(q_first: int, q_last: int, t_k: int, causal: bool,
               window: int) -> Tuple[int, int]:
    """Keys [lo, hi) that any query at absolute positions
    q_first..q_last can see: the loop bounds that keep dead tiles
    (above the diagonal, below the window band) from ever loading."""
    lo, hi = 0, t_k
    if causal:
        hi = min(t_k, q_last + 1)
        if window > 0:
            lo = max(0, q_first - window + 1)
    return lo, hi


def _snake(items, sms: int):
    """Deal ``items`` (a list, longest first) over ``min(len, sms)``
    blocks in a snake: round r gives block b item ``r*G + b`` (r even) or
    ``r*G + G - 1 - b`` (r odd). Each block takes its items in list
    order, so any two blocks' work stays within one item of even."""
    grid = min(len(items), sms)
    blocks = [[] for _ in range(grid)]
    for r in range(-(-len(items) // grid) if grid else 0):
        for b in range(grid):
            i = r * grid + (grid - 1 - b if r % 2 else b)
            if i < len(items):
                blocks[b].append(items[i])
    return blocks


def flash_forward_schedule(batch_heads: int, t_q: int, t_k: int,
                           causal: bool = True, window: int = 0,
                           sms: int = 132,
                           block_k: int = FLASH_FWD_BLOCK_K):
    """The work of the bf16 forward kernel (and, with ``block_k`` =
    FLASH_DQ_BLOCK_K, of the bf16 dq kernel), block by block: one list of
    ``(bh, q0, lo, hi)`` items per block of its persistent grid
    (``min(items, sms)`` blocks, one per SM), in the order the block takes
    them. The items, (head, q tile of FLASH_FWD_BLOCK_Q rows) pairs, are
    sorted longest first (item i is q tile ``n_qt - 1 - i // (B*H)`` of
    head ``i % (B*H)``) and dealt in a snake (``_snake``). Each item loads
    key tiles of ``block_k`` from ``lo`` (aligned) to ``hi``. The kernel
    walks exactly this (``flash_work`` encodes it)."""
    bq = FLASH_FWD_BLOCK_Q
    n_qt = -(-t_q // bq)
    offset = t_k - t_q if causal else 0
    items = []
    for i in range(n_qt * batch_heads):
        bh, q0 = i % batch_heads, (n_qt - 1 - i // batch_heads) * bq
        lo, hi = _key_range(q0 + offset, min(q0 + bq, t_q) - 1 + offset,
                            t_k, causal, window)
        items.append((bh, q0, lo - lo % block_k, hi))
    return _snake(items, sms)


def _row_range(k_first: int, k_last: int, t_q: int, t_k: int, causal: bool,
               window: int) -> Tuple[int, int]:
    """Query rows [lo, hi) that can see any key at positions
    k_first..k_last: the dk/dv loop bounds (rows outside them give
    P = 0)."""
    lo, hi = 0, t_q
    if causal:
        offset = t_k - t_q
        lo = max(0, k_first - offset)
        if window > 0:
            hi = min(t_q, k_last + window - offset)
    return lo, hi


def flash_backward_schedule(batch_kv_heads: int, reps: int, t_q: int,
                            t_k: int, causal: bool = True, window: int = 0,
                            sms: int = 132):
    """The bf16 dk/dv kernel's work, block by block: one list of
    ``(bkv, k0, r, lo, hi)`` items per block of its persistent grid, in
    the order the block takes them. An item is key tile k0 (of
    FLASH_DKV_BLOCK_K keys) of kv head ``bkv`` with query head ``r`` of
    its group of ``reps``, and the query rows [lo, hi) that can see the
    tile (lo aligned to FLASH_DKV_BLOCK_Q; ``lo == hi`` when none can:
    the item then writes zeros). Items are sorted longest first (most q
    tiles), ties by (tile, kv head, r), so item (tile, r) always precedes
    (tile, r + 1), which waits for it to add its part of the group's sum;
    they are dealt in a snake (``_snake``)."""
    bq, bk = FLASH_DKV_BLOCK_Q, FLASH_DKV_BLOCK_K
    keyed = []
    for kt in range(-(-t_k // bk)):
        k0 = kt * bk
        lo, hi = _row_range(k0, min(k0 + bk, t_k) - 1, t_q, t_k, causal,
                            window)
        lo, hi = (lo - lo % bq, hi) if hi > lo else (0, 0)
        n = -(-(hi - lo) // bq)
        for bkv in range(batch_kv_heads):
            for r in range(reps):
                keyed.append(((-n, kt, bkv, r), (bkv, k0, r, lo, hi)))
    keyed.sort()
    return _snake([item for _, item in keyed], sms)


def flash_work(blocks):
    """A schedule (``flash_forward_schedule``, ``flash_backward_schedule``)
    as the flat int list a bf16 kernel takes (``QItem``, ``KvItem`` in
    ``csrc/flash_*.cu``): G + 1 offsets, block b taking items
    ``offsets[b]`` to ``offsets[b + 1] - 1``, then each item's ints, block
    after block."""
    offsets = [0]
    for block in blocks:
        offsets.append(offsets[-1] + len(block))
    return offsets + [x for block in blocks for item in block for x in item]


def _work_on(device: torch.device, blocks):
    """``(work list on device, blocks)``: the list built on the host and
    copied to the card."""
    work = torch.tensor(flash_work(blocks), dtype=torch.int32, device=device)
    # a copy from pageable memory may still be in flight when tensor()
    # returns: finish it before any stream reads the list
    torch.cuda.synchronize(device)
    return work, len(blocks)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _forward_work_on(device: torch.device, batch_heads: int, t_q: int,
                     t_k: int, causal: bool, window: int,
                     block_k: int = FLASH_FWD_BLOCK_K):
    """The forward's (or, with ``block_k`` = FLASH_DQ_BLOCK_K, dq's) work
    list on the card for one shape, made once."""
    return _work_on(device, flash_forward_schedule(
        batch_heads, t_q, t_k, causal, window, _sms(device), block_k))


@functools.lru_cache(maxsize=64)
def _backward_work_on(device: torch.device, batch_kv_heads: int, reps: int,
                      t_q: int, t_k: int, causal: bool, window: int):
    """The dk/dv kernel's work list on the card for one shape, made
    once."""
    return _work_on(device, flash_backward_schedule(
        batch_kv_heads, reps, t_q, t_k, causal, window, _sms(device)))


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None,
                              window: int = 0):
    """The kernel's plain version: an online softmax over key tiles of
    FLASH_BLOCK_K in plain torch. Returns ``(out, lse)``: out in the
    input dtype, the row log-sum-exp in float32 as [B, H, Tq, 1].

    Numerics of the reference's ``_flash_kernel``: float32 running max,
    sum and accumulator; -1e30 for masked scores; P rounded to the V
    dtype before the PV product; ``l`` clamped at 1e-30. Causal rows
    align to the end of the keys (query i sits at position
    i + Tk - Tq), as in ``attention``."""
    _check_flash_args(q, k, v, causal, window)
    batch, heads, t_q, head_dim = q.shape
    t_k = k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    k, v = _repeat_kv(k, v, heads)
    offset = t_k - t_q if causal else 0
    q_pos = torch.arange(t_q, device=q.device)[:, None] + offset
    lo, hi = _key_range(offset, t_q - 1 + offset, t_k, causal, window)
    m = torch.full((batch, heads, t_q, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(batch, heads, t_q, head_dim, dtype=torch.float32,
                      device=q.device)
    for k0 in range(lo - lo % FLASH_BLOCK_K, hi, FLASH_BLOCK_K):
        k_blk = k[:, :, k0:k0 + FLASH_BLOCK_K]
        v_blk = v[:, :, k0:k0 + FLASH_BLOCK_K]
        scores = matmul_f32(q, k_blk.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + k_blk.shape[2],
                                 device=q.device)[None, :]
            visible = k_pos <= q_pos
            if window > 0:
                visible &= k_pos > q_pos - window
            scores = torch.where(visible, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * correction + matmul_f32(p.to(v.dtype), v_blk)
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), m + torch.log(l)


def _flash_delta(out, do, g_lse=None):
    """The backward's row term ``rowsum(dO * O)`` [B, H, Tq, 1] in
    float32, less the lse cotangent when the caller used the lse: dS
    gains +P * g_lse, the same row-broadcast shape as the delta term.
    Computed outside the kernels, as the reference computes it."""
    delta = torch.sum(do.float() * out.float(), dim=-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def flash_backward_reference(q, k, v, out, lse, do, g_lse=None,
                             causal: bool = True,
                             scale: Optional[float] = None, window: int = 0):
    """The backward kernels' plain version: ``(dq, dk, dv)`` of flash
    attention from the forward's ``out`` and ``lse`` and the cotangents
    ``do`` (of out) and ``g_lse`` (of lse, or None), walking key tiles
    of FLASH_BLOCK_K as the kernels do.

    Numerics of the reference's ``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``: P = exp(scale q.k - lse) (0 where the
    -1e30 mask is), dS = P (dO.v - delta'), products of input-dtype
    values summed in float32; dS rounded to k's dtype before dS K and to
    q's dtype before dS^T Q, P to dO's dtype before P^T dO. dk and dv sum
    the group's query heads in float32 and are cast to k/v's dtype."""
    _check_flash_args(q, k, v, causal, window)
    batch, heads, t_q, head_dim = q.shape
    kv_heads, t_k = k.shape[1], k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    delta = _flash_delta(out, do, g_lse)
    kr, vr = _repeat_kv(k, v, heads)
    offset = t_k - t_q if causal else 0
    q_pos = torch.arange(t_q, device=q.device)[:, None] + offset
    lo, hi = _key_range(offset, t_q - 1 + offset, t_k, causal, window)
    dq = torch.zeros(batch, heads, t_q, head_dim, dtype=torch.float32,
                     device=q.device)
    # per query head; summed over each kv head's group at the end
    dk = torch.zeros(batch, heads, t_k, head_dim, dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(lo - lo % FLASH_BLOCK_K, hi, FLASH_BLOCK_K):
        k_blk = kr[:, :, k0:k0 + FLASH_BLOCK_K]
        v_blk = vr[:, :, k0:k0 + FLASH_BLOCK_K]
        k1 = k0 + k_blk.shape[2]
        scores = matmul_f32(q, k_blk.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            visible = k_pos <= q_pos
            if window > 0:
                visible &= k_pos > q_pos - window
            scores = torch.where(visible, scores, _NEG_INF)
        p = torch.exp(scores - lse)
        ds = p * (matmul_f32(do, v_blk.transpose(-1, -2)) - delta)
        dq += matmul_f32(ds.to(k.dtype), k_blk)
        dv[:, :, k0:k1] = matmul_f32(p.transpose(-1, -2).to(do.dtype), do)
        dk[:, :, k0:k1] = matmul_f32(ds.transpose(-1, -2).to(q.dtype), q)
    group = (batch, kv_heads, heads // kv_heads, t_k, head_dim)
    dk = dk.view(group).sum(dim=2) * scale
    dv = dv.view(group).sum(dim=2)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def native_head_dim(head_dim: int) -> int:
    """The head dim whose kernels run a head dim of ``head_dim``: the
    smallest of ``FLASH_HEAD_DIMS`` that holds it. ValueError above the
    largest."""
    for native in FLASH_HEAD_DIMS:
        if head_dim <= native:
            return native
    raise ValueError(f"the flash kernels take head dims up to "
                     f"{FLASH_HEAD_DIMS[-1]}, got {head_dim}")


def pad_head_dim(size: int, *tensors):
    """``tensors`` zero-padded on the last axis to ``size`` (each one
    as it is where it already has that size)."""
    return tuple(t if t.shape[-1] == size else
                 torch.nn.functional.pad(t, (0, size - t.shape[-1]))
                 for t in tensors)


def padded_forward(forward, q, k, v, causal: bool, scale: float,
                   window: int):
    """``forward(q, k, v, causal, scale, window) -> (out, lse)`` at the
    native head dim of q's: q, k and v zero-padded to it, out sliced
    back; lse is unchanged (zero columns add nothing to q.k). ``scale``
    must be given: 1/sqrt(D) of the true D."""
    head_dim = q.shape[-1]
    native = native_head_dim(head_dim)
    if native == head_dim:
        return forward(q, k, v, causal, scale, window)
    out, lse = forward(*pad_head_dim(native, q, k, v), causal, scale,
                       window)
    return out[..., :head_dim].contiguous(), lse


def padded_backward(backward, q, k, v, out, lse, do, g_lse, causal: bool,
                    scale: float, window: int):
    """``backward(q, k, v, out, lse, do, g_lse, causal, scale, window)
    -> (dq, dk, dv)`` at the native head dim of q's: q, k, v, out and dO
    zero-padded to it (rowsum(dO * O) is unchanged), the gradients
    sliced back. The lse and its cotangent are per row: as they are."""
    head_dim = q.shape[-1]
    native = native_head_dim(head_dim)
    if native == head_dim:
        return backward(q, k, v, out, lse, do, g_lse, causal, scale, window)
    grads = backward(*pad_head_dim(native, q, k, v, out), lse,
                     *pad_head_dim(native, do), g_lse, causal, scale,
                     window)
    return tuple(g[..., :head_dim].contiguous() for g in grads)


def _bind(lib_name: str, fn_name: str, n_ptrs: int, n_extra: int = 0):
    """Entry ``fn_name`` of kernel library ``lib_name`` (built at first
    use), with its ctypes signature: ``n_ptrs`` tensor pointers, then B H
    Hkv Tq Tk D bf16 causal (ints), scale (float), window and ``n_extra``
    more ints, and the stream."""
    from . import _build

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * n_ptrs + [i32] * 8 + [ctypes.c_float]
                       + [i32] * (1 + n_extra) + [ptr])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(**tensors) -> None:
    """What the kernels take: bf16 or float32, one dtype and device, a
    head dim they are built for, contiguous 16-byte aligned rows (the
    kernels read rows as 16-byte vectors). The first tensor is q."""
    q = next(iter(tensors.values()))
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or float32, got {q.dtype}")
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; q is "
                            f"{q.dtype} on {q.device}")
    if q.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims "
                         f"{FLASH_HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel takes contiguous, 16-byte "
                             f"aligned tensors; {name} is not")


def _launch(name: str, fn, q, k, pointers, causal: bool, scale: float,
            window: int, *extra: int) -> None:
    """Call kernel entry ``fn`` on ``pointers`` (a None passes NULL) and
    the shapes of q and k, then ``extra`` ints; count the launch."""
    batch, heads, t_q, head_dim = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in pointers),
                 batch, heads, k.shape[1], t_q, k.shape[2], head_dim,
                 int(q.dtype == torch.bfloat16), int(causal), float(scale),
                 int(window), *extra, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _flash_forward_cuda(q, k, v, causal: bool, scale: float, window: int):
    _check_kernel_args(q=q, k=k, v=v)
    fn = _bind("flash_fwd", "flash_fwd", 6, n_extra=1)
    out = torch.empty_like(q)
    lse = torch.empty(*q.shape[:3], 1, dtype=torch.float32, device=q.device)
    work, blocks = None, 0   # the float32 kernel has a one-shot grid
    if q.dtype == torch.bfloat16:
        work, blocks = _forward_work_on(q.device, q.shape[0] * q.shape[1],
                                        q.shape[2], k.shape[2], causal,
                                        window)
    _launch("flash_fwd", fn, q, k, (q, k, v, out, lse, work), causal, scale,
            window, blocks)
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float,
                       window: int):
    """dq by the ``flash_bwd_dq`` kernel (checked inputs, delta')."""
    dq = torch.empty_like(q)
    work, blocks = None, 0   # the float32 kernel has a one-shot grid
    if q.dtype == torch.bfloat16:
        work, blocks = _forward_work_on(
            q.device, q.shape[0] * q.shape[1], q.shape[2], k.shape[2],
            causal, window, FLASH_DQ_BLOCK_K)
    _launch("flash_bwd_dq", _bind("flash_bwd", "flash_bwd_dq", 8, n_extra=1),
            q, k, (q, k, v, do, lse, delta, dq, work), causal, scale, window,
            blocks)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float,
                        window: int):
    """(dk, dv) by the ``flash_bwd_dkv`` kernel (checked inputs, delta').
    For bf16 with more than one query head per kv head, the group's
    ordered sum needs a float32 scratch and a zeroed counter per
    (kv head, key tile), made here for each call."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work = scratch = counters = None
    blocks = 0
    batch, kv_heads, t_k, head_dim = k.shape
    reps = q.shape[1] // kv_heads
    if q.dtype == torch.bfloat16:
        work, blocks = _backward_work_on(q.device, batch * kv_heads, reps,
                                         q.shape[2], t_k, causal, window)
        # the kernel reads lse and delta' rows in TMA boxes that must start
        # 16-byte aligned: rows padded to a multiple of 4 floats
        pad = -q.shape[2] % 4
        if pad:
            lse, delta = (torch.nn.functional.pad(
                x.reshape(-1, q.shape[2]), (0, pad)) for x in (lse, delta))
        if reps > 1:
            tiles = batch * kv_heads * -(-t_k // FLASH_DKV_BLOCK_K)
            counters = torch.zeros(tiles, dtype=torch.int32, device=q.device)
            scratch = torch.empty(tiles * 2 * FLASH_DKV_BLOCK_K * head_dim,
                                  dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkv",
            _bind("flash_bwd", "flash_bwd_dkv", 11, n_extra=1), q, k,
            (q, k, v, do, lse, delta, dk, dv, work, scratch, counters),
            causal, scale, window, blocks)
    return dk, dv


def _flash_backward_cuda(q, k, v, out, lse, do, g_lse, causal: bool,
                         scale: float, window: int):
    # dO reaches autograd's backward through a transpose and reshape of
    # the output, so it may not be contiguous
    rows = (*q.shape[:3], 1)
    if (do.shape != q.shape or out.shape != q.shape
            or tuple(lse.shape) != rows
            or (g_lse is not None and tuple(g_lse.shape) != rows)):
        raise ValueError(f"flash backward takes do and out shaped like q "
                         f"{tuple(q.shape)}, lse and g_lse shaped {rows}")
    do = do.contiguous()
    _check_kernel_args(q=q, k=k, v=v, do=do)
    delta = _flash_delta(out, do, g_lse).contiguous()
    lse = lse.to(torch.float32).contiguous()
    if lse.data_ptr() % 16:   # the kernels read lse rows through TMA
        lse = lse.clone()
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                 window)
    return dq, dk, dv


def _device_route(q) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return True


def flash_forward(q, k, v, causal: bool = True,
                  scale: Optional[float] = None, window: int = 0):
    """``(out, lse)`` of flash attention: the CUDA kernel for CUDA
    tensors (any head dim up to 128, padded to the next native one), the
    plain version for CPU tensors. Takes any Tq, Tk (the kernel masks
    ragged tiles itself); causal needs Tq <= Tk."""
    _check_flash_args(q, k, v, causal, window)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _device_route(q):
        return padded_forward(_flash_forward_cuda, q, k, v, causal, scale,
                              window)
    return flash_attention_reference(q, k, v, causal, scale, window)


def flash_backward(q, k, v, out, lse, do, g_lse=None, causal: bool = True,
                   scale: Optional[float] = None, window: int = 0):
    """``(dq, dk, dv)`` of flash attention (see
    ``flash_backward_reference``): the CUDA kernels ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` for CUDA tensors, the plain version for CPU
    tensors. Same shapes and position rules as ``flash_forward``."""
    _check_flash_args(q, k, v, causal, window)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _device_route(q):
        return padded_backward(_flash_backward_cuda, q, k, v, out, lse, do,
                               g_lse, causal, scale, window)
    return flash_backward_reference(q, k, v, out, lse, do, g_lse, causal,
                                    scale, window)


class _FlashAttention(torch.autograd.Function):
    """``(out, lse)``, differentiable in both: the forward saves q, k,
    v, out and lse; the backward runs ``flash_backward`` with the
    cotangent of out and, when the caller used the lse, of lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        out, lse = flash_forward(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flash_args = (causal, scale, window)
        ctx.set_materialize_grads(False)   # an unused lse gives None
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_backward(q, k, v, out, lse, g_out, g_lse,
                                    *ctx.flash_args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, window: int = 0):
    """Flash attention output [B, H, Tq, D]."""
    return _FlashAttention.apply(q, k, v, causal, scale, window)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             window: int = 0):
    """Flash attention that also returns the row log-sum-exp
    [B, H, Tq, 1] (float32), the ingredient block-merging callers
    (ring attention) need. Differentiable in both outputs: the lse
    cotangent folds into the backward's row term."""
    return _FlashAttention.apply(q, k, v, causal, scale, window)


def flash_eligible(q_shape, k_shape, causal: bool) -> bool:
    """Whether the CUDA kernels take these shapes: a head dim up to
    the largest they are built for (others are padded to the next one)
    and, when causal, Tq <= Tk. Any length, ragged or short: the kernels
    mask partial tiles themselves. (The reference's rule also asks for
    Tq >= 128 and tiles dividing T; the kernels need neither.)"""
    return (1 <= q_shape[-1] <= FLASH_HEAD_DIMS[-1]
            and (not causal or q_shape[-2] <= k_shape[-2]))


def mha(q, k, v, causal: bool = True, use_flash: Optional[bool] = None,
        window: int = 0):
    """Dispatch: the flash kernels for CUDA tensors, plain attention for
    CPU tensors; ``use_flash`` overrides. A CUDA shape the kernels do not
    take (``flash_eligible``) raises rather than run plain attention
    unasked: pass ``use_flash=False`` for that."""
    if use_flash is None:
        use_flash = q.is_cuda
        if use_flash and not flash_eligible(q.shape, k.shape, causal):
            raise ValueError(
                f"the flash kernels do not take q {tuple(q.shape)}, k "
                f"{tuple(k.shape)} (causal={causal}): head dims up to "
                f"{FLASH_HEAD_DIMS[-1]}, causal Tq <= Tk; use_flash=False "
                "runs plain attention")
    if use_flash:
        return flash_attention(q, k, v, causal, window=window)
    return attention(q, k, v, causal, window=window)
