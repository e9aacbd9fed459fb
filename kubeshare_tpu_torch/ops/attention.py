"""Attention: the plain version and the flash-attention forward kernel
(port of ``kubeshare_tpu/ops/attention.py``).

``attention`` is the plain O(T^2)-memory version and runs anywhere.
``flash_attention`` / ``flash_attention_with_lse`` run the hand-written
CUDA kernel ``csrc/flash_fwd.cu`` (the port of the Pallas
``_flash_kernel``) on CUDA tensors, and its plain PyTorch version,
``flash_attention_reference``, on CPU tensors. For a CUDA tensor the
wrapper launches the kernel or raises; nothing falls back.

Shapes as in the reference: q [B, H, Tq, D], k/v [B, Hkv, Tk, D] with H
a multiple of Hkv (grouped-query attention). The kernel reads each kv
head once for its H/Hkv query heads; K/V are never repeated.

Only the forward is ported: the backward of the flash functions raises
(the dq and dkv kernels are ROADMAP Queue 2, items 2 and 3).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Head dims the CUDA kernel is compiled for (a template argument of
# csrc/flash_fwd.cu). mha() sends other head dims to attention().
FLASH_HEAD_DIMS = (64, 128)
# The kernel's key-tile width (BK in csrc/flash_fwd.cu). The plain
# version walks the same tiles, so its online-softmax rescaling (and
# the rounding of P to the input dtype) happens at the same places.
FLASH_BLOCK_K = 64

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"flash_fwd": 0}


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
    float32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
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


# Preferred tile edges of the reference, largest first: they decide
# which shapes the reference's flash kernel accepts, and so mha()'s
# dispatch rule. The CUDA kernel tiles by its own BQ/BK and masks
# ragged edges itself.
_BLOCK_CANDIDATES = (512, 256, 128)


def _pick_block(t: int, requested: Optional[int]) -> int:
    """Largest preferred tile dividing ``t`` (or the caller's choice,
    clamped)."""
    if requested is not None:
        return min(requested, t)
    for b in _BLOCK_CANDIDATES:
        if t % b == 0:
            return b
    return min(128, t)


def flash_shapes_ok(q_shape, k_shape, causal: bool,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> bool:
    """Whether the reference flash kernel's tiling constraints hold."""
    t_q, t_k = q_shape[-2], k_shape[-2]
    bq, bk = _pick_block(t_q, block_q), _pick_block(t_k, block_k)
    if t_q % bq or t_k % bk:
        return False
    if causal and t_q != t_k:
        return False
    return True


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


def _flash_lib():
    from . import _build

    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr,            # q k v out lse
                       i32, i32, i32, i32, i32, i32,      # B H Hkv Tq Tk D
                       i32, i32, ctypes.c_float, i32,     # bf16 causal scale window
                       ptr]                               # stream
        fn.restype = ctypes.c_int
    return fn


def _flash_forward_cuda(q, k, v, causal: bool, scale: float, window: int):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or float32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; q is "
                            f"{q.dtype} on {q.device}")
    batch, heads, t_q, head_dim = q.shape
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims "
                         f"{FLASH_HEAD_DIMS}, got {head_dim}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel reads rows as 16-byte vectors
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel takes contiguous, 16-byte "
                             f"aligned tensors; {name} is not")
    fn = _flash_lib()
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, t_q, 1, dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), batch, heads, k.shape[1], t_q, k.shape[2],
                 head_dim, int(q.dtype == torch.bfloat16), int(causal),
                 float(scale), int(window), stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, causal: bool = True,
                  scale: Optional[float] = None, window: int = 0):
    """``(out, lse)`` of flash attention: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Takes any Tq, Tk (the
    kernel masks ragged tiles itself); causal needs Tq <= Tk."""
    _check_flash_args(q, k, v, causal, window)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _flash_forward_cuda(q, k, v, causal, scale, window)


class _FlashAttention(torch.autograd.Function):
    """Forward only: differentiating the plain path here would hide
    that the backward kernels are not ported."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        return flash_forward(q, k, v, causal, scale, window)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention backward is not ported: the dq and dkv "
            "kernels (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel) are "
            "ROADMAP Queue 2, items 2 and 3"
        )


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, window: int = 0):
    """Flash attention output [B, H, Tq, D]."""
    return _FlashAttention.apply(q, k, v, causal, scale, window)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             window: int = 0):
    """Flash attention that also returns the row log-sum-exp
    [B, H, Tq, 1] (float32), the ingredient block-merging callers
    (ring attention) need."""
    return _FlashAttention.apply(q, k, v, causal, scale, window)


def flash_eligible(q_shape, k_shape, causal: bool) -> bool:
    """The reference's dispatch rule (Tq >= 128 and its tiling
    constraints) plus the head dims the CUDA kernel is built for."""
    return (q_shape[-2] >= 128
            and flash_shapes_ok(q_shape, k_shape, causal)
            and q_shape[-1] in FLASH_HEAD_DIMS)


def mha(q, k, v, causal: bool = True, use_flash: Optional[bool] = None,
        window: int = 0):
    """Dispatch: the flash kernel for CUDA tensors of eligible shapes
    (``flash_eligible``), plain attention otherwise."""
    if use_flash is None:
        use_flash = q.is_cuda and flash_eligible(q.shape, k.shape, causal)
    if use_flash:
        return flash_attention(q, k, v, causal, window=window)
    return attention(q, k, v, causal, window=window)
