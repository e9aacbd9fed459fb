"""The yardstick's arithmetic: the H100's peaks and the flash kernels'
least time. A model's operations are its family's to count
(``families/<family>.py``: ``forward_flops``, ``attention_calls``).

Frozen copies (later PRs may not move them):
- ``visible_pairs``, ``FLASH_WORK`` and ``flash_bound_s`` from
  ``chip_smoke.py::visible_pairs`` / ``FLASH_WORK`` / ``flash_bound_ms``.
  One change: the operations and bytes are counted at the model's own
  head dim (``chip_smoke.py`` counts at the dim it is given, so a call
  padded from 96 to 128 was credited with 128's work). A roofline here
  reads the same work whatever runs it.
- The peaks: NVIDIA's H100 SXM data sheet, dense rates.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Per flash kernel: (operations per visible pair and head dim, tensors of
# q's size read and written, tensors of k's size read and written,
# float32 rows [B, H, Tq] read and written). fwd: Q K^T and P V; reads
# q, k, v; writes out and lse. bwd_dq: Q K^T, dO V^T, dS K; reads q, dO,
# k, v, lse, delta'; writes dq. bwd_dkv: Q K^T, dO V^T, P^T dO, dS^T Q;
# reads the same; writes dk and dv.
FLASH_WORK = {"fwd": (4, 2, 2, 1), "bwd_dq": (6, 3, 2, 2),
              "bwd_dkv": (8, 2, 4, 2)}


def visible_pairs(t_q: int, t_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: query i (at absolute position
    i + t_k - t_q) sees min(position + 1, window) keys."""
    if not causal:
        return t_q * t_k
    total = 0
    for i in range(t_q):
        pos = i + t_k - t_q
        total += min(pos + 1, window) if window > 0 else pos + 1
    return total


def flash_bound_s(shape, dtype_name: str, causal: bool, window: int,
                  kind: str) -> float:
    """Least seconds of one flash kernel of ``kind`` on an H100 at
    ``shape`` = (B, H, Hkv, Tq, Tk, D), D the model's head dim: each
    input read once and each output written once at the HBM rate,
    against its products' operations at the peak rate of the input
    type."""
    batch, heads, kv_heads, t_q, t_k, head_dim = shape
    per_pair, q_like, k_like, rows = FLASH_WORK[kind]
    elem = 2 if dtype_name in ("bfloat16", "float16") else 4
    n_bytes = elem * head_dim * (q_like * batch * heads * t_q
                                 + k_like * batch * kv_heads * t_k)
    n_bytes += 4 * rows * batch * heads * t_q
    ops = per_pair * batch * heads * head_dim * visible_pairs(
        t_q, t_k, causal, window)
    return max(n_bytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype_name])
