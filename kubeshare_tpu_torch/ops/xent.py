"""Fused linear + softmax cross-entropy over vocab chunks (port of
``kubeshare_tpu/ops/xent.py``).

The loss of ``softmax(hidden @ w)`` against labels, and both gradients,
while only one ``[N, chunk]`` logit tile is ever held: the forward walks
the vocab in chunks with an online max / log-sum-exp, gathering each
row's label logit on the way; the backward walks it again, recomputing
each chunk's logits from the saved normaliser and accumulating
``dHidden`` (tile @ w_c^T) and ``dW`` (hidden^T @ tile). The reference is
a ``lax.scan`` with no Pallas kernel; here the scan is a Python loop of
``torch.matmul``s (float32 accumulation whatever the operand dtype).

A ragged last tile is clamped to end at the vocab, as
``jax.lax.dynamic_slice`` clamps it: its columns that the previous tile
already covered are masked in both passes, so the weight is never padded
or copied.

Vocab-parallel (``group``, port-only: the reference's GSPMD splits the
scan's product over its tp axis): ``w`` holds the vocabulary columns
``[vocab_start, vocab_start + V_local)`` of this rank of ``group``. The
forward walks the local tiles, then reduces the row max (max) and the
rescaled sum of exponentials and the label's logit (sum) over the group
in one call each; the backward walks the local tiles against the global
normaliser and returns this rank's share of ``dHidden`` (the caller sums
it over the group, ``comm.copy_to``) and its columns' ``dW``.
"""

from __future__ import annotations

import torch

from .attention import matmul_f32


def _tile_plan(vocab: int, chunk: int, n: int = 0):
    """(chunk, steps, ragged): the tile width never exceeds the vocab,
    and the last tile of a ragged vocab is clamped to end at ``vocab``.

    ``chunk <= 0`` sizes the tile: the widest power of two keeping one
    float32 [N, chunk] tile near 512 MB, at least 2048. That needs the
    real row count, so ``n >= 1`` is required then."""
    if chunk <= 0:
        if n < 1:
            raise ValueError(
                f"auto-sized tile plan needs the row count: n={n}"
            )
        budget_cols = (512 << 20) // 4 // n
        chunk = 2048
        while chunk * 2 <= budget_cols and chunk < vocab:
            chunk *= 2
    chunk = min(chunk, vocab)
    steps = -(-vocab // chunk)
    return chunk, steps, vocab % chunk != 0


def _chunk_logits(hidden: torch.Tensor, w: torch.Tensor, chunk: int, i: int):
    """Float32 logits [N, chunk] of tile i, the tile's true column ids,
    the mask of the columns it owns (False on the clamped last tile's
    overlap with the tile before it), the weight slice and its start."""
    vocab = w.shape[1]
    start = min(i * chunk, vocab - chunk)
    w_c = w[:, start:start + chunk]
    logits = matmul_f32(hidden, w_c)
    cols = start + torch.arange(chunk, device=hidden.device)
    owned = cols >= i * chunk
    return logits, cols, owned, w_c, start


class _ChunkedLinearXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, w, labels, chunk, group, vocab_start):
        n = hidden.shape[0]
        labels = labels - vocab_start
        tile, steps, _ = _tile_plan(w.shape[1], chunk, n)
        m = torch.full((n,), float("-inf"), device=hidden.device)
        s = torch.zeros(n, device=hidden.device)
        label_logit = torch.zeros(n, device=hidden.device)
        for i in range(steps):
            logits, cols, owned, _, _ = _chunk_logits(hidden, w, tile, i)
            logits = torch.where(owned[None, :], logits, float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # exp(-inf - m) == 0 covers the masked columns and tile 0
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            hit = (cols[None, :] == labels[:, None]) & owned[None, :]
            label_logit = label_logit + torch.where(hit, logits, 0.0).sum(-1)
            m = m_new
        if group is not None:
            from ..parallel import comm

            m_all = comm.all_reduce_(m.clone(), group, op="max")
            sums = torch.stack([s * torch.exp(m - m_all), label_logit])
            s, label_logit = comm.all_reduce_(sums, group)
            m = m_all
        logz = m + torch.log(s)
        ctx.save_for_backward(hidden, w, labels, logz)
        ctx.chunk = chunk
        return torch.mean(logz - label_logit)

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels, logz = ctx.saved_tensors
        n, d = hidden.shape
        vocab = w.shape[1]
        tile, steps, _ = _tile_plan(vocab, ctx.chunk, n)
        scale = g / n  # d(mean) / d(per-row loss)
        dh = torch.zeros(n, d, device=hidden.device)
        dw = torch.zeros(d, vocab, device=hidden.device)
        for i in range(steps):
            logits, cols, owned, w_c, start = _chunk_logits(hidden, w, tile,
                                                            i)
            p = torch.exp(logits - logz[:, None])      # the softmax tile
            hit = (cols[None, :] == labels[:, None]) & owned[None, :]
            dlogits = torch.where(owned[None, :], (p - hit.float()) * scale,
                                  0.0)
            # product operands in the tile's dtype (bf16 in training),
            # float32 accumulation, as the reference
            dlog_c = dlogits.to(w_c.dtype)
            dh += matmul_f32(dlog_c, w_c.transpose(0, 1))
            # the clamped last tile's overlap columns are 0 here, so the
            # add keeps what their owner tile wrote
            dw[:, start:start + tile] += matmul_f32(hidden.transpose(0, 1),
                                                    dlog_c)
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None, None, None


def chunked_linear_xent(hidden: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor, chunk: int = 0, group=None,
                        vocab_start: int = 0) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(hidden @ w)`` against ``labels``
    without materialising the logits.

    hidden: [N, D] (any float dtype; accumulation is float32)
    w:      [D, V] classifier / lm head matrix (the reference's layout)
    labels: [N] integers in [0, V)
    chunk:  vocab tile width; V need not divide it. <= 0 sizes it by N
            (see ``_tile_plan``).
    group, vocab_start: vocab-parallel (module docstring): ``w`` holds
            columns ``[vocab_start, vocab_start + V)`` of the vocabulary
            split over ``group``; ``labels`` are global ids.
    """
    return _ChunkedLinearXent.apply(hidden, w, labels, chunk, group,
                                    vocab_start)
