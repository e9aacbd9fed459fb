"""The port's flash-attention backward against kubeshare_tpu/ops/attention.py.

The same numpy inputs and cotangents go through ``jax.vjp`` of the JAX
package's ``flash_attention`` / ``flash_attention_with_lse`` (its Pallas
kernels in interpret mode, blocks of 128, as tests/test_torch_attention.py
runs the forward) and through torch autograd of the port's counterparts
on the CPU, where the backward runs the kernels' plain version,
``flash_backward_reference``. Ragged shapes, which the reference's flash
refuses, are held against autograd through the port's plain
``attention``.

Tolerances, on the max abs difference relative to each gradient's max
abs: float32 1e-5 (both sides sum exact float32 products, in another
order); bf16 2e-2 (P and dS are rounded to bf16 before their products,
and dq/dk/dv at the end, at the same places in both frameworks, but a
summation-order difference can flip a rounding by one bf16 ulp, 2^-8).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jattn = importlib.import_module("kubeshare_tpu.ops.attention")
tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

REL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BLOCK = 128


def _inputs(seed, h=4, hkv=2, tq=128, tk=None, d=64):
    rng = np.random.default_rng(seed)
    tk = tk or tq
    return (rng.standard_normal((1, h, tq, d), dtype=np.float32),
            rng.standard_normal((1, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((1, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((1, h, tq, d), dtype=np.float32),
            rng.standard_normal((1, h, tq, 1), dtype=np.float32))


def _rel(got, want):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _port_grads(q, k, v, do, g_lse, dtype, causal, window, with_lse):
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  .requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do).to(tq.dtype)
    if with_lse:
        out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal,
                                                  window=window)
        obj = (out.float() * tdo.float()).sum() + (lse * torch.from_numpy(
            g_lse)).sum()
    else:
        out = tattn.flash_attention(tq, tk, tv, causal, window=window)
        obj = (out.float() * tdo.float()).sum()
    grads = torch.autograd.grad(obj, (tq, tk, tv))
    for g, t in zip(grads, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
    return grads


def _jax_grads(q, k, v, do, g_lse, dtype, causal, window, with_lse):
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jdo = jnp.asarray(do, jdt)
    if with_lse:
        (_, _), vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention_with_lse(
                a, b, c, causal, None, BLOCK, BLOCK, True, window),
            jq, jk, jv)
        return vjp((jdo, jnp.asarray(g_lse)))
    _, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, causal, None, BLOCK,
                                              BLOCK, True, window),
        jq, jk, jv)
    return vjp(jdo)


CASES = [
    # (causal, window, hkv, tq): heads 4, head dim 64
    (True, 0, 4, 128),         # causal MHA
    (False, 0, 4, 128),        # non-causal
    (True, 0, 2, 256),         # GQA 4/2, two q and k tiles
    (True, 64, 2, 256),        # sliding window
    (False, 0, 1, 128),        # MQA
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,hkv,tq", CASES)
def test_flash_attention_vjp_matches_jax(causal, window, hkv, tq, dtype):
    q, k, v, do, _ = _inputs(10 + hkv + tq, hkv=hkv, tq=tq)
    args = (q, k, v, do, None, dtype, causal, window, False)
    got = _port_grads(*args)
    want = _jax_grads(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= REL_TOL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("causal,window,hkv,tq,dtype", [
    (True, 0, 2, 128, "float32"),
    (False, 0, 4, 128, "float32"),
    (True, 64, 2, 256, "float32"),
    (False, 0, 1, 128, "float32"),
    (True, 0, 2, 128, "bfloat16"),
    (True, 64, 2, 256, "bfloat16"),
])
def test_flash_with_lse_vjp_matches_jax(causal, window, hkv, tq, dtype):
    """A nonzero lse cotangent (what a ring-attention merge sends back)
    folds into the backward's row term on both sides."""
    q, k, v, do, g_lse = _inputs(20 + hkv + tq, hkv=hkv, tq=tq)
    args = (q, k, v, do, g_lse, dtype, causal, window, True)
    got = _port_grads(*args)
    want = _jax_grads(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= REL_TOL[dtype], (name, _rel(g, w))


# head dim 32, the reference's own Llama (dim 256, 8 heads): (causal,
# window, hkv, tq, with an lse cotangent), heads 4
D32_CASES = [
    (True, 0, 4, 128, False),   # causal MHA
    (False, 0, 2, 128, True),   # non-causal, GQA 4/2
    (True, 64, 2, 256, True),   # sliding window
    (True, 0, 1, 256, False),   # MQA, two q and k tiles
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,hkv,tq,with_lse", D32_CASES)
def test_head_dim_32_vjp_matches_jax(causal, window, hkv, tq, with_lse,
                                     dtype):
    q, k, v, do, g_lse = _inputs(50 + hkv + tq, hkv=hkv, tq=tq, d=32)
    args = (q, k, v, do, g_lse if with_lse else None, dtype, causal,
            window, with_lse)
    got = _port_grads(*args)
    want = _jax_grads(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape[-1] == 32
        assert _rel(g, w) <= REL_TOL[dtype], (name, _rel(g, w))


def _plain_grads(q, k, v, do, g_lse, causal, window):
    """Autograd through the port's plain attention and a direct
    logsumexp of the same masked scores."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal=causal, window=window)
    obj = (out * torch.from_numpy(do)).sum()
    if g_lse is not None:
        kr, _ = tattn._repeat_kv(tk, tv, tq.shape[1])
        scores = torch.matmul(tq, kr.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if causal:
            n_q, n_k = q.shape[2], k.shape[2]
            q_pos = torch.arange(n_q)[:, None] + n_k - n_q
            k_pos = torch.arange(n_k)[None, :]
            visible = k_pos <= q_pos
            if window:
                visible &= k_pos > q_pos - window
            scores = scores.masked_fill(~visible, float("-inf"))
        lse = torch.logsumexp(scores, -1, keepdim=True)
        obj = obj + (lse * torch.from_numpy(g_lse)).sum()
    return torch.autograd.grad(obj, (tq, tk, tv))


@pytest.mark.parametrize("causal,window,tq,tk,with_lse", [
    (True, 0, 200, 200, False),     # ragged: no tile divides T
    (True, 37, 200, 200, True),     # ragged with a window
    (False, 0, 70, 333, True),      # ragged, Tq != Tk
    (True, 0, 70, 333, False),      # causal, Tq < Tk
])
def test_ragged_backward_matches_plain_autograd(causal, window, tq, tk,
                                                with_lse):
    """Shapes the reference's flash refuses but the CUDA kernels (and so
    their plain version) take."""
    q, k, v, do, g_lse = _inputs(30 + tq, tq=tq, tk=tk)
    g_lse = g_lse if with_lse else None
    got = _port_grads(q, k, v, do, g_lse, "float32", causal, window,
                      with_lse)
    want = _plain_grads(q, k, v, do, g_lse, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w.numpy()) <= 1e-5, (name, _rel(g, w.numpy()))


def test_backward_reference_is_the_cpu_route_and_counts_no_launch():
    """On CPU tensors flash_backward is its plain version and counts no
    kernel launch; an unused lse cotangent (None) equals a zero one."""
    q, k, v, do, _ = (torch.from_numpy(a) for a in _inputs(40, tq=96))
    out, lse = tattn.flash_forward(q, k, v, True)
    before = dict(tattn.LAUNCHES)
    got = tattn.flash_backward(q, k, v, out, lse, do)
    assert tattn.LAUNCHES == before
    want = tattn.flash_backward_reference(q, k, v, out, lse, do,
                                          torch.zeros_like(lse))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no flash attention"):
        tattn.flash_backward(*(t.to("meta") for t in (q, k, v, out, lse,
                                                       do)))


def test_flash_delta_folds_the_lse_cotangent():
    out = torch.tensor([[[[1.0, 2.0], [3.0, -1.0]]]])
    do = torch.tensor([[[[0.5, 0.25], [2.0, 1.0]]]])
    np.testing.assert_array_equal(
        tattn._flash_delta(out, do).numpy().ravel(), [1.0, 5.0])
    g_lse = torch.tensor([[[[0.5], [-1.0]]]])
    np.testing.assert_array_equal(
        tattn._flash_delta(out, do, g_lse).numpy().ravel(), [0.5, 6.0])
