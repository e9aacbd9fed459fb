"""Head dims the flash kernels are not built for: the port's flash path
against kubeshare_tpu/ops/attention.py at D in {8, 16, 24, 48, 96}.

The reference's flash path has no rule on the head dim; the port's
kernels are built for 16, 32, 64, 128 and 256, and every other D up to
256 runs the next of those on zero-padded inputs (``padded_forward``,
``padded_backward`` in ``ops/attention.py``; D above 128 is
tests/test_torch_head_dims_wide.py's). Here on the CPU:

- the port's plain versions (``flash_attention_reference``,
  ``flash_backward_reference``, reached through ``flash_attention`` and
  ``flash_attention_with_lse`` on CPU tensors) against the reference's
  ``flash_attention_with_lse`` and its ``jax.vjp`` (Pallas in interpret
  mode, blocks of 128), with an lse cotangent, GQA (4 heads over 2), in
  float32 and bf16, under a causal, a windowed and a full mask; a causal
  Tq < Tk, which the reference's flash refuses, against the reference's
  plain ``attention`` and its ``jax.vjp``;
- the padding itself, with the plain version as the inner function:
  pad -> plain -> slice equals plain at D, forward and backward;
- ``flash_eligible``: every D up to 256, not 257.

Tolerances: float32 out and lse 1e-5 abs, gradients 1e-4 of each
gradient's max abs (exact float32 products summed in another order);
bf16 2e-2 of each tensor's max abs (P and dS rounded to bf16 before
their products, a summation-order difference flips a rounding by one
bf16 ulp, 2^-8). The padding check: float32 1e-6 of the max abs, bf16
4e-3 (one bf16 ulp of the largest entry: the padded product sums the
same terms plus zeros, perhaps in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jattn = importlib.import_module("kubeshare_tpu.ops.attention")
tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

HEAD_DIMS = (8, 16, 24, 48, 96)
DTYPES = ("float32", "bfloat16")
# (causal, window, Tq, Tk)
MASKS = {
    "causal": (True, 0, 128, 128),
    "window": (True, 48, 128, 128),
    "full": (False, 0, 128, 128),
    "causal_tq_lt_tk": (True, 0, 64, 128),
}
BLOCK = 128
F32_OUT_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 2e-2
PAD_TOL = {"float32": 1e-6, "bfloat16": 4e-3}


def _inputs(seed, d, tq, tk, h=4, hkv=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, h, tq, d), dtype=np.float32),
            rng.standard_normal((1, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((1, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((1, h, tq, d), dtype=np.float32),
            rng.standard_normal((1, h, tq, 1), dtype=np.float32))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _port(q, k, v, do, g_lse, dtype, causal, window):
    """(out, lse, dq, dk, dv) of the port's flash path on CPU tensors."""
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  .requires_grad_() for a in (q, k, v))
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal,
                                              window=window)
    obj = (out.float() * torch.from_numpy(do)).sum()
    if g_lse is not None:
        obj = obj + (lse * torch.from_numpy(g_lse)).sum()
    grads = torch.autograd.grad(obj, (tq, tk, tv))
    for g, t in zip(grads, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
    return (out, lse, *grads)


def _reference(q, k, v, do, g_lse, dtype, causal, window):
    """The same through the reference: its flash kernel (interpret mode)
    with the lse cotangent, or, where its flash refuses the shape (causal
    Tq != Tk), its plain ``attention`` (no lse: lse None)."""
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jdo = jnp.asarray(do, jdt)
    if jattn.flash_shapes_ok(q.shape, k.shape, causal, BLOCK, BLOCK):
        (out, lse), vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention_with_lse(
                a, b, c, causal, None, BLOCK, BLOCK, True, window),
            jq, jk, jv)
        return (out, lse, *vjp((jdo, jnp.asarray(g_lse))))
    out, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, causal,
                                                       None, window),
                       jq, jk, jv)
    return (out, None, *vjp(jdo))


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_at_head_dim_matches_the_reference(d, dtype, mask):
    causal, window, tq, tk = MASKS[mask]
    q, k, v, do, g_lse = _inputs(100 + d, d, tq, tk)
    want = _reference(q, k, v, do, g_lse, dtype, causal, window)
    with_lse = want[1] is not None
    got = _port(q, k, v, do, g_lse if with_lse else None, dtype, causal,
                window)
    names = ("out", "lse", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        assert g.shape[-1] == _np(w).shape[-1], name
        if dtype == "bfloat16":
            err, tol = _rel(g, w), BF16_TOL
        elif name in ("out", "lse"):
            err, tol = np.abs(_np(g) - _np(w)).max(), F32_OUT_TOL
        else:
            err, tol = _rel(g, w), F32_GRAD_TOL
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", (8, 24, 48, 96))
def test_padding_to_the_native_head_dim_changes_nothing(d, dtype):
    """pad -> plain -> slice equals plain at D, forward and backward
    (with an lse cotangent), through the wrappers the CUDA route uses."""
    assert tattn.native_head_dim(d) in tattn.FLASH_HEAD_DIMS
    assert tattn.native_head_dim(d) > d
    causal, window = True, 48
    q, k, v, do, g_lse = (torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in _inputs(200 + d, d, 96, 128))
    g_lse = g_lse.float()
    scale = d ** -0.5
    want_out, want_lse = tattn.flash_attention_reference(
        q, k, v, causal, scale, window)
    out, lse = tattn.padded_forward(tattn.flash_attention_reference, q, k,
                                    v, causal, scale, window)
    assert out.shape == want_out.shape and out.is_contiguous()
    assert _rel(out, want_out) <= PAD_TOL[dtype]
    assert _rel(lse, want_lse) <= PAD_TOL["float32"]
    want = tattn.flash_backward_reference(q, k, v, want_out, want_lse, do,
                                          g_lse, causal, scale, window)
    got = tattn.padded_backward(tattn.flash_backward_reference, q, k, v,
                                want_out, want_lse, do, g_lse, causal,
                                scale, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= PAD_TOL[dtype], (name, _rel(g, w))


def test_native_head_dims_run_unpadded():
    calls = []

    def inner(q, k, v, causal, scale, window):
        calls.append(q.shape[-1])
        return q, None

    for d in tattn.FLASH_HEAD_DIMS:
        q = torch.zeros(1, 1, 4, d)
        assert tattn.padded_forward(inner, q, q, q, True, 1.0, 0)[0] is q
    assert calls == list(tattn.FLASH_HEAD_DIMS)
    assert [tattn.native_head_dim(d) for d in (1, 8, 17, 33, 65, 96, 128)] \
        == [16, 16, 32, 64, 128, 128, 128]


@pytest.mark.parametrize("d,want", [(1, True), (8, True), (16, True),
                                    (24, True), (48, True), (96, True),
                                    (128, True), (129, True), (160, True),
                                    (192, True), (256, True), (257, False),
                                    (512, False)])
def test_flash_eligible_takes_every_head_dim_up_to_256(d, want):
    assert tattn.flash_eligible((1, 4, 64, d), (1, 2, 64, d), True) is want
    # causal still needs Tq <= Tk, whatever the head dim
    assert not tattn.flash_eligible((1, 4, 65, d), (1, 2, 64, d), True)


def test_head_dim_above_256_raises_before_any_kernel():
    assert tattn.native_head_dim(160) == tattn.native_head_dim(256) == 256
    with pytest.raises(ValueError, match="head dims up to 256, got 257"):
        tattn.native_head_dim(257)
    with pytest.raises(ValueError, match="head dims up to 256"):
        tattn.padded_forward(tattn.flash_attention_reference,
                             *(torch.zeros(1, 1, 4, 257),) * 3, True, 1.0, 0)
    x, lse = torch.zeros(1, 1, 4, 257), torch.zeros(1, 1, 4, 1)
    with pytest.raises(ValueError, match="head dims up to 256"):
        tattn.padded_backward(tattn.flash_backward_reference, x, x, x, x,
                              lse, x, None, True, 1.0, 0)
