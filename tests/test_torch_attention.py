"""kubeshare_tpu_torch/ops/attention.py against kubeshare_tpu/ops/attention.py.

The same numpy inputs go through the JAX function (its Pallas flash
kernel in interpret mode, as tests/test_models_ops.py runs it) and the
port's counterpart on the CPU (where the flash wrapper runs the
kernel's plain version). float32 is held to 1e-5; bf16 to 2e-2 (about
two bf16 ulps at |out| < 2: the frameworks round P and the output at
the same places but sum in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the ``attention`` functions their packages re-export
jattn = importlib.import_module("kubeshare_tpu.ops.attention")
tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _qkv(seed, b=1, h=4, hkv=2, tq=64, tk=None, d=32):
    rng = np.random.default_rng(seed)
    tk = tk or tq
    q = rng.standard_normal((b, h, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    return q, k, v


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal,window,hkv,tq,tk", [
    (True, 0, 4, 64, 64),      # causal MHA
    (False, 0, 4, 64, 64),     # non-causal
    (True, 0, 2, 64, 64),      # GQA 4/2
    (True, 16, 2, 64, 64),     # sliding window
    (False, 0, 1, 48, 80),     # non-causal, Tq != Tk, MQA
    (True, 0, 2, 48, 80),      # causal rows aligned to the end of the keys
])
def test_attention_matches_jax_f32(causal, window, hkv, tq, tk):
    q, k, v = _qkv(0, hkv=hkv, tq=tq, tk=tk)
    want = jattn.attention(*_jax(q, k, v), causal=causal, window=window)
    got = tattn.attention(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)


def test_attention_matches_jax_bf16():
    q, k, v = _qkv(1)
    want = jattn.attention(*_jax(q, k, v, dtype=jnp.bfloat16), causal=True)
    got = tattn.attention(*_torch(q, k, v, dtype=torch.bfloat16),
                          causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_flash_with_lse_matches_jax_interpret(causal, window):
    """The port's flash_attention_with_lse on the CPU (the kernel's plain
    version) against the JAX Pallas kernel in interpret mode, T=256,
    blocks of 128, GQA 4/2: out and lse."""
    q, k, v = _qkv(2, tq=256, d=64)
    want_out, want_lse = jattn.flash_attention_with_lse(
        *_jax(q, k, v), causal, None, 128, 128, True, window)
    got_out, got_lse = tattn.flash_attention_with_lse(
        *_torch(q, k, v), causal, window=window)
    assert got_lse.shape == (1, 4, 256, 1) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,hkv", [
    (True, 0, 4),              # causal MHA
    (False, 0, 2),             # non-causal, GQA 4/2
    (True, 64, 2),             # sliding window, GQA 4/2
    (True, 0, 1),              # MQA
])
def test_flash_head_dim_32_matches_jax_interpret(causal, window, hkv, dtype):
    """Head dim 32, the reference's own Llama (dim 256, 8 heads): out and
    lse of the port's plain version against the JAX Pallas kernel in
    interpret mode, T=256, blocks of 128. bf16 out to 2e-2, lse to 1e-4
    (float32 in both)."""
    q, k, v = _qkv(9 + hkv, hkv=hkv, tq=256, d=32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_out, want_lse = jattn.flash_attention_with_lse(
        *_jax(q, k, v, dtype=jdt), causal, None, 128, 128, True, window)
    got_out, got_lse = tattn.flash_attention_with_lse(
        *_torch(q, k, v, dtype=tdt), causal, window=window)
    assert got_out.dtype == tdt and got_lse.dtype == torch.float32
    out_tol, lse_tol = (F32_TOL, F32_TOL) if dtype == "float32" else (
        BF16_TOL, 1e-4)
    np.testing.assert_allclose(got_out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               atol=out_tol, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=lse_tol, rtol=0)


@pytest.mark.parametrize("causal,window,tq,tk", [
    (True, 0, 200, 200),       # ragged: no tile divides T
    (True, 37, 200, 200),      # ragged with a window
    (False, 0, 70, 333),       # ragged, Tq != Tk
    (True, 0, 70, 333),        # causal, Tq < Tk
])
def test_flash_reference_takes_ragged_shapes(causal, window, tq, tk):
    """Shapes the reference kernel refuses but the CUDA kernel (and so
    its plain version) takes: held against plain attention, and the lse
    against a direct logsumexp of the masked scores."""
    q, k, v = _torch(*_qkv(3, tq=tq, tk=tk, d=64))
    out, lse = tattn.flash_attention_reference(q, k, v, causal,
                                               window=window)
    want = tattn.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=F32_TOL,
                               rtol=0)
    kr, _ = tattn._repeat_kv(k, v, 4)
    scores = torch.matmul(q, kr.transpose(-1, -2)) * 64 ** -0.5
    if causal:
        q_pos = torch.arange(tq)[:, None] + tk - tq
        k_pos = torch.arange(tk)[None, :]
        visible = k_pos <= q_pos
        if window:
            visible &= k_pos > q_pos - window
        scores = scores.masked_fill(~visible, float("-inf"))
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(scores, -1, keepdim=True).numpy(),
        atol=F32_TOL, rtol=0)


def test_flash_reference_bf16_matches_jax_interpret():
    q, k, v = _qkv(4, tq=256, d=64)
    want_out, want_lse = jattn.flash_attention_with_lse(
        *_jax(q, k, v, dtype=jnp.bfloat16), True, None, 128, 128, True)
    got_out, got_lse = tattn.flash_attention_with_lse(
        *_torch(q, k, v, dtype=torch.bfloat16), True)
    assert got_out.dtype == torch.bfloat16
    np.testing.assert_allclose(got_out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("tq,tk,causal", [
    (128, 128, True), (256, 256, True), (384, 384, True), (640, 640, True),
    (100, 100, True), (200, 200, True), (128, 256, True), (128, 256, False),
    (1024, 1536, False), (64, 64, True), (2048, 2048, True),
])
def test_flash_eligible_covers_the_reference_rule(tq, tk, causal):
    """The CUDA kernels take every shape the reference's flash kernel
    takes, and also the ragged and short ones it refuses: causal needs
    only Tq <= Tk."""
    q_shape, k_shape = (1, 1, tq, 64), (1, 1, tk, 64)
    got = tattn.flash_eligible(q_shape, k_shape, causal)
    if tq >= 128 and jattn.flash_shapes_ok(q_shape, k_shape, causal):
        assert got
    assert got is (not causal or tq <= tk)


def test_mha_dispatch_rule(monkeypatch):
    """mha sends CUDA tensors to the flash kernels (``flash_eligible``
    decides nothing on the CPU): on the CPU it runs plain attention
    unless asked for flash."""
    calls = []
    real = tattn.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    q, k, v = _torch(*_qkv(5, tq=128, d=64))
    out = tattn.mha(q, k, v)                       # CPU: never flash
    assert calls == []
    np.testing.assert_array_equal(out.numpy(),
                                  tattn.attention(q, k, v).numpy())
    forced = tattn.mha(q, k, v, use_flash=True)    # forced: plain version
    assert len(calls) == 1
    np.testing.assert_allclose(forced.numpy(), out.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("q_shape,k_shape,causal,want", [
    ((1, 4, 128, 128), (1, 2, 128, 128), True, True),
    ((1, 4, 2047, 128), (1, 2, 2047, 128), True, True),   # llama_loss's T
    ((1, 4, 1, 128), (1, 2, 1, 128), True, True),         # one row
    ((1, 4, 200, 64), (1, 2, 200, 64), True, True),       # no tile divides
    ((1, 4, 333, 128), (1, 2, 777, 128), True, True),     # causal Tq < Tk
    ((1, 4, 777, 128), (1, 2, 333, 128), True, False),    # causal Tq > Tk
    ((1, 4, 777, 128), (1, 2, 333, 128), False, True),
    ((1, 4, 256, 96), (1, 2, 256, 96), True, True),       # 96: padded
    ((1, 4, 256, 16), (1, 2, 256, 16), True, True),       # head dim 16
    ((1, 4, 256, 8), (1, 2, 256, 8), True, True),         # 8: padded
    ((1, 4, 256, 257), (1, 2, 256, 257), True, False),    # over 256
    ((1, 4, 256, 32), (1, 2, 256, 32), False, True),      # head dim 32
    ((1, 8, 256, 256), (1, 1, 256, 256), True, True),     # head dim 256
    ((1, 4, 256, 160), (1, 2, 256, 160), True, True),     # 160: padded
])
def test_flash_eligible_is_what_the_kernels_take(q_shape, k_shape, causal,
                                                 want):
    assert tattn.flash_eligible(q_shape, k_shape, causal) is want


def test_flash_backward_matches_plain_autograd():
    """On CPU tensors the flash backward runs the kernels' plain
    version, whose gradients equal autograd's through plain
    attention."""
    q, k, v = (t.requires_grad_(True) for t in _torch(*_qkv(6, tq=32, d=32)))
    out = tattn.flash_attention(q, k, v, True)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    plain = tattn.attention(q, k, v, causal=True)
    want = torch.autograd.grad(plain.square().sum(), (q, k, v))
    for g, w in zip(got, want):   # gradients reach ~10: F32_TOL relative
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=F32_TOL * w.abs().max().item(),
                                   rtol=0)


def test_flash_wrapper_validates_and_counts_only_kernel_launches():
    q, k, v = _torch(*_qkv(7, tq=32, d=32))
    before = dict(tattn.LAUNCHES)
    tattn.flash_forward(q, k, v, True)
    assert tattn.LAUNCHES == before        # CPU: plain version, no launch
    with pytest.raises(ValueError, match="window requires causal"):
        tattn.flash_forward(q, k, v, False, window=8)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        tattn.flash_forward(q, k[:, :, :16], v[:, :, :16], True)
    with pytest.raises(ValueError, match="multiple"):
        tattn.flash_forward(q[:, :3], k, v, True)
    with pytest.raises(ValueError, match="no flash attention"):
        tattn.flash_forward(*(t.to("meta") for t in (q, k, v)), True)


def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version (chip_smoke.py runs the
    full set of shapes). Needs a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = (t.cuda() for t in _torch(*_qkv(8, tq=200, d=128)))
    out, lse = tattn.flash_forward(q, k, v, True, window=50)
    ref_out, ref_lse = tattn.flash_attention_reference(q, k, v, True,
                                                       window=50)
    torch.testing.assert_close(out, ref_out, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=F32_TOL, rtol=0)
