"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc, and skip without them. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

``chip_smoke.py`` holds the same kernels at the Llama-3-8B shape.
Tolerances, relative to each result's max abs: float32 1e-4 (both sides
sum exact float32 products, in another order); bf16 2e-2 (P and dS are
rounded to bf16 before their products and the gradients at the end; a
summation-order difference can flip either rounding by one bf16 ulp).
"""

import importlib

import pytest
import torch

# the module, not the ``attention`` function its package re-exports
tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(device, dtype, b, h, hkv, tq, tk, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (randn(b, h, tq, d), randn(b, hkv, tk, d), randn(b, hkv, tk, d),
            randn(b, h, tq, d), randn(b, h, tq, 1).float())


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


CASES = [
    # (B, H, Hkv, Tq, Tk, D), causal, window, with g_lse
    ((1, 4, 2, 256, 256, 128), True, 0, False),
    ((1, 4, 2, 256, 256, 128), True, 64, True),
    ((2, 4, 1, 128, 320, 64), False, 0, True),
    ((1, 4, 4, 100, 100, 128), True, 0, False),      # ragged
    ((1, 2, 1, 33, 77, 64), True, 0, True),          # ragged, Tq < Tk
    ((1, 2, 2, 200, 200, 128), True, 37, False),     # ragged window
]

# head dim 32 (one 32-column box with the 64-byte swizzle): the workload
# CLI's Llama shape (batch 256, T = seq_len - 1 = 255), entry()'s, a
# ragged window with GQA 4/1 and a causal Tq < Tk
D32_CASES = [
    ((256, 8, 4, 255, 255, 32), True, 0, False),
    ((2, 8, 4, 128, 128, 32), True, 0, True),
    ((1, 8, 2, 200, 200, 32), True, 37, True),
    ((1, 4, 1, 70, 333, 32), True, 0, False),
]

# head dim 16 (one 16-column box with the 32-byte swizzle; the reference's
# dry-run Llama) and head dims run padded to the next native one: 8 (the
# dry run's float32 legs) and 24 to 16 and 32, 48 to 64, 96 to 128
SMALL_D_CASES = [
    ((2, 4, 2, 17, 17, 16), True, 0, True),
    ((1, 8, 2, 300, 300, 16), True, 37, False),
    ((1, 4, 1, 70, 333, 16), False, 0, True),
    ((1, 4, 2, 256, 256, 8), True, 0, True),
    ((1, 4, 2, 200, 200, 24), True, 64, False),
    ((1, 4, 2, 128, 320, 48), False, 0, True),
    ((1, 8, 2, 256, 256, 96), True, 0, True),
]

# what the bf16 backward's design adds: more dk/dv items than SMs (2 * 8
# kv heads * 4 key tiles * 4 query heads = 256), a group of 8 query heads
# summed in order and a group of one written directly, a window narrower
# than a 64-row q tile, ragged T across a 128-key tile, D = 64 with
# causal Tq < Tk
BWD_CASES = CASES + [
    ((2, 32, 8, 512, 512, 128), True, 0, False),
    ((1, 8, 1, 256, 256, 128), True, 0, True),
    ((1, 8, 1, 300, 300, 64), False, 0, False),
    ((1, 4, 4, 256, 256, 128), True, 0, True),
    ((1, 4, 2, 256, 256, 128), True, 17, True),
    ((1, 8, 2, 200, 200, 128), True, 0, False),
    ((1, 4, 2, 100, 300, 64), True, 0, True),
] + D32_CASES + SMALL_D_CASES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,causal,window,use_glse", BWD_CASES)
def test_backward_kernels_match_plain_version(cuda, dtype, shape, causal,
                                              window, use_glse):
    b, h, hkv, tq, tk, d = shape
    q, k, v, do, g_lse = _inputs(cuda, dtype, b, h, hkv, tq, tk, d, 1)
    out, lse = tattn.flash_forward(q, k, v, causal, window=window)
    g_lse = g_lse if use_glse else None
    before = dict(tattn.LAUNCHES)
    got = tattn.flash_backward(q, k, v, out, lse, do, g_lse, causal,
                               window=window)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tattn.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = tattn.flash_backward_reference(q, k, v, out, lse, do, g_lse,
                                          causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= REL_TOL[dtype], (name, _rel(g, w))
    # no atomics: a second launch gives the same bits
    again = tattn.flash_backward(q, k, v, out, lse, do, g_lse, causal,
                                 window=window)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# the backward's cases, a 17-token prompt (one partly masked tile, as a
# short prefill gives it) and a B*H whose 256 blocks of 128 query rows
# take more than one wave of the card's SMs
FWD_CASES = [case[:3] for case in CASES] + [
    ((1, 8, 2, 17, 17, 128), True, 0),
    ((2, 32, 8, 512, 512, 128), True, 0),
] + [case[:3] for case in D32_CASES + SMALL_D_CASES]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,causal,window", FWD_CASES)
def test_forward_kernel_matches_plain_version(cuda, dtype, shape, causal,
                                              window):
    b, h, hkv, tq, tk, d = shape
    q, k, v, _, _ = _inputs(cuda, dtype, b, h, hkv, tq, tk, d, 2)
    before = tattn.LAUNCHES["flash_fwd"]
    out, lse = tattn.flash_forward(q, k, v, causal, window=window)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd"] == before + 1
    ref_out, ref_lse = tattn.flash_attention_reference(q, k, v, causal,
                                                       window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, tq, 1)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, ref_out) <= REL_TOL[dtype], _rel(out, ref_out)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    # no atomics: a second launch gives the same bits
    again, again_lse = tattn.flash_forward(q, k, v, causal, window=window)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


def test_forward_walks_the_host_work_list_from_any_stream(cuda):
    """The bf16 kernel takes its work list from the host: made once per
    shape (flash_forward_schedule dealt over the card's SMs), copied to
    the card, and read from whatever stream launches the kernel."""
    q, k, v, _, _ = _inputs(cuda, torch.bfloat16, 1, 4, 2, 300, 300, 128, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out, lse = tattn.flash_forward(q, k, v, True)
    torch.cuda.current_stream().wait_stream(side)
    work, blocks = tattn._forward_work_on(q.device, 4, 300, 300, True, 0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    schedule = tattn.flash_forward_schedule(4, 300, 300, True, 0, sms)
    assert blocks == len(schedule)
    assert work.dtype == torch.int32 and work.device == q.device
    assert work.tolist() == tattn.flash_work(schedule)
    assert tattn._forward_work_on(q.device, 4, 300, 300, True, 0)[0] is work
    ref_out, ref_lse = tattn.flash_attention_reference(q, k, v, True)
    assert _rel(out, ref_out) <= REL_TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_backward_from_a_side_stream(cuda):
    """The bf16 backward kernels read their host-built work lists, and dk/dv
    its counters and scratch, on whatever stream launches them; the lists
    on the card are the host schedules, made once per shape."""
    q, k, v, do, _ = _inputs(cuda, torch.bfloat16, 1, 8, 2, 300, 300, 128,
                             9)
    out, lse = tattn.flash_forward(q, k, v, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = dict(tattn.LAUNCHES)
    with torch.cuda.stream(side):
        got = tattn.flash_backward(q, k, v, out, lse, do)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tattn.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = tattn.flash_backward_reference(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL_TOL[torch.bfloat16]
    again = tattn.flash_backward(q, k, v, out, lse, do)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    work, blocks = tattn._backward_work_on(q.device, 2, 4, 300, 300, True, 0)
    schedule = tattn.flash_backward_schedule(2, 4, 300, 300, True, 0, sms)
    assert blocks == len(schedule)
    assert work.tolist() == tattn.flash_work(schedule)
    work, blocks = tattn._forward_work_on(q.device, 8, 300, 300, True, 0,
                                          tattn.FLASH_DQ_BLOCK_K)
    schedule = tattn.flash_forward_schedule(8, 300, 300, True, 0, sms,
                                            tattn.FLASH_DQ_BLOCK_K)
    assert work.tolist() == tattn.flash_work(schedule)


def test_autograd_launches_the_backward_kernels(cuda):
    """Through autograd, a non-contiguous dO (as a transposed output
    gives it) reaches the kernels; gradients match the plain backward."""
    q, k, v, _, _ = _inputs(cuda, torch.bfloat16, 1, 4, 2, 128, 128, 64, 3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(tattn.LAUNCHES)
    out = tattn.flash_attention(q, k, v, True)
    loss = out.transpose(1, 2).float().square().sum()
    dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
    assert tattn.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tattn.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    o, lse = tattn.flash_forward(q.detach(), k.detach(), v.detach(), True)
    want = tattn.flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                          o, lse, 2 * out.detach().float()
                                          .to(q.dtype), None, True)
    for g, w in zip((dq, dk, dv), want):
        assert _rel(g, w) <= REL_TOL[torch.bfloat16]


def test_head_dim_outside_the_kernels_raises(cuda):
    """Above 128 the wrappers raise before any launch, forward and
    backward alike."""
    q, k, v, do, _ = _inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 160, 4)
    out = torch.zeros_like(q)
    lse = torch.zeros(1, 2, 64, 1, device=cuda)
    before = dict(tattn.LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        tattn.flash_backward(q, k, v, out, lse, do)
    with pytest.raises(ValueError, match="head dims"):
        tattn.flash_forward(q, k, v)
    assert tattn.LAUNCHES == before


def test_mha_refuses_head_dim_outside_the_kernels(cuda):
    """On the card mha never drops to plain attention unasked: above
    128 it raises, and at 8 and 96 (padded) it launches the kernel."""
    for d in (8, 96):
        q, k, v, _, _ = _inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, d, 6)
        before = tattn.LAUNCHES["flash_fwd"]
        assert tattn.mha(q, k, v).shape == q.shape
        assert tattn.LAUNCHES["flash_fwd"] == before + 1
    q, k, v, _, _ = _inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 160, 6)
    with pytest.raises(ValueError, match="flash kernels do not take"):
        tattn.mha(q, k, v)
    assert tattn.mha(q, k, v, use_flash=False).shape == q.shape


def test_llama_loss_at_ragged_length_launches_every_kernel(cuda):
    """A trainer feeding seq_len = 2048 tokens gives the trunk T = 2047,
    which no tile divides: each layer still runs the forward, dq and
    dk/dv kernels once per step, and the gradients agree with plain
    attention's (5e-2 of each tensor's max abs, as chip_smoke.py holds
    them at 8B width)."""
    from kubeshare_tpu_torch.models.llama import (
        LlamaConfig, init_llama, llama_loss,
    )

    cfg = LlamaConfig(vocab=512, dim=256, layers=4, num_heads=4,
                      num_kv_heads=2, mlp_dim=512)
    model = init_llama(cfg, device=cuda, trainable=True)
    params = list(model.parameters())
    gen = torch.Generator(device=cuda).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                           device=cuda)
    for name in tattn.LAUNCHES:
        tattn.LAUNCHES[name] = 0
    got = torch.autograd.grad(llama_loss(model, tokens), params)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {"flash_fwd": 4, "flash_bwd_dq": 4,
                              "flash_bwd_dkv": 4}
    want = torch.autograd.grad(llama_loss(model, tokens, use_flash=False),
                               params)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= 5e-2


@pytest.mark.parametrize("window", [0, 64])
def test_llama_loss_at_head_dim_32_launches_every_kernel(cuda, window):
    """The workload CLI's Llama (dim 256, 8 heads: head dim 32) at its
    T = seq_len - 1 = 255: each layer runs the forward, dq and dk/dv
    kernels once per step, full causal or windowed, and the gradients
    agree with plain attention's (5e-2 of each tensor's max abs)."""
    from kubeshare_tpu_torch.models.llama import (
        LlamaConfig, init_llama, llama_loss,
    )

    cfg = LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                      num_kv_heads=4, mlp_dim=512, max_seq_len=256,
                      window=window)
    model = init_llama(cfg, device=cuda, trainable=True)
    params = list(model.parameters())
    gen = torch.Generator(device=cuda).manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (8, 256), generator=gen,
                           device=cuda)
    for name in tattn.LAUNCHES:
        tattn.LAUNCHES[name] = 0
    got = torch.autograd.grad(llama_loss(model, tokens), params)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {"flash_fwd": 4, "flash_bwd_dq": 4,
                              "flash_bwd_dkv": 4}
    want = torch.autograd.grad(llama_loss(model, tokens, use_flash=False),
                               params)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= 5e-2


def test_backward_refuses_mismatched_shapes(cuda):
    q, k, v, do, g_lse = _inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 64,
                                 5)
    out, lse = tattn.flash_forward(q, k, v, True)
    with pytest.raises(ValueError, match="shaped like q"):
        tattn.flash_backward(q, k, v, out, lse, do[:, :, :32])
    with pytest.raises(ValueError, match="shaped like q"):
        tattn.flash_backward(q, k, v, out, lse[:, :, :32], do)
    with pytest.raises(ValueError, match="shaped like q"):
        tattn.flash_backward(q, k, v, out, lse, do,
                             g_lse.expand(1, 2, 64, 64))
