"""Head dims above 128: the port's flash path against
kubeshare_tpu/ops/attention.py at D in {160, 192, 256}, and a small Llama
at D = 256 against kubeshare_tpu/models/llama.py.

The reference's flash path takes any head dim; the port's kernels have a
D = 256 instance, and 160 and 192 run it on zero-padded inputs
(``padded_forward``, ``padded_backward`` in ``ops/attention.py``). Here on
the CPU:

- the port's plain versions (``flash_attention_reference``,
  ``flash_backward_reference``, reached through
  ``flash_attention_with_lse`` on CPU tensors) against the reference's
  ``flash_attention_with_lse`` and its ``jax.vjp`` (Pallas in interpret
  mode, blocks of 128), with an lse cotangent, in float32 and bf16,
  under the four masks of tests/test_torch_head_dims.py; 8 query heads
  over one kv head at D = 256 (Gemma-2B's grouping), 4 over 2 at 160 and
  192; a causal Tq < Tk, which the reference's flash refuses, against the
  reference's plain ``attention`` and its ``jax.vjp``;
- the padding: 160 and 192 padded to 256 change nothing;
- the tiles: at D = 256 the CUDA wrappers build their work lists and the
  dk/dv scratch with that instance's tiles (``flash_tiles``), checked
  here with the kernel call itself replaced, and the lists at those
  tiles cover every item once with the right key or row ranges (the
  dk/dv group sum's waits always finish);
- a Llama at Gemma-2B's head dim cut small (vocab 512, dim 512, 2 heads
  over 1 kv head, 2 layers, mlp 1024, T 128, float32), its weights carried
  across by ``models/convert.py::llama_from_jax``: the logits of the
  port's flash path against the reference's ``llama_apply`` through its
  flash kernel, and the port's ``llama_loss`` gradients against
  ``jax.grad`` of the reference's ``llama_loss`` with its flash kernel as
  the attention core.

Tolerances (those of tests/test_torch_head_dims.py): float32 out and lse
1e-5 abs, gradients 1e-4 of each gradient's max abs (exact float32
products summed in another order); bf16 2e-2 of each tensor's max abs (P
and dS rounded to bf16 before their products; a summation-order
difference flips a rounding by one bf16 ulp, 2^-8). The padding check:
float32 1e-6 of the max abs, bf16 4e-3 (one bf16 ulp of the largest
entry). The Llama: logits 1e-5 abs, gradients 1e-4 of each gradient's max
abs (the same float32 math in another order).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models.convert import llama_from_jax, llama_to_jax

jattn = importlib.import_module("kubeshare_tpu.ops.attention")
tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")
jllama = importlib.import_module("kubeshare_tpu.models.llama")
tllama = importlib.import_module("kubeshare_tpu_torch.models.llama")

HEAD_DIMS = (160, 192, 256)
DTYPES = ("float32", "bfloat16")
# (causal, window, Tq, Tk)
MASKS = {
    "causal": (True, 0, 128, 128),
    "window": (True, 48, 128, 128),
    "full": (False, 0, 128, 128),
    "causal_tq_lt_tk": (True, 0, 64, 128),
}
# (query heads, kv heads) at each head dim
HEADS = {160: (4, 2), 192: (4, 2), 256: (8, 1)}
BLOCK = 128
F32_OUT_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 2e-2
PAD_TOL = {"float32": 1e-6, "bfloat16": 4e-3}
LOGIT_TOL = 1e-5
LLAMA_GRAD_TOL = 1e-4

JCFG = jllama.LlamaConfig(
    vocab=512, dim=512, layers=2, num_heads=2, num_kv_heads=1,
    mlp_dim=1024, max_seq_len=256, rope_theta=10000.0, dtype="float32",
)


def _inputs(seed, d, tq, tk, h, hkv):
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
def test_flash_at_wide_head_dim_matches_the_reference(d, dtype, mask):
    causal, window, tq, tk = MASKS[mask]
    q, k, v, do, g_lse = _inputs(300 + d, d, tq, tk, *HEADS[d])
    want = _reference(q, k, v, do, g_lse, dtype, causal, window)
    with_lse = want[1] is not None
    got = _port(q, k, v, do, g_lse if with_lse else None, dtype, causal,
                window)
    names = ("out", "lse", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        assert g.shape == _np(w).shape, name
        assert g.shape[-1] == (1 if name == "lse" else d), name
        if dtype == "bfloat16":
            err, tol = _rel(g, w), BF16_TOL
        elif name in ("out", "lse"):
            err, tol = np.abs(_np(g) - _np(w)).max(), F32_OUT_TOL
        else:
            err, tol = _rel(g, w), F32_GRAD_TOL
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", (160, 192))
def test_padding_to_256_changes_nothing(d, dtype):
    """pad -> plain -> slice equals plain at D, forward and backward
    (with an lse cotangent), through the wrappers the CUDA route uses."""
    assert tattn.native_head_dim(d) == 256
    causal, window = True, 48
    q, k, v, do, g_lse = (torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in _inputs(400 + d, d, 96, 128, 4, 2))
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


@pytest.mark.parametrize("d,want", [
    (64, (128, 64, 128)),
    (128, (128, 64, 128)),
    (129, (64, 32, 64)),
    (192, (64, 32, 64)),
    (256, (64, 32, 64)),
])
def test_flash_tiles_follow_the_native_head_dim(d, want):
    assert dataclasses.astuple(tattn.flash_tiles(d)) == want
    with pytest.raises(ValueError, match="head dims up to 256"):
        tattn.flash_tiles(257)


@pytest.mark.parametrize("d", (64, 128, 192, 256))
def test_the_wrappers_build_work_with_the_instances_tiles(monkeypatch, d):
    """The bf16 wrappers' work lists and dk/dv scratch, recorded with the
    library call replaced (no card here): the forward's list with
    ``fwd_k``-key tiles, dq's with ``dq_k``, dk/dv's with ``dkv_k``, and a
    scratch of two float32 ``dkv_k`` x D partials a (kv head, key tile),
    D the native head dim (192 runs padded to 256)."""
    calls, launched = [], []

    def work(kind):
        def made(device, *args):
            calls.append((kind, args))
            return torch.zeros(1, dtype=torch.int32), 7
        return made

    monkeypatch.setattr(tattn, "_forward_work_on", work("forward"))
    monkeypatch.setattr(tattn, "_backward_work_on", work("backward"))
    monkeypatch.setattr(tattn, "_bind", lambda *args, **kwargs: None)
    monkeypatch.setattr(tattn, "_launch", lambda name, fn, q, k, ptrs, *a:
                        launched.append((name, ptrs, a)))
    tiles, native = tattn.flash_tiles(d), tattn.native_head_dim(d)
    q, do = (torch.zeros(1, 8, 300, d, dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.zeros(1, 2, 300, d, dtype=torch.bfloat16)
            for _ in range(2))
    out, lse = tattn.padded_forward(tattn._flash_forward_cuda, q, k, v,
                                    True, d ** -0.5, 0)
    assert out.shape == q.shape and lse.shape == (1, 8, 300, 1)
    grads = tattn.padded_backward(tattn._flash_backward_cuda, q, k, v, out,
                                  lse.zero_(), do, None, True, d ** -0.5, 0)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert calls == [("forward", (8, 300, 300, True, 0, tiles.fwd_k)),
                     ("forward", (8, 300, 300, True, 0, tiles.dq_k)),
                     ("backward", (2, 4, 300, 300, True, 0, tiles.dkv_k))]
    assert [name for name, _, _ in launched] == [
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    assert all(a[-1] == 7 for _, _, a in launched)   # the blocks
    scratch, counters = launched[2][1][-2:]
    n_tiles = 2 * -(-300 // tiles.dkv_k)
    assert counters.shape == (n_tiles,) and not counters.any()
    assert scratch.numel() == n_tiles * 2 * tiles.dkv_k * native
    assert scratch.dtype == torch.float32


def _port_llama(trainable):
    params = jax.tree.map(np.asarray,
                          jllama.init_llama(jax.random.PRNGKey(3), JCFG))
    cfg = tllama.LlamaConfig(**dataclasses.asdict(JCFG))
    return params, llama_from_jax(params, cfg, device="cpu",
                                  trainable=trainable)


def test_llama_at_head_dim_256_logits_match_the_reference():
    params, model = _port_llama(trainable=False)
    assert JCFG.dim // JCFG.num_heads == 256
    tokens = np.random.default_rng(5).integers(0, JCFG.vocab, (1, 128))
    want = jax.jit(jllama.llama_apply, static_argnames=("cfg", "use_flash"))(
        params, jnp.asarray(tokens), cfg=JCFG, use_flash=True)
    with torch.no_grad():
        got = tllama.llama_apply(model, torch.from_numpy(tokens),
                                 use_flash=True)
    assert got.shape == (1, 128, JCFG.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def test_llama_at_head_dim_256_grads_match_the_reference():
    params, model = _port_llama(trainable=True)
    tokens = np.random.default_rng(6).integers(0, JCFG.vocab, (1, 129))

    def core(q, k, v):   # the reference's flash kernel, interpret mode
        return jattn.flash_attention(q, k, v, True, None, BLOCK, BLOCK,
                                     True)

    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, t: jllama.llama_loss(p, t, JCFG, attn_fn=core)))(
            params, jnp.asarray(tokens))
    loss = tllama.llama_loss(model, torch.from_numpy(tokens),
                             use_flash=True)
    loss.backward()
    got = llama_to_jax(model, grads=True)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in want_leaves] == [p for p, _ in got_leaves]
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g) - w).max() / np.abs(w).max()
        assert err <= LLAMA_GRAD_TOL, (jax.tree_util.keystr(path), err)


# (B*H or B*Hkv, reps, Tq, Tk, causal, window, SMs) for the D = 256 work
# lists: Gemma-2B's grouping at its T and longer, ragged T, a window, a
# full mask with Tq < Tk, a small card
D256_SHAPES = [
    (1, 8, 2048, 2048, True, 0, 132),
    (1, 8, 4096, 4096, True, 0, 132),
    (2, 4, 300, 300, True, 37, 132),
    (2, 4, 128, 320, False, 0, 132),
    (1, 8, 1000, 1000, True, 100, 7),
]


def _keys_of(row, t_q, t_k, causal, window):
    """[first, last] of the keys query ``row`` sees."""
    if not causal:
        return 0, t_k - 1
    pos = row + t_k - t_q
    return (max(0, pos - window + 1) if window > 0 else 0), min(pos, t_k - 1)


@pytest.mark.parametrize("bkv,reps,t_q,t_k,causal,window,sms", D256_SHAPES)
def test_head_dim_256_dkv_work_list(bkv, reps, t_q, t_k, causal, window,
                                    sms):
    """The dk/dv list at D = 256's 64-key items: every (kv head, key tile,
    query head) once, each item's q rows covering the rows that see its
    keys and no q tile none of them sees, each block's items in list
    order, and a run of the group sum's waits that always finishes."""
    bk, bq = tattn.flash_tiles(256).dkv_k, tattn.FLASH_DKV_BLOCK_Q
    blocks = tattn.flash_backward_schedule(bkv, reps, t_q, t_k, causal,
                                           window, sms, bk)
    items = [it for block in blocks for it in block]
    assert sorted(it[:3] for it in items) == sorted(
        (b, k0, r) for b in range(bkv) for k0 in range(0, t_k, bk)
        for r in range(reps))
    seen_by = {}
    for r in range(t_q):
        first, last = _keys_of(r, t_q, t_k, causal, window)
        for k0 in range(first - first % bk, last + 1, bk):
            seen_by.setdefault(k0, []).append(r)
    for _, k0, _, lo, hi in items:
        rows = seen_by.get(k0, [])
        if not rows:
            assert lo == hi == 0
            continue
        assert lo % bq == 0 and lo <= rows[0] and hi == rows[-1] + 1
        assert all(any(r0 <= r < r0 + bq for r in rows)
                   for r0 in range(lo, hi, bq))
    done, at = set(), [0] * len(blocks)
    while any(at[b] < len(block) for b, block in enumerate(blocks)):
        moved = False
        for b, block in enumerate(blocks):
            if at[b] < len(block):
                key, r = block[at[b]][:2], block[at[b]][2]
                if r == 0 or (*key, r - 1) in done:
                    done.add((*key, r))
                    at[b] += 1
                    moved = True
        assert moved, "the group sum's waits deadlock"


@pytest.mark.parametrize("kernel", ["fwd_k", "dq_k"])
@pytest.mark.parametrize("bkv,reps,t_q,t_k,causal,window,sms", D256_SHAPES)
def test_head_dim_256_forward_and_dq_work_lists(bkv, reps, t_q, t_k, causal,
                                                window, sms, kernel):
    """The forward's and dq's lists at D = 256's key tiles: every (head,
    128-row q tile) once, each item's keys from its tile's first visible
    key, aligned down to the tile, to one past its last."""
    bk = getattr(tattn.flash_tiles(256), kernel)
    bh, bq = bkv * reps, tattn.FLASH_FWD_BLOCK_Q
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms,
                                          bk)
    items = [it for block in blocks for it in block]
    assert sorted(it[:2] for it in items) == sorted(
        (h, q0) for h in range(bh) for q0 in range(0, t_q, bq))
    for _, q0, lo, hi in items:
        spans = [_keys_of(r, t_q, t_k, causal, window)
                 for r in range(q0, min(q0 + bq, t_q))]
        first, last = min(f for f, _ in spans), max(la for _, la in spans)
        assert lo == first - first % bk and hi == last + 1
