"""The port's training path (models/llama.py ``llama_loss``, models/train.py,
models/convert.py ``llama_to_jax``) against the JAX package at a small
size.

The JAX parameter tree (``init_llama`` from a fixed key) is carried into
a trainable port model with ``llama_from_jax(..., trainable=True)``; the
same numpy tokens go through ``jax.value_and_grad(llama_loss)`` and the
port's ``llama_loss`` under autograd, and the port's gradients come back
in the reference's layout through ``llama_to_jax(model, grads=True)``.

Tolerances, on the max abs difference relative to each leaf's max abs:
float32 loss 1e-5 and gradients 1e-5 (the same float32 math, summed in
another order); bf16 loss 1e-3 and gradients 5e-2 (bf16 rounds the
activations at other places in the two frameworks: a few bf16 ulps,
2^-8 each, carried through two layers). Adam parameters after three
steps at lr 1e-3: 1e-5 absolute (the steps move them by ~3e-3), except
on at most 0.1 % of a leaf's elements, held to 3 lr: Adam divides each
element's gradient by its own RMS, so where a gradient is near zero the
summation-order noise of the two frameworks can move that element's
update by up to lr per step.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import quant as jquant
from kubeshare_tpu_torch.models.convert import llama_from_jax, llama_to_jax

jllama = importlib.import_module("kubeshare_tpu.models.llama")
jtrain = importlib.import_module("kubeshare_tpu.models.train")
tllama = importlib.import_module("kubeshare_tpu_torch.models.llama")
ttrain = importlib.import_module("kubeshare_tpu_torch.models.train")

JCFG = jllama.LlamaConfig(
    vocab=256, dim=64, layers=2, num_heads=4, num_kv_heads=2,
    mlp_dim=128, max_seq_len=64, dtype="float32",
)
JPARAMS = jllama.init_llama(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
TOL = {"float32": {"loss": 1e-5, "grad": 1e-5},
       "bfloat16": {"loss": 1e-3, "grad": 5e-2}}


@functools.partial(jax.jit, static_argnums=(2, 3))
def j_value_and_grad(params, tokens, cfg, vocab_chunk):
    return jax.value_and_grad(jllama.llama_loss)(params, tokens, cfg,
                                                 vocab_chunk)


def port_model(jcfg=JCFG, params=NP_PARAMS, trainable=True):
    cfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    return llama_from_jax(params, cfg, device="cpu", trainable=trainable)


def tokens(seed, batch=2, seq=17):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq))


def leaf_pairs(want, got):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in want_leaves] == [p for p, _ in got_leaves]
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        yield jax.tree_util.keystr(path), np.asarray(w, np.float32), g


def rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def port_value_and_grad(model, toks, vocab_chunk=0, **kwargs):
    loss = tllama.llama_loss(model, torch.from_numpy(toks), vocab_chunk,
                             **kwargs)
    loss.backward()
    return loss.item(), llama_to_jax(model, grads=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_chunk", [0, 96])   # 256 = 2 * 96 + 64
def test_llama_loss_and_grads_match_jax(vocab_chunk, dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    toks = tokens(1)
    want_loss, want_grads = j_value_and_grad(JPARAMS, jnp.asarray(toks),
                                             jcfg, vocab_chunk)
    loss, grads = port_value_and_grad(port_model(jcfg), toks, vocab_chunk)
    tol = TOL[dtype]
    assert abs(loss - float(want_loss)) <= tol["loss"] * float(want_loss)
    for path, w, g in leaf_pairs(want_grads, grads):
        assert rel(g, w) <= tol["grad"], (path, rel(g, w))


@pytest.mark.parametrize("window,use_flash", [(8, None), (0, True)])
def test_grads_through_window_and_flash_match_jax(window, use_flash):
    """A sliding-window config, and attention forced through the flash
    functions (on the CPU: the kernels' plain forward and backward)."""
    jcfg = dataclasses.replace(JCFG, window=window)
    toks = tokens(2)
    want_loss, want_grads = j_value_and_grad(JPARAMS, jnp.asarray(toks),
                                             jcfg, 0)
    loss, grads = port_value_and_grad(port_model(jcfg), toks,
                                      use_flash=use_flash)
    assert abs(loss - float(want_loss)) <= 1e-5 * float(want_loss)
    for path, w, g in leaf_pairs(want_grads, grads):
        assert rel(g, w) <= 1e-5, (path, rel(g, w))


@pytest.mark.parametrize("vocab_chunk", [0, 96])
def test_remat_gives_identical_bits(vocab_chunk):
    toks = tokens(3)
    plain = port_value_and_grad(port_model(), toks, vocab_chunk)
    remat = port_value_and_grad(port_model(), toks, vocab_chunk, remat=True)
    assert plain[0] == remat[0]
    for path, w, g in leaf_pairs(plain[1], remat[1]):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_quantized_weights_are_refused():
    model = port_model(params=jax.tree.map(np.asarray,
                                           jquant.quantize_llama(JPARAMS)),
                       trainable=False)
    with pytest.raises(ValueError, match="inference-only"):
        tllama.llama_loss(model, torch.from_numpy(tokens(4)))
    with pytest.raises(ValueError, match="cannot be trained"):
        port_model(params=jax.tree.map(np.asarray,
                                       jquant.quantize_llama(JPARAMS)))


def test_three_adam_steps_match_optax():
    toks = tokens(5)
    opt, run = jtrain.make_train_step(
        lambda p, t: jllama.llama_loss(p, t, JCFG), learning_rate=1e-3)
    params, state = JPARAMS, opt.init(JPARAMS)
    model = port_model()
    topt, step = ttrain.make_train_step(
        lambda m, t: tllama.llama_loss(m, t), model, learning_rate=1e-3)
    assert isinstance(topt, torch.optim.Adam)
    assert topt.defaults["betas"] == (0.9, 0.999)
    assert topt.defaults["eps"] == 1e-8
    for _ in range(3):
        params, state, want = run(params, state, jnp.asarray(toks))
        got = step(torch.from_numpy(toks))
        assert abs(got.item() - float(want)) <= 1e-5 * float(want)
    assert all(p.grad is None for p in model.parameters())
    for path, w, g in leaf_pairs(params, llama_to_jax(model)):
        diff = np.abs(g - w)
        assert diff.max() <= 3e-3, path
        assert (diff > 1e-5).mean() <= 1e-3, (path, (diff > 1e-5).sum())
    moved = [np.abs(np.asarray(a) - b).max()
             for _, a, b in leaf_pairs(params, NP_PARAMS)]
    assert max(moved) > 1e-3


def test_accumulated_grads_match_the_full_batch():
    toks = torch.from_numpy(tokens(6, batch=4))

    def loss_fn(m, t):
        return tllama.llama_loss(m, t)

    model = port_model()
    full_loss, full = ttrain.accumulated_value_and_grad(loss_fn, 1)(
        model, (toks,))
    acc_loss, acc = ttrain.accumulated_value_and_grad(loss_fn, 2)(
        model, (toks,))
    assert abs(acc_loss.item() - full_loss.item()) <= 1e-5
    for a, f in zip(acc, full):
        assert a.dtype == f.dtype == torch.float32
        torch.testing.assert_close(a, f, atol=1e-5 * f.abs().max().item(),
                                   rtol=0)


def test_uneven_accumulation_batch_is_refused():
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        ttrain.accumulated_value_and_grad(lambda m, t: 0, 0)
    batch = (torch.zeros(3, 5, dtype=torch.int64),)
    ttrain.check_accum_batch(batch, 1)
    ttrain.check_accum_batch(batch, 3)
    with pytest.raises(ValueError, match="divisible by accum_steps=2"):
        ttrain.check_accum_batch(batch, 2)
    model = port_model()
    _, step = ttrain.make_train_step(lambda m, t: tllama.llama_loss(m, t),
                                     model, accum_steps=2)
    with pytest.raises(ValueError, match="divisible"):
        step(*batch)


def test_llama_to_jax_round_trips_exactly():
    tree = llama_to_jax(port_model())
    for path, w, g in leaf_pairs(NP_PARAMS, tree):
        np.testing.assert_array_equal(g, w, err_msg=path)
    inference = port_model(dataclasses.replace(JCFG, dtype="bfloat16"),
                           trainable=False)
    assert not any(p.requires_grad for p in inference.parameters())
    assert inference.layers[0].wq.dtype == torch.bfloat16
    trainable = port_model(dataclasses.replace(JCFG, dtype="bfloat16"))
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in trainable.parameters())


def test_init_llama_trainable_and_synthetic_batches():
    cfg = tllama.LlamaConfig(**dataclasses.asdict(
        dataclasses.replace(JCFG, dtype="bfloat16")))
    model = tllama.init_llama(cfg, torch.Generator().manual_seed(0), "cpu",
                              trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    ref = tllama.init_llama(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(model.layers[0].w_up.to(torch.bfloat16),
                       ref.layers[0].w_up)
    a = list(ttrain.synthetic_batches(torch.Generator().manual_seed(7),
                                      (2, 9), vocab=256, count=3))
    b = list(ttrain.synthetic_batches(torch.Generator().manual_seed(7),
                                      (2, 9), vocab=256, count=3))
    assert len(a) == 3 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x.dtype == torch.int64 and 0 <= x.min() and x.max() < 256
               for x in a)
    floats = next(ttrain.synthetic_batches(torch.Generator().manual_seed(7),
                                           (4, 3)))
    assert floats.dtype == torch.float32 and floats.shape == (4, 3)


def test_adam_state_made_before_the_first_update_keeps_it():
    """A graphed step creates Adam's state before its capture
    (``init_adam_state``): the update after it is a fresh Adam's first,
    bit for bit, and the next ones follow as they would."""
    cfg = dataclasses.replace(tllama.LlamaConfig(**dataclasses.asdict(JCFG)),
                              dtype="float32")
    batch = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9)))
    models = [tllama.init_llama(cfg, device="cpu", trainable=True)
              for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3) for m in models]
    ttrain.init_adam_state(opts[1])
    assert all(state["step"] == 0 for state in opts[1].state.values())
    for model, opt in zip(models, opts):
        _, step = ttrain.make_train_step(tllama.llama_loss, model,
                                         optimizer=opt, cuda_graph=True)
        assert not hasattr(step, "inputs")     # no CUDA graph on the CPU
        for _ in range(2):
            step(batch)
    for a, b in zip(*(m.parameters() for m in models)):
        assert torch.equal(a, b)
    assert all(state["step"] == 2 for state in opts[1].state.values())
    with pytest.raises(ValueError, match="Adam"):
        ttrain.init_adam_state(torch.optim.SGD(models[0].parameters(), 0.1))
