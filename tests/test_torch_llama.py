"""kubeshare_tpu_torch/models/{common,quant,llama,convert}.py against the
JAX package at a small size.

The JAX parameter tree (``init_llama`` from a fixed key) is carried into
the port with ``llama_from_jax``; the same numpy tokens go through both.
float32 configs are held to 1e-4 on the logits; bf16 configs to 2e-2 of
the logits' max abs (bf16 rounds at other places in the two frameworks).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import common as jcommon
from kubeshare_tpu.models import quant as jquant
from kubeshare_tpu_torch.models import common as tcommon
from kubeshare_tpu_torch.models import quant as tquant
from kubeshare_tpu_torch.models.convert import llama_from_jax

jllama = importlib.import_module("kubeshare_tpu.models.llama")
tllama = importlib.import_module("kubeshare_tpu_torch.models.llama")

LOGIT_TOL = 1e-4
BF16_REL_TOL = 2e-2

JCFG = jllama.LlamaConfig(
    vocab=256, dim=64, layers=2, num_heads=4, num_kv_heads=2,
    mlp_dim=128, max_seq_len=64, dtype="float32",
)
JPARAMS = jllama.init_llama(jax.random.PRNGKey(0), JCFG)
# the reference's entry points, jitted once per shape (eager JAX
# dispatches every op and takes seconds per call)
j_apply = jax.jit(jllama.llama_apply, static_argnames=("cfg", "use_flash"))
j_cached = jax.jit(jllama.llama_apply_cached, static_argnames="cfg")
j_prefill_slot = jax.jit(jllama.prefill_slot, static_argnames="cfg")
j_generate = jax.jit(jllama.llama_generate, static_argnums=(2, 3))


def port_cfg(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(jcfg=JCFG, params=JPARAMS):
    return llama_from_jax(to_numpy(params), port_cfg(jcfg), device="cpu")


def tokens(seed, batch, seq, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int64)


def close(got, want, atol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


class TestPrimitives:
    def test_rmsnorm_matches(self):
        x = np.random.default_rng(0).standard_normal((3, 5, 64),
                                                     dtype=np.float32)
        scale = np.linspace(0.5, 1.5, 64, dtype=np.float32)
        want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        got = tcommon.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x))
        close(got, want, 1e-6)

    def test_embed_matches(self):
        table = np.random.default_rng(2).standard_normal((10, 8),
                                                         dtype=np.float32)
        ids = np.array([[3, 0, 9], [9, 9, 1]])
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = jcommon.embed({"table": jnp.asarray(table)},
                                 jnp.asarray(ids), jdt)
            got = tcommon.embed(torch.from_numpy(table),
                                torch.from_numpy(ids), tdt)
            assert got.dtype == tdt
            close(got.float(), np.asarray(want, np.float32), 0)
        gen = torch.Generator().manual_seed(0)
        init = tcommon.embed_init(1000, 16, gen)
        assert init.shape == (1000, 16) and abs(init.std().item() - 0.02) < 2e-3

    @pytest.mark.parametrize("per_row", [False, True])
    def test_rope_matches(self, per_row):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 4, 6, 16), dtype=np.float32)
        pos = (rng.integers(0, 50, (2, 6)) if per_row
               else np.arange(3, 9))
        want = jllama._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
        got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500000.0)
        close(got, want, 1e-5)

    def test_ring_positions_floor_mod(self):
        for length in (0, 3, 8, 11, 27):
            want = jllama._ring_positions(jnp.asarray(length), 8)
            got = tllama._ring_positions(torch.tensor(length), 8)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        lengths = np.array([0, 5, 13])
        np.testing.assert_array_equal(
            tllama._ring_positions(torch.from_numpy(lengths), 8).numpy(),
            np.asarray(jllama._ring_positions(jnp.asarray(lengths), 8)))

    def test_param_count(self):
        for cfg in (JCFG, jllama.llama3_8b()):
            assert (tllama.llama_param_count(port_cfg(cfg))
                    == jllama.llama_param_count(cfg))
        model = tllama.init_llama(port_cfg(JCFG), device="cpu")
        assert (sum(p.numel() for p in model.parameters())
                == tllama.llama_param_count(port_cfg(JCFG)))
        assert jllama.llama_param_count(jllama.llama3_8b()) > 8.0e9


class TestInit:
    def test_init_is_seeded_and_stores_cfg_dtype(self):
        cfg = port_cfg(dataclasses.replace(JCFG, dtype="bfloat16"))
        a = tllama.init_llama(cfg, torch.Generator().manual_seed(3), "cpu")
        b = tllama.init_llama(cfg, torch.Generator().manual_seed(3), "cpu")
        c = tllama.init_llama(cfg, torch.Generator().manual_seed(4), "cpu")
        assert torch.equal(a.layers[1].w_up, b.layers[1].w_up)
        assert not torch.equal(a.layers[1].w_up, c.layers[1].w_up)
        assert a.layers[0].wq.dtype == torch.bfloat16
        assert a.embed.dtype == torch.bfloat16
        assert a.layers[0].attn_norm.dtype == torch.float32
        assert tuple(a.layers[0].wk.shape) == (2 * 16, 64)   # [out, in]
        assert tuple(a.lm_head.shape) == (256, 64)

    def test_generator_on_another_device_is_refused(self):
        with pytest.raises(ValueError, match="generator"):
            tllama.init_llama(port_cfg(JCFG), torch.Generator(),
                              device="meta")


class TestForward:
    def test_llama_apply_matches_f32(self):
        model = port_model()
        toks = tokens(0, 2, 16)
        want = j_apply(JPARAMS, jnp.asarray(toks), JCFG)
        got = tllama.llama_apply(model, torch.from_numpy(toks))
        assert got.dtype == torch.float32
        close(got, want)
        close(model(torch.from_numpy(toks)), want)

    def test_llama_apply_flash_path_matches(self):
        """use_flash=True takes the flash wrapper (its plain version on
        the CPU) in every layer: same logits at T=128."""
        model = port_model()
        toks = tokens(1, 1, 128)
        want = j_apply(JPARAMS, jnp.asarray(toks), JCFG,
                                  use_flash=False)
        close(tllama.llama_apply(model, torch.from_numpy(toks),
                                 use_flash=True), want)

    def test_llama_apply_matches_bf16(self):
        jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
        model = port_model(jcfg)
        toks = tokens(2, 2, 16)
        want = j_apply(JPARAMS, jnp.asarray(toks), jcfg)
        got = tllama.llama_apply(model, torch.from_numpy(toks))
        assert rel_err(got, want) < BF16_REL_TOL

    def test_sliding_window_matches(self):
        jcfg = dataclasses.replace(JCFG, window=8)
        toks = tokens(3, 1, 24)
        want = j_apply(JPARAMS, jnp.asarray(toks), jcfg)
        close(tllama.llama_apply(port_model(jcfg), torch.from_numpy(toks)),
              want)


class TestQuant:
    def test_quantize_linear_bit_exact(self):
        w = np.asarray(JPARAMS["layer0"]["w_gate"])            # [in, out]
        want = jquant.quantize_linear(jnp.asarray(w))
        got = tquant.quantize_linear(torch.from_numpy(w.T.copy()))
        np.testing.assert_array_equal(got["w_q"].numpy(),
                                      np.asarray(want["w_q"]).T)
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
        np.testing.assert_allclose(
            tquant.dequantize_linear(got).numpy(),
            np.asarray(jquant.dequantize_linear(want)).T, atol=0)

    def test_quantize_llama_matches(self):
        model = port_model()
        qmodel = tquant.quantize_llama(model)
        jq = jquant.quantize_llama(JPARAMS)
        assert tquant.is_quantized(qmodel.layers[0].wq)
        assert not tquant.is_quantized(model.layers[0].wq)  # original kept
        np.testing.assert_array_equal(
            qmodel.lm_head.w_q.numpy(), np.asarray(jq["lm_head"]["w_q"]).T)
        assert tquant.param_bytes(qmodel) == jquant.param_bytes(jq)
        assert tquant.param_bytes(model) == jquant.param_bytes(JPARAMS)
        toks = tokens(4, 2, 12)
        want = j_apply(jq, jnp.asarray(toks), JCFG)
        close(tllama.llama_apply(qmodel, torch.from_numpy(toks)), want)
        # the converter carries int8 trees too
        close(tllama.llama_apply(port_model(params=jq),
                                 torch.from_numpy(toks)), want)


def _jax_cached_run(jcfg, prompt, decode, per_slot=False):
    cache = jllama.init_kv_cache(jcfg, prompt.shape[0])
    logits, cache = j_cached(
        JPARAMS, jnp.asarray(prompt), cache, jcfg)
    out = [logits]
    for t in decode:
        logits, cache = j_cached(
            JPARAMS, jnp.asarray(t)[:, None], cache, jcfg)
        out.append(logits)
    return out


class TestCache:
    def test_prefill_and_decode_match(self):
        model = port_model()
        prompt = tokens(5, 2, 10)
        decode = [tokens(6 + i, 2, 1)[:, 0] for i in range(4)]
        want = _jax_cached_run(JCFG, prompt, decode)
        cache = tllama.init_kv_cache(port_cfg(JCFG), 2, device="cpu")
        logits, cache2 = tllama.llama_apply_cached(
            model, torch.from_numpy(prompt), cache)
        assert cache2 is cache and int(cache["length"]) == 10
        close(logits, want[0])
        for t, w in zip(decode, want[1:]):
            logits, cache = tllama.llama_apply_cached(
                model, torch.from_numpy(t)[:, None], cache)
            close(logits, w)

    def test_per_slot_matches(self):
        """Per-slot cache: prefill_slot into two rows at different
        lengths, then batched decode steps, against the JAX primitives."""
        model = port_model()
        cfg = port_cfg(JCFG)
        prompts = [tokens(7, 1, 5), tokens(8, 1, 9)]
        jc = jllama.init_kv_cache(JCFG, 2, per_slot=True)
        tc = tllama.init_kv_cache(cfg, 2, per_slot=True, device="cpu")
        for slot, p in enumerate(prompts):
            jl, jc = j_prefill_slot(JPARAMS, jnp.asarray(p), jc, slot,
                                         JCFG)
            tl, tc = tllama.prefill_slot(model, torch.from_numpy(p), tc,
                                         slot)
            close(tl, jl)
        np.testing.assert_array_equal(tc["length"].numpy(), [5, 9])
        for i in range(3):
            t = tokens(9 + i, 2, 1)
            jl, jc = j_cached(JPARAMS, jnp.asarray(t), jc,
                                 cfg=JCFG)
            tl, tc = tllama.llama_apply_cached(model, torch.from_numpy(t),
                                               tc)
            close(tl, jl)
        tc = tllama.retire_slot(tc, 0)
        np.testing.assert_array_equal(tc["length"].numpy(), [0, 12])

    def test_per_slot_scatter_puts_the_row_index_first(self):
        """buf[rows, :, idx, :] (index, slice, index, slice): the indexed
        dim leads the result, as in the reference's
        buf.at[arange(B), :, write_idx, :]; each row writes its own slot."""
        buf = torch.zeros(3, 2, 5, 4)
        new = torch.arange(3 * 2 * 4, dtype=torch.float32).view(3, 2, 1, 4)
        rows, idx = torch.arange(3), torch.tensor([4, 0, 2])
        assert buf[rows, :, idx, :].shape == (3, 2, 4)
        buf[rows, :, idx, :] = new[:, :, 0, :]
        want = jnp.zeros((3, 2, 5, 4)).at[jnp.arange(3), :, jnp.asarray(
            idx.numpy()), :].set(jnp.asarray(new.numpy())[:, :, 0, :])
        np.testing.assert_array_equal(buf.numpy(), np.asarray(want))

    def test_rolling_window_ring_wraps(self):
        """window=8: the cache is an 8-slot ring; a 12-token prompt
        prefills in ring-sized chunks and decode wraps the ring again."""
        jcfg = dataclasses.replace(JCFG, window=8)
        model = port_model(jcfg)
        prompt = tokens(12, 1, 12)
        jc = jllama.init_kv_cache(jcfg, 1)
        tc = tllama.init_kv_cache(port_cfg(jcfg), 1, device="cpu")
        assert tc["k"].shape[3] == 8
        for lo in (0, 8):
            jl, jc = j_cached(
                JPARAMS, jnp.asarray(prompt[:, lo:lo + 8]), jc, jcfg)
            tl, tc = tllama.llama_apply_cached(
                model, torch.from_numpy(prompt[:, lo:lo + 8]), tc)
            close(tl, jl)
        for i in range(10):
            t = tokens(13 + i, 1, 1)
            jl, jc = j_cached(JPARAMS, jnp.asarray(t), jc,
                                               jcfg)
            tl, tc = tllama.llama_apply_cached(model, torch.from_numpy(t),
                                               tc)
            close(tl, jl)
        assert int(tc["length"]) == 22

    def test_full_history_prefill_past_the_end_raises(self):
        """The reference clamps an out-of-range dynamic_update_slice; the
        port refuses to write past the cache instead."""
        model = port_model()
        cache = tllama.init_kv_cache(port_cfg(JCFG), 1, device="cpu")
        cache["length"] = torch.tensor(60)
        with pytest.raises((IndexError, RuntimeError)):
            tllama.llama_apply_cached(model, torch.zeros(1, 8,
                                                         dtype=torch.int64),
                                      cache)

    def test_cache_shapes(self):
        cfg = port_cfg(JCFG)
        c = tllama.init_kv_cache(cfg, 3, per_slot=True, device="cpu")
        jc = jllama.init_kv_cache(JCFG, 3, per_slot=True)
        assert tuple(c["k"].shape) == jc["k"].shape
        assert tuple(c["length"].shape) == jc["length"].shape
        assert tllama.init_kv_cache(cfg, 3, device="cpu")["length"].dim() == 0


    def test_length_is_written_in_place(self):
        """A CUDA graph of a decode step replays fixed addresses: the
        cache's length is the same tensor after llama_apply_cached
        (scalar and per-slot), prefill_slot and retire_slot."""
        model = port_model()
        cfg = port_cfg(JCFG)
        scalar = tllama.init_kv_cache(cfg, 2, device="cpu")
        length = scalar["length"]
        for t in (tokens(40, 2, 5), tokens(41, 2, 1)):
            _, scalar = tllama.llama_apply_cached(model, torch.from_numpy(t),
                                                  scalar)
        assert scalar["length"] is length and int(length) == 6
        vec = tllama.init_kv_cache(cfg, 2, per_slot=True, device="cpu")
        length = vec["length"]
        _, vec = tllama.prefill_slot(model, torch.from_numpy(
            tokens(42, 1, 7)), vec, 1)
        _, vec = tllama.llama_apply_cached(model, torch.from_numpy(
            tokens(43, 2, 1)), vec)
        vec = tllama.retire_slot(vec, 0)
        assert vec["length"] is length and length.tolist() == [0, 8]


class TestGenerate:
    @pytest.mark.parametrize("window", [0, 8])
    def test_greedy_matches(self, window):
        jcfg = dataclasses.replace(JCFG, window=window)
        prompt = tokens(30, 2, 11)
        want = j_generate(JPARAMS, jnp.asarray(prompt), 9, jcfg)
        got = tllama.llama_generate(port_model(jcfg),
                                    torch.from_numpy(prompt), 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_generate_edges(self):
        model = port_model()
        prompt = torch.from_numpy(tokens(31, 1, 4))
        assert tllama.llama_generate(model, prompt, 0).shape == (1, 0)
        with pytest.raises(ValueError, match="max_seq_len"):
            tllama.llama_generate(model, prompt, 61)

    def test_sampling_support_and_top_k(self):
        """Draws differ from jax.random's, so sampling is held to its
        support: with top_k=3 every draw is one of the 3 best logits."""
        logits = torch.from_numpy(np.random.default_rng(32).standard_normal(
            (4, 50)).astype(np.float32))
        gen = torch.Generator().manual_seed(0)
        top3 = torch.topk(logits, 3, dim=-1).indices
        seen = set()
        for _ in range(50):
            tok = tllama._sample_token(logits, gen, 1.0, 3)
            assert (tok[:, None] == top3).any(dim=-1).all()
            seen.update(tok.tolist())
        assert len(seen) > 4          # it samples, it is not argmax
        greedy = tllama._sample_token(logits, gen, 0.0, 3)
        np.testing.assert_array_equal(
            greedy.numpy(),
            np.asarray(jllama._sample_token(jnp.asarray(logits.numpy()),
                                            None, 0.0, 3)))
        with pytest.raises(ValueError, match="top_k"):
            tllama._sample_token(logits, gen, 1.0, 51)
        # the draw is torch.multinomial's own, written out so that a CUDA
        # graph can capture it: the same tokens from the same generator
        for top_k in (0, 5):
            ours, theirs = (torch.Generator().manual_seed(4) for _ in "ab")
            kth = torch.topk(logits, top_k or 50, dim=-1).values[..., -1:]
            probs = torch.softmax(torch.where(logits / 0.7 < kth / 0.7,
                                              -1e30, logits / 0.7), dim=-1)
            for _ in range(20):
                np.testing.assert_array_equal(
                    tllama._sample_token(logits, ours, 0.7, top_k).numpy(),
                    torch.multinomial(probs, 1, generator=theirs)[:, 0])
        sampled = tllama.llama_generate(
            port_model(), torch.from_numpy(tokens(33, 2, 5)), 6,
            temperature=0.8, top_k=5)
        assert sampled.shape == (2, 6)
        assert ((sampled >= 0) & (sampled < 256)).all()
