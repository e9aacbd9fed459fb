"""kubeshare_tpu_torch/models/serving.py: DecodeServer token streams
against the JAX DecodeServer (float32 config, greedy: the streams must
match token for token), and the three invariants of
kubeshare_tpu/models/serving.py held inside the port, mirroring
tests/test_serving_slots.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.models.serving import DecodeServer as JaxDecodeServer
from kubeshare_tpu_torch.models import llama as tllama
from kubeshare_tpu_torch.models.convert import llama_from_jax
from kubeshare_tpu_torch.models.serving import (
    REFUSE_OVERSIZED, REFUSE_POOL_FULL, DecodeServer,
)

JCFG = jllama.LlamaConfig(
    vocab=256, dim=64, layers=2, num_heads=4, num_kv_heads=2,
    mlp_dim=128, max_seq_len=64, dtype="float32",
)
JPARAMS = jllama.init_llama(jax.random.PRNGKey(0), JCFG)
CFG = tllama.LlamaConfig(**dataclasses.asdict(JCFG))
MODEL = llama_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG, device="cpu")
BUCKETS = (8, 16)
# solo-vs-batched logits: one row against a batch of rows may take
# another CPU matmul kernel, so equal to float32 rounding, not bit-equal
SOLO_TOL = 1e-5


def _t(rows):
    return torch.tensor(rows, dtype=torch.int64)


def test_streams_match_jax_server():
    """admit / step / step_burst / retire / re-admit with eos and max_new
    stop rules: every call's output equals the JAX server's."""
    kw = dict(slots=3, prompt_buckets=BUCKETS, max_new=12)
    jserver = JaxDecodeServer(JPARAMS, JCFG, **kw)
    tserver = DecodeServer(MODEL, **kw)
    prompts = [[5, 9, 13], [21, 3, 7, 2, 40, 6], [33], [8] * 11, [1, 2]]
    script = [("admit", 0), ("step",), ("step",), ("admit", 1),
              ("admit", 2), ("burst", 4), ("retire", 1), ("admit", 3),
              ("burst", 5), ("step",), ("admit", 4), ("burst", 3),
              ("burst", 6)]
    for op in script:
        if op[0] == "admit":
            got, want = tserver.admit(prompts[op[1]]), jserver.admit(
                prompts[op[1]])
        elif op[0] == "step":
            got, want = tserver.step(), jserver.step()
        elif op[0] == "burst":
            got, want = tserver.step_burst(op[1]), jserver.step_burst(op[1])
        else:
            tserver.retire(op[1])
            jserver.retire(op[1])
            got = want = None
        assert got == want, (op, got, want)
        assert tserver.active == jserver.active
        assert tserver.host_len == jserver.host_len
        assert tserver.generated == jserver.generated


class TestInvariants:
    def test_vector_length_decode_matches_scalar(self):
        prompt = [[5, 9, 13], [21, 3, 7]]
        scalar = tllama.init_kv_cache(CFG, 2, device="cpu")
        _, scalar = tllama.llama_apply_cached(MODEL, _t(prompt), scalar)
        vec = tllama.init_kv_cache(CFG, 2, per_slot=True, device="cpu")
        for b in range(2):
            _, vec = tllama.prefill_slot(MODEL, _t([prompt[b]]), vec, b)
        step = _t([[11], [17]])
        ls, _ = tllama.llama_apply_cached(MODEL, step, scalar)
        lv, _ = tllama.llama_apply_cached(MODEL, step, vec)
        np.testing.assert_allclose(ls.numpy(), lv.numpy(), rtol=0,
                                   atol=SOLO_TOL)

    def test_staggered_slots_match_solo(self):
        p0, p1 = [5, 9, 13, 2, 40], [21, 3]
        vec = tllama.init_kv_cache(CFG, 2, per_slot=True, device="cpu")
        _, vec = tllama.prefill_slot(MODEL, _t([p0]), vec, 0)
        _, vec = tllama.prefill_slot(MODEL, _t([p1]), vec, 1)
        lv, _ = tllama.llama_apply_cached(MODEL, _t([[11], [17]]), vec)
        for b, prompt, tok in ((0, p0, 11), (1, p1, 17)):
            solo = tllama.init_kv_cache(CFG, 1, device="cpu")
            _, solo = tllama.llama_apply_cached(MODEL, _t([prompt]), solo)
            ls, _ = tllama.llama_apply_cached(MODEL, _t([[tok]]), solo)
            np.testing.assert_allclose(ls[0].numpy(), lv[b].numpy(), rtol=0,
                                       atol=SOLO_TOL)

    def test_padding_leaves_no_trace(self):
        """A prompt padded to its bucket decodes like the unpadded one:
        the pad keys are masked until decode overwrites them."""
        prompt = [5, 9, 13]
        padded = tllama.init_kv_cache(CFG, 1, per_slot=True, device="cpu")
        _, padded = tllama.prefill_slot(MODEL, _t([prompt + [0] * 5]),
                                        padded, 0)
        padded["length"][0] = len(prompt)
        exact = tllama.init_kv_cache(CFG, 1, per_slot=True, device="cpu")
        _, exact = tllama.prefill_slot(MODEL, _t([prompt]), exact, 0)
        for tok in (11, 4, 250, 7, 19, 3):
            lp, padded = tllama.llama_apply_cached(MODEL, _t([[tok]]), padded)
            le, exact = tllama.llama_apply_cached(MODEL, _t([[tok]]), exact)
            np.testing.assert_allclose(lp.numpy(), le.numpy(), rtol=0,
                                       atol=SOLO_TOL)

    def test_retire_remasks_history(self):
        vec = tllama.init_kv_cache(CFG, 1, per_slot=True, device="cpu")
        _, vec = tllama.prefill_slot(MODEL, _t([[5, 9, 13, 7]]), vec, 0)
        vec = tllama.retire_slot(vec, 0)
        _, vec = tllama.prefill_slot(MODEL, _t([[42, 8]]), vec, 0)
        lv, _ = tllama.llama_apply_cached(MODEL, _t([[3]]), vec)
        solo = tllama.init_kv_cache(CFG, 1, device="cpu")
        _, solo = tllama.llama_apply_cached(MODEL, _t([[42, 8]]), solo)
        ls, _ = tllama.llama_apply_cached(MODEL, _t([[3]]), solo)
        np.testing.assert_allclose(ls.numpy(), lv.numpy(), rtol=0,
                                   atol=SOLO_TOL)

    def test_per_slot_rejects_multitoken(self):
        vec = tllama.init_kv_cache(CFG, 2, per_slot=True, device="cpu")
        with pytest.raises(ValueError, match="prefill_slot"):
            tllama.llama_apply_cached(MODEL, torch.zeros(2, 3,
                                                         dtype=torch.int64),
                                      vec)
        with pytest.raises(ValueError, match="one sequence"):
            tllama.prefill_slot(MODEL, torch.zeros(2, 3, dtype=torch.int64),
                                vec, 0)


class TestServer:
    def test_tokens_match_solo_greedy(self):
        """Staggered tenants: each stream equals the same server shape
        serving that prompt alone."""
        def solo(prompt, n):
            server = DecodeServer(MODEL, slots=3, prompt_buckets=BUCKETS)
            toks = [server.admit(prompt)[1]]
            while len(toks) < n:
                toks.extend(server.step().values())
            return toks

        server = DecodeServer(MODEL, slots=3, prompt_buckets=BUCKETS)
        prompts = {0: [5, 9, 13], 1: [21, 3, 7, 2, 40, 6], 2: [33]}
        streams = {0: [server.admit(prompts[0])[1]]}
        for _ in range(2):
            for s, t in server.step().items():
                streams[s].append(t)
        for i in (1, 2):
            slot, first = server.admit(prompts[i])
            streams[slot] = [first]
        for s, toks in server.step_burst(4).items():
            streams[s].extend(toks)
        for slot, prompt in prompts.items():
            assert streams[slot] == solo(prompt, len(streams[slot]))

    def test_admit_reason_probe_matches_admit(self):
        server = DecodeServer(MODEL, slots=1, prompt_buckets=BUCKETS)
        assert server.admit_reason(17) == REFUSE_OVERSIZED
        assert server.admit([1] * 17) is None
        assert server.admit_reason(16) is None and server.can_admit()
        assert server.admit([5, 9]) is not None
        assert not server.can_admit() and server.free_slots() == 0
        assert server.admit_reason(2) == REFUSE_POOL_FULL
        assert server.admit([1, 2]) is None
        assert server.admit_reason(99) == REFUSE_OVERSIZED
        server.retire(0)
        assert server.admit_reason(2) is None
        with pytest.raises(ValueError):
            server.admit_reason(0)
        with pytest.raises(ValueError):
            server.admit([])
        with pytest.raises(ValueError, match="no prompt bucket"):
            DecodeServer(MODEL, prompt_buckets=(64, 128))

    def test_stop_rules(self):
        """eos retires after reporting the eos token; a first token that
        is eos retires at admission; max_new counts the first token."""
        probe = DecodeServer(MODEL, slots=1, prompt_buckets=BUCKETS)
        slot, first = probe.admit([5, 9, 13])
        stream = [first] + probe.step_burst(6)[slot]
        eos = stream[3]
        cut = stream.index(eos) + 1
        server = DecodeServer(MODEL, slots=1, prompt_buckets=BUCKETS,
                              eos_id=eos)
        slot, first = server.admit([5, 9, 13])
        got = [first]
        while server.active[slot]:
            got.extend(server.step().values())
        assert got == stream[:cut]
        eos_first = DecodeServer(MODEL, slots=1, prompt_buckets=BUCKETS,
                                 eos_id=stream[0])
        assert eos_first.admit([5, 9, 13]) == (0, stream[0])
        assert eos_first.active == [False]
        capped = DecodeServer(MODEL, slots=1, prompt_buckets=BUCKETS,
                              max_new=3)
        capped.admit([5, 9, 13])
        assert capped.step_burst(8) == {0: stream[1:3]}
        assert capped.active == [False]

    def test_burst_near_horizon_falls_back_to_steps(self):
        """Within a quantum of max_seq_len the burst runs single steps
        and retires the slot at the horizon."""
        server = DecodeServer(MODEL, slots=2, prompt_buckets=(16,))
        server.admit(list(range(1, 17)))
        server.host_len[0] = 60
        server.cache["length"][0] = 60
        out = server.step_burst(8)
        assert len(out[0]) == 4 and server.active == [False, False]

    def test_sampling_server(self):
        server = DecodeServer(MODEL, slots=2, prompt_buckets=BUCKETS,
                              temperature=0.9, top_k=4, seed=3)
        server.admit([5, 9, 13])
        server.admit([7])
        out = server.step_burst(5)
        assert sorted(out) == [0, 1]
        assert all(0 <= t < CFG.vocab for toks in out.values() for t in toks)
