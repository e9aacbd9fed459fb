"""kubeshare_tpu_torch/bench/serving.py (the port of bench_serving.py,
BASELINE config 5) on the CPU.

The pods' decode step (``PodDecode``) against the reference's
``make_decode`` on the same weights (``models/convert.py``): greedy, 32
steps from zero tokens over 8 sequences, in a float32 copy of the
bench's config (the reference's ``CFG`` is patched to it for the test).
The tokens must be identical and the logits within 1e-4 of their max
abs: float32 in both, summed in another order.

The whole bench runs at its own config with 0.05 s phases and one round
under a live ``tpu-schd``, skipped when runtime_native is not built, as
tests/test_torch_headline.py skips.
"""

import dataclasses
import gc
import importlib
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_serving
from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu_torch.bench import arbiter
from kubeshare_tpu_torch.bench import serving
from kubeshare_tpu_torch.models.convert import llama_from_jax

tllama = importlib.import_module("kubeshare_tpu_torch.models.llama")

LOGIT_TOL = 1e-4
STEPS = 32
# the keys of bench_serving.run()'s result document (bench_serving.py
# :232-253)
REFERENCE_KEYS = {
    "metric", "weights", "value", "unit", "vs_baseline", "ungated_value",
    "isolation_overhead", "isolation_overhead_worst_round",
    "per_pod_vs_solo_min", "per_pod_vs_solo_max",
    "p99_token_latency_ms_min", "p99_token_latency_ms_max", "isolated",
}


@pytest.fixture
def needs_schd():
    if not os.path.exists(arbiter.SCHD):
        pytest.skip("native runtime not built (make -C runtime_native)")


def _f32_pair(monkeypatch):
    jcfg = dataclasses.replace(bench_serving.CFG, dtype="float32")
    monkeypatch.setattr(bench_serving, "CFG", jcfg)
    params = jllama.init_llama(jax.random.PRNGKey(7), jcfg)
    cfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = llama_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    return jcfg, params, model


def test_port_config_is_the_reference_config():
    assert (dataclasses.asdict(serving.CFG)
            == dataclasses.asdict(bench_serving.CFG))
    assert (serving.PODS, serving.BATCH, serving.TOKENS_PER_BURST,
            serving.MIN_BURST_MS, serving.STALL_FACTOR,
            serving.PHASE_SECONDS, serving.ROUNDS) == (
        bench_serving.PODS, bench_serving.BATCH,
        bench_serving.TOKENS_PER_BURST, bench_serving.MIN_BURST_MS,
        bench_serving.STALL_FACTOR, bench_serving.PHASE_SECONDS,
        bench_serving.ROUNDS)


def test_pod_decode_matches_make_decode(monkeypatch):
    jcfg, params, model = _f32_pair(monkeypatch)
    decode = bench_serving.make_decode(params)
    j_cached = jax.jit(jllama.llama_apply_cached, static_argnames="cfg")
    tok = jnp.zeros((bench_serving.BATCH,), jnp.int32)
    cache = jllama.init_kv_cache(jcfg, bench_serving.BATCH)
    pod = serving.PodDecode(model)
    length = pod.cache["length"]
    for i in range(STEPS):
        want_logits, _ = j_cached(params, tok[:, None], cache, cfg=jcfg)
        tok, cache = decode(tok[:, None], cache)
        got = pod.step()
        assert got.tolist() == np.asarray(tok).tolist(), i
        want = np.asarray(want_logits)[:, -1]
        err = np.abs(pod.logits.numpy() - want).max()
        assert err <= LOGIT_TOL * np.abs(want).max(), (i, err)
    assert pod.cache["length"] is length and int(length) == STEPS


def test_restart_replays_the_stream_on_the_same_cache():
    """The per-burst reset writes the cache's length in place: after
    ``restart`` the pod decodes the same tokens again, and ``rewind``
    keeps the tokens going from where they were."""
    model = tllama.init_llama(dataclasses.replace(serving.CFG, layers=1),
                              device="cpu")
    pod = serving.PodDecode(model)
    cache = dict(pod.cache)
    first = [pod.step().tolist() for _ in range(6)]
    pod.restart()
    assert int(pod.cache["length"]) == 0
    assert [pod.step().tolist() for _ in range(6)] == first
    assert all(pod.cache[k] is cache[k] for k in cache)
    pod.rewind()
    assert int(pod.cache["length"]) == 0 and pod.tokens.tolist() == first[-1]


def test_pod_decode_is_freed_when_dropped():
    model = tllama.init_llama(dataclasses.replace(serving.CFG, layers=1),
                              device="cpu")
    pod = serving.PodDecode(model)
    pod.step()
    ref = weakref.ref(pod)
    gc.disable()
    try:
        del pod
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("quant", [False, True])
def test_run_result_document(needs_schd, quant):
    doc = serving.run(quant=quant, phase_seconds=0.05, rounds=1,
                      device="cpu")
    assert REFERENCE_KEYS <= set(doc)
    assert doc["weights"] == ("int8" if quant else "bfloat16")
    assert doc["unit"] == "tokens/sec" and doc["isolated"] is True
    assert doc["value"] > 0 and doc["vs_baseline"] > 0
    assert 0.0 <= doc["isolation_overhead"] <= 1.0
    assert (doc["p99_token_latency_ms_max"]
            >= doc["p99_token_latency_ms_min"] > 0)
    assert doc["burst"] >= serving.TOKENS_PER_BURST
    assert doc["decode_step_ms"] > 0 and doc["rounds"] == 1
    assert len(doc["tokens_acquired"]) == serving.PODS
    assert all(n > 0 for n in doc["tokens_acquired"].values())
    assert doc["device"] == "cpu" and doc["busy_share_method"] is None


def test_main_takes_int8(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(serving, "run",
                        lambda quant=False: calls.append(quant) or {"q": quant})
    assert serving.main([]) == 0 and serving.main(["--int8"]) == 0
    assert calls == [False, True]
    assert capsys.readouterr().out.splitlines() == ['{"q": false}',
                                                    '{"q": true}']
