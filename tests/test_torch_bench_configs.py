"""kubeshare_tpu_torch/bench/configs.py (the port of bench_configs.py's
LSTM gang, BASELINE config 3, and its continuous-batching bench) on the
CPU.

- A gang pod's Adam step against ``bench_configs._make_lstm_step`` in
  its CPU config (``_SMALL``), on the reference's weights (through
  ``models/convert.py``) and tokens. The LSTM runs in bf16 in both, and
  tests/test_torch_vision.py's tolerances hold it. The loss: 5e-3
  relative. Each gradient: its max abs times 1e-2 (weights and the
  embedding) or 0.25 (biases: a sum of bf16 cotangents over the batch
  and every position, accumulated differently), the bounds there on an
  SGD step, lr times the gradient. After the step, each parameter
  within 2 lr + 1e-5 (a gradient within rounding of zero may flip
  Adam's first step, lr g / (|g| + eps)), and within 1e-5 but for at
  most 1 % of a leaf's elements where the reference took a full step
  (|g| >> eps: at least 0.99 lr). Most of these gradients are under
  1e-6 at this size, where the first step is a fraction of lr that
  follows the gradient's last bits: the gradient check holds those.
- The bench's serving loop (``serve``) feeds the bench's pool a fixed
  arrival script on a counting clock, not a timed one; each admission
  and step is replayed on the reference's ``DecodeServer`` with the
  same weights in float32: identical results.
- Each result document has the reference's keys. The gang runs under a
  live ``tpu-schd`` and skips without runtime_native's build.
"""

import dataclasses
import math
import random

import jax
import numpy as np
import pytest
import torch

import bench_configs
import kubeshare_tpu.models as J
from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.models.common import cross_entropy_loss as j_xent
from kubeshare_tpu.models.serving import DecodeServer as JaxDecodeServer
from kubeshare_tpu_torch.bench import arbiter, configs
from kubeshare_tpu_torch.models import convert
from kubeshare_tpu_torch.models.llama import LlamaConfig

LOSS_TOL = 5e-3
GRAD_TOL = {"w": 1e-2, "b": 0.25}
ADAM_ABS_TOL = 1e-5
ADAM_FLIP_SHARE = 1e-2
FULL_STEP = 0.99
# the keys of bench_configs.run_lstm_gang()'s (bench_configs.py
# :243-258) and run_contbatch()'s (:527-546) result documents
GANG_KEYS = {
    "metric", "value", "unit", "vs_baseline", "ungated_value",
    "isolation_overhead", "isolation_overhead_worst_round",
    "p99_step_latency_ms_min", "p99_step_latency_ms_max", "gang", "rounds",
    "isolated",
}
CONTBATCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "admissions", "rejected",
    "decode_step_ms", "mean_slot_occupancy", "ttft_ms_p50", "ttft_ms_p99",
    "slots",
}


@pytest.fixture
def needs_schd():
    if not arbiter.available():
        pytest.skip("tpu-schd cannot be built here (g++)")


def test_cpu_sizes_are_the_references():
    assert bench_configs._SMALL
    assert (configs.SMALL_LSTM_BATCH, configs.SMALL_LSTM_SEQ) == (
        bench_configs.LSTM_BATCH, bench_configs.LSTM_SEQ)
    assert (configs.GANG_PODS, configs.GANG_FRACTION) == (
        bench_configs.GANG_PODS, bench_configs.GANG_FRACTION)


def test_lstm_pod_adam_step_matches_reference():
    j_step, params, opt_state, tokens = bench_configs._make_lstm_step(3)
    jcfg = J.LstmConfig(**dataclasses.asdict(configs.SMALL_LSTM))
    t_tokens = torch.tensor(np.asarray(tokens)).long()

    def port_model():
        return convert.lstm_from_jax(jax.tree.map(np.asarray, params),
                                     configs.SMALL_LSTM, device="cpu")

    # the gradients Adam is given, as test_torch_vision.py holds the LSTM
    probe = port_model()
    grads = torch.autograd.grad(configs.lstm_loss(probe, t_tokens),
                                list(probe.parameters()))
    for p, g in zip(probe.parameters(), grads):
        p.data = g
    j_grads = jax.grad(lambda p: j_xent(
        J.lstm_apply(p, tokens[:, :-1], jcfg), tokens[:, 1:]))(params)
    for a, (path, b) in zip(jax.tree.leaves(convert.workload_to_jax(probe)),
                            jax.tree_util.tree_leaves_with_path(j_grads)):
        b, tol = np.asarray(b), GRAD_TOL.get(path[-1].key, GRAD_TOL["w"])
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), path
    # the step
    model = port_model()
    loss = configs.make_lstm_step(model)(t_tokens)
    j_after, _, j_loss = j_step(params, opt_state, tokens)
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    got = convert.workload_to_jax(model)
    for a, b, b0 in zip(jax.tree.leaves(got), jax.tree.leaves(j_after),
                        jax.tree.leaves(params)):
        b, diff = np.asarray(b), np.abs(a - np.asarray(b))
        full = np.abs(b - np.asarray(b0)) >= FULL_STEP * configs.LR
        assert (diff[full] > ADAM_ABS_TOL).mean() <= ADAM_FLIP_SHARE
        assert diff.max() <= 2 * configs.LR + ADAM_ABS_TOL


class Recorder:
    """A DecodeServer that logs each admission's and step's result."""

    def __init__(self, server):
        self.server = server
        self.log = []

    def __getattr__(self, name):
        return getattr(self.server, name)

    def admit(self, prompt):
        got = self.server.admit(prompt)
        self.log.append(("admit", list(prompt), got))
        return got

    def step(self):
        got = self.server.step()
        self.log.append(("step", None, got))
        return got


def test_serve_streams_match_the_reference_server():
    jcfg = jllama.LlamaConfig(**{**dataclasses.asdict(configs.SMALL_LLAMA),
                                 "dtype": "float32"})
    params = jllama.init_llama(jax.random.PRNGKey(7), jcfg)
    model = convert.llama_from_jax(jax.tree.map(np.asarray, params),
                                   LlamaConfig(**dataclasses.asdict(jcfg)),
                                   device="cpu")
    server = Recorder(configs.contbatch_server(model, small=True))
    ticks = [0.0]

    def clock():
        ticks[0] += 1.0
        return ticks[0]

    def sleep(s):
        ticks[0] += s

    arrivals = configs.poisson_arrivals(random.Random(9), jcfg.vocab, 12.0)
    done = configs.serve(server, arrivals, 260.0, clock, sleep)
    assert done["admissions"] >= configs.CONTBATCH_SLOTS
    assert done["tokens_out_of_vocab"] == 0
    jserver = JaxDecodeServer(params, jcfg, slots=configs.CONTBATCH_SLOTS,
                              prompt_buckets=configs.PROMPT_BUCKETS,
                              max_new=configs.SMALL_MAX_NEW)
    steps = 0
    for kind, prompt, got in server.log:
        want = jserver.admit(prompt) if kind == "admit" else jserver.step()
        assert got == want, (kind, steps)
        steps += kind == "step"
    assert steps > configs.SMALL_MAX_NEW     # tenants retired and came back
    assert sum(len(got) for kind, _, got in server.log
               if kind == "step") + done["admissions"] == done["tokens"]


def test_run_lstm_gang_result_document(needs_schd):
    doc = configs.run_lstm_gang(phase_seconds=0.05, rounds=1, device="cpu",
                                small=True)
    assert GANG_KEYS <= set(doc)
    assert doc["unit"] == "samples/sec" and "config 3" in doc["metric"]
    assert doc["gang"] == {"headcount": 5, "threshold": 0.2}
    assert doc["value"] > 0 and doc["vs_baseline"] > 0
    assert 0.0 <= doc["isolation_overhead"] <= 1.0
    assert doc["p99_step_latency_ms_max"] >= doc["p99_step_latency_ms_min"]
    assert doc["burst"] >= configs.GANG_BURST_STEPS
    assert len(doc["tokens_acquired"]) == configs.GANG_PODS
    assert all(n > 0 for n in doc["tokens_acquired"].values())
    assert all(math.isfinite(x) for x in doc["final_loss"])


def test_run_contbatch_result_document():
    doc = configs.run_contbatch(phase_seconds=0.3, rounds=1, device="cpu",
                                small=True)
    assert CONTBATCH_KEYS <= set(doc)
    assert doc["unit"] == "tokens/sec" and doc["slots"] == 8
    assert doc["value"] > 0 and doc["admissions"] > 0
    assert doc["decode_step_ms"] > 0 and doc["tokens_out_of_vocab"] == 0
    assert doc["ttft_ms_p99"] >= doc["ttft_ms_p50"] > 0


def test_main_runs_lstm_and_contbatch_and_stops_at_resnet(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(configs, "run_lstm_gang", lambda: {"row": "lstm"})
    monkeypatch.setattr(configs, "run_contbatch", lambda: {"row": "cb"})
    monkeypatch.setattr(configs, "run_resnet_dp", lambda: {"row": "resnet"})
    assert configs.main(["lstm"]) == 0 and configs.main(["contbatch"]) == 0
    # resnet (BASELINE config 4) runs now: tests/test_torch_dp.py
    assert configs.main(["resnet"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        '{"row": "lstm"}', '{"row": "cb"}', '{"row": "resnet"}']
    assert configs.main(["nope"]) == 2
    assert "usage" in capsys.readouterr().err
