"""The gate's drain, the arbiter helpers and the co-location headline
(kubeshare_tpu_torch/runtime/hook.py ``_block``, bench/arbiter.py,
bench/headline.py) on the CPU.

The drain must wait for the calling thread's current stream only, as
the reference's ``jax.block_until_ready(result)`` waits for the
result's own computation: a ``torch.cuda.synchronize`` would make each
co-located pod wait for every other pod's queued work while it holds
its token. With no card here, ``torch.cuda``'s event, stream and
synchronize hooks are replaced by recorders and the result is a tensor
that reports a CUDA device.

The headline runs at a toy size (2 pods, batch 8, 0.2 s phases, one
round) under a live ``tpu-schd``, skipped when runtime_native is not
built, as tests/test_torch_runtime.py skips.
"""

import json
import os

import pytest
import torch

from kubeshare_tpu_torch.bench import arbiter, headline
from kubeshare_tpu_torch.cmd import workload
from kubeshare_tpu_torch.models.mnist import (
    MnistConfig, init_mnist, make_mnist_train_step,
)
from kubeshare_tpu_torch.nodeconfig.files import ConfigEntry
from kubeshare_tpu_torch.runtime import hook
from kubeshare_tpu_torch.runtime.client import TokenClient, TokenProtocolError
from kubeshare_tpu_torch.runtime.hook import SharedChipGate

CUDA0 = torch.device("cuda", 0)


@pytest.fixture
def needs_schd():
    if not os.path.exists(arbiter.SCHD):
        pytest.skip("native runtime not built (make -C runtime_native)")


class OnCard(torch.Tensor):
    """A CPU tensor that says it lives on cuda:0."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return CUDA0


@pytest.fixture
def cuda_hooks(monkeypatch):
    calls = []

    class Event:
        def record(self, stream=None):
            calls.append(("record", stream))

        def synchronize(self):
            calls.append(("wait",))

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("current stream", device))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(("device", device)))
    return calls


class FakeClient:
    def acquire(self, est_ms=0.0):
        return 1e9

    def release(self, used_ms):
        pass


def test_drain_waits_for_the_current_stream_only(cuda_hooks):
    result = {"loss": torch.zeros(1).as_subclass(OnCard), "n": 3}
    assert hook._block(result) is result
    assert cuda_hooks == [("record", ("current stream", CUDA0)), ("wait",)]
    cuda_hooks.clear()
    gate = SharedChipGate(FakeClient())       # a pod's burst under the gate
    gate.begin()
    gate.flush(result["loss"])
    assert cuda_hooks == [("record", ("current stream", CUDA0)), ("wait",)]
    cuda_hooks.clear()
    hook._block([torch.zeros(1), "cpu results need no wait"])
    assert cuda_hooks == []


def test_p99_and_run_threads():
    assert arbiter.p99([]) == 0.0
    assert arbiter.p99(list(range(1, 101))) == 100
    assert arbiter.p99([3.0, 1.0, 2.0]) == 3.0
    seen = []
    assert arbiter.run_threads([lambda: seen.append(1)] * 3) >= 0.0
    assert seen == [1, 1, 1]

    def boom():
        raise RuntimeError("pod failed")

    with pytest.raises(RuntimeError, match="pod failed"):
        arbiter.run_threads([lambda: None, boom])


def test_an_arbiter_that_does_not_start_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(arbiter, "SCHD", "/bin/false")
    with pytest.raises(RuntimeError, match="tpu-schd did not answer"):
        arbiter.start_arbiter(str(tmp_path), "chip",
                              [ConfigEntry("a/b", 1.0, 0.5, 0)],
                              arbiter.free_port())
    assert (tmp_path / "config" / "chip").read_text() == "1\na/b 1 0.5 0\n"


def test_toy_headline_under_a_live_arbiter(needs_schd):
    doc = headline.run_headline(pods=2, batch=8, phase_s=0.2, rounds=1,
                                device="cpu")
    assert doc["isolated"] and doc["rounds"] == 1 and doc["pods"] == 2
    assert set(doc["tokens_acquired"]) == {"bench/pod-0", "bench/pod-1"}
    assert all(n > 0 for n in doc["tokens_acquired"].values())
    assert set(doc["arbiter_window_usage_ms"]) >= set(doc["tokens_acquired"])
    for key in ("value", "vs_baseline", "isolation_overhead",
                "worst_round_gated_vs_ungated"):
        assert doc[key] >= 0.0
    assert doc["value"] == doc["samples_per_s"]["gated"] > 0
    assert doc["burst_steps"] >= headline.STEPS_PER_BURST
    assert doc["per_pod_p99_step_ms"]["max"] > 0
    assert doc["device"] == "cpu" and doc["busy_share_method"] is None
    json.dumps(doc)


def test_a_dead_arbiter_fails_the_gated_phase(needs_schd, tmp_path):
    port = arbiter.free_port()
    names = ["t/pod-0", "t/pod-1"]
    proc = arbiter.start_arbiter(str(tmp_path), "chip",
                                 [ConfigEntry(n, 1.0, 0.5, 0) for n in names],
                                 port)
    try:
        pods = []
        for name in names:
            model = init_mnist(MnistConfig(hidden=8), device="cpu")
            images, labels = torch.zeros(2, 1, 28, 28), torch.zeros(
                2, dtype=torch.long)
            gate = SharedChipGate(TokenClient("127.0.0.1", port, pod=name),
                                  fail_open=False)
            pods.append(headline.Pod(name, make_mnist_train_step(model),
                                     (images, labels), gate=gate))
        ok = headline.run_colocated(pods, 0.05, 0.0, 1, True, 2)
        assert ok["samples_per_s"] > 0
    finally:
        arbiter.stop_arbiter(proc)
    with pytest.raises((OSError, TokenProtocolError)):
        headline.run_colocated(pods, 0.05, 0.0, 1, True, 2)
    with pytest.raises(OSError):
        SharedChipGate(TokenClient("127.0.0.1", port, pod=names[0]),
                       fail_open=False)


def test_workload_under_install_gate_acquires_tokens(needs_schd, capsys,
                                                     monkeypatch, tmp_path):
    port = arbiter.free_port()
    proc = arbiter.start_arbiter(str(tmp_path), "chip",
                                 [ConfigEntry("ns/trainer", 1.0, 0.5, 0)],
                                 port)
    try:
        monkeypatch.setenv(hook.ENV_POD_MANAGER_PORT, str(port))
        monkeypatch.setenv("KUBESHARE_POD_NAME", "ns/trainer")
        assert workload.main(["--device", "cpu", "--steps", "3",
                              "--batch", "2"]) == 0
    finally:
        arbiter.stop_arbiter(proc)
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["tokens_acquired"] > 0 and doc["compute_ms"] >= 0
