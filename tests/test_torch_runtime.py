"""kubeshare_tpu_torch/runtime/{client,hook,executor}.py, mirroring
tests/test_runtime.py and tests/test_executor.py: the gate's token and
memory accounting with a fake client, the TokenClient copy against the
reference client on one line-protocol server, the weighted-fair
executor, and (when runtime_native is built) both under a live
tpu-schd arbiter."""

import os
import socket
import socketserver
import subprocess
import threading
import time

import pytest
import torch

from kubeshare_tpu.runtime.client import TokenClient as JaxTokenClient
from kubeshare_tpu_torch.runtime import hook
from kubeshare_tpu_torch.runtime.client import (
    TokenClient, TokenProtocolError,
)
from kubeshare_tpu_torch.runtime.executor import ChipExecutor
from kubeshare_tpu_torch.runtime.hook import HbmCapExceeded, SharedChipGate

SCHD = os.path.join(os.path.dirname(__file__), "..", "runtime_native",
                    "build", "tpu-schd")


class FakeClient:
    """Records the gate's calls; grants tokens with a fixed quota."""

    def __init__(self, quota_ms=1000.0, grant_memory=True, fail=False):
        self.quota_ms = quota_ms
        self.grant_memory = grant_memory
        self.fail = fail
        self.calls = []

    def acquire(self, est_ms=0.0):
        if self.fail:
            raise OSError("arbiter gone")
        self.calls.append(("acquire", est_ms))
        return self.quota_ms

    def release(self, used_ms):
        self.calls.append(("release", used_ms))

    def request_memory(self, delta):
        self.calls.append(("mem", delta))
        return self.grant_memory, 0, 0

    def close(self):
        self.calls.append(("close",))


def kinds(client):
    return [c[0] for c in client.calls]


class TestGate:
    def test_wrap_acquires_drains_and_releases(self):
        client = FakeClient()
        drained = []
        gate = SharedChipGate(client, drain=lambda r: drained.append(r) or r)
        step = gate.wrap(lambda x: x * 2)
        assert step(21) == 42
        assert kinds(client) == ["acquire", "release"]
        assert drained == [42] and gate.tokens_acquired == 1
        assert gate.compute_ms >= 0.0

    def test_amortized_hold(self):
        client = FakeClient(quota_ms=0.0)
        gate = SharedChipGate(client)
        gate.begin()
        gate.begin()                       # already holding: no new token
        assert kinds(client) == ["acquire"]
        assert gate.maybe_release("r") == "r"   # quota 0: expired
        assert kinds(client) == ["acquire", "release"]
        long_hold = FakeClient(quota_ms=1e9)
        gate = SharedChipGate(long_hold)
        gate.begin()
        gate.maybe_release()
        assert kinds(long_hold) == ["acquire"]   # quota not yet spent
        gate.flush()
        assert kinds(long_hold) == ["acquire", "release"]
        with gate.burst():
            pass
        assert kinds(long_hold)[-2:] == ["acquire", "release"]

    def test_memory_cap_and_denial(self):
        gate = SharedChipGate(FakeClient(), hbm_limit_bytes=1000)
        gate.request_memory(900)
        with pytest.raises(HbmCapExceeded):
            gate.request_memory(200)
        denied = SharedChipGate(FakeClient(grant_memory=False))
        with pytest.raises(HbmCapExceeded, match="denied"):
            denied.request_memory(10)
        tracked = FakeClient()
        SharedChipGate(tracked).track_arrays(
            torch.zeros(10, dtype=torch.float32), torch.zeros(3,
                                                              dtype=torch.int8),
            "not a tensor")
        assert tracked.calls == [("mem", 43)]

    def test_fail_open_and_closed(self):
        gate = SharedChipGate(FakeClient(fail=True))
        assert gate.wrap(lambda: 7)() == 7 and gate.tokens_acquired == 0
        strict = SharedChipGate(FakeClient(fail=True), fail_open=False)
        with pytest.raises(OSError):
            strict.wrap(lambda: 7)()
        assert SharedChipGate(None).wrap(lambda: 7)() == 7

    def test_drains_pass_cpu_results_through(self):
        result = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "x"}
        assert hook._block(result) is result
        assert hook.fetch_drain(result) is result
        assert len(list(hook._tensors(result))) == 2

    def test_install_gate_from_env(self, monkeypatch):
        monkeypatch.setenv(hook.ENV_POD_MANAGER_PORT, "0")
        monkeypatch.setenv(hook.ENV_HBM_LIMIT, "0")
        monkeypatch.setenv("KUBESHARE_DRAIN", "fetch")
        gate = hook.install_gate()
        assert gate.client is None and gate.drain is hook.fetch_drain
        assert hook.current_gate() is gate
        assert gate.wrap(lambda: 5)() == 5

    def test_hbm_cap_sets_the_allocator_fraction(self, monkeypatch):
        hook.apply_hbm_env_cap(0)            # no cap: no device needed
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hook.apply_hbm_env_cap(1 << 30)
        calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                            lambda frac, dev: calls.append((frac, dev)))
        hook.apply_hbm_env_cap(20 << 30, total_hbm=80 << 30)
        assert calls == [(0.25, 0)]


class _LineServer(socketserver.StreamRequestHandler):
    """The arbiter's line protocol, recording every request line."""

    def handle(self):
        for raw in self.rfile:
            line = raw.decode().strip()
            self.server.lines.append(line)
            verb = line.split()[0]
            reply = {"ACQ": "TOK 50.000", "REL": "OK", "MEM": "OK 10 100",
                     "PING": "PONG"}.get(verb)
            if " ns/bad " in line:
                reply = "NOPE"
            elif verb == "STAT":
                reply = "STAT 1\npod-x 1.500 10 100"
            self.wfile.write((reply + "\n").encode())


@pytest.fixture
def line_server():
    server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _LineServer)
    server.daemon_threads = True
    server.lines = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def test_token_client_copy_speaks_like_the_reference(line_server):
    port = line_server.server_address[1]
    replies = []
    for cls in (JaxTokenClient, TokenClient):
        with cls("127.0.0.1", port, pod="ns/p") as c:
            replies.append((c.acquire(1.5), c.release(2.25),
                            c.request_memory(64), c.ping(),
                            [(s.pod, s.window_usage_ms, s.mem_used, s.mem_cap)
                             for s in c.stats()]))
    assert replies[0] == replies[1]
    half = len(line_server.lines) // 2
    assert line_server.lines[:half] == line_server.lines[half:]
    assert line_server.lines[0] == "ACQ ns/p 1.500"
    with TokenClient("127.0.0.1", port, pod="ns/bad") as c:
        for call in (c.acquire, lambda: c.release(1.0),
                     lambda: c.request_memory(1)):
            with pytest.raises(TokenProtocolError):
                call()


def make_work(ms: float):
    def work():
        end = time.perf_counter() + ms / 1e3
        x = 0
        while time.perf_counter() < end:
            x += 1
        return x

    return work


class TestExecutor:
    def test_weighted_order_under_backlog(self):
        ex = ChipExecutor({"fast": 3.0, "slow": 1.0})
        order, futs = [], []

        def tagged(tag):
            base = make_work(3)

            def run():
                base()
                order.append(tag)

            return run

        for _ in range(12):
            futs.append(ex.submit("slow", tagged("s")))
        for _ in range(12):
            futs.append(ex.submit("fast", tagged("f")))
        for f in futs:
            f.result(timeout=30)
        ex.close()
        assert order[:8].count("f") >= 5, order
        stats = ex.stats()
        assert stats["fast"]["calls"] == stats["slow"]["calls"] == 12

    def test_results_fifo_and_tensors(self):
        ex = ChipExecutor({"t": 1.0})
        futs = [ex.submit("t", lambda i=i: i * i) for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == [i * i
                                                        for i in range(20)]
        x = torch.arange(8.0)
        assert torch.equal(ex.submit("t", lambda: x * 2).result(timeout=10),
                           x * 2)
        ex.close()

    def test_exception_fails_only_that_future(self):
        ex = ChipExecutor({"t": 1.0})

        def boom():
            raise ValueError("tenant bug")

        bad, good = ex.submit("t", boom), ex.submit("t", lambda: 42)
        with pytest.raises(ValueError):
            bad.result(timeout=10)
        assert good.result(timeout=10) == 42
        ex.close()

    def test_close_drains_then_rejects(self):
        ex = ChipExecutor({"t": 1.0})
        futs = [ex.submit("t", make_work(2)) for _ in range(5)]
        ex.close(wait=True)
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError):
            ex.submit("t", lambda: 1)
        with pytest.raises(KeyError):
            ChipExecutor({"t": 1.0}).submit("ghost", lambda: 1)
        with pytest.raises(ValueError):
            ChipExecutor({})
        with pytest.raises(ValueError):
            ChipExecutor({"t": 0.0})

    def test_gated_executor_holds_tokens(self):
        client = FakeClient(quota_ms=0.0)
        ex = ChipExecutor({"a": 1.0, "b": 1.0}, gate=SharedChipGate(client))
        futs = [ex.submit(t, make_work(1)) for t in ("a", "b") for _ in
                range(3)]
        for f in futs:
            f.result(timeout=10)
        ex.close()
        assert kinds(client).count("acquire") == kinds(client).count(
            "release") == 6


@pytest.mark.skipif(not os.path.exists(SCHD),
                    reason="native runtime not built")
def test_gate_and_executor_under_live_arbiter(tmp_path):
    from kubeshare_tpu.nodeconfig.files import ConfigEntry, write_config_file

    base = str(tmp_path)
    write_config_file(base, "chip-0", [ConfigEntry("default/a", 1.0, 0.6,
                                                   1000)])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen([
        SCHD, "-p", os.path.join(base, "config"), "-f", "chip-0",
        "-P", str(port), "-q", "50", "-m", "5", "-w", "1000",
        "-H", "127.0.0.1",
    ])
    try:
        deadline = time.time() + 5
        while True:
            try:
                TokenClient("127.0.0.1", port, pod="probe").close()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        gate = SharedChipGate(TokenClient("127.0.0.1", port, pod="default/a"),
                              hbm_limit_bytes=1000)
        assert gate.wrap(lambda x: x * 2)(21) == 42
        gate.request_memory(900)
        with pytest.raises(HbmCapExceeded):
            gate.request_memory(200)
        ex = ChipExecutor({"m1": 1.0, "m2": 1.0}, gate=gate)
        futs = [ex.submit(t, make_work(2)) for t in ("m1", "m2")
                for _ in range(4)]
        for f in futs:
            f.result(timeout=30)
        ex.close()
        assert gate.tokens_acquired > 1
        gate.close()
    finally:
        proc.kill()
        proc.wait()
