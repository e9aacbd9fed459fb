"""The spans the port records of its own work
(``kubeshare_tpu_torch/utils/trace.py``): the recorder, and the spans of
``SharedChipGate``, ``DecodeServer`` and ``make_train_step``'s step, on
the CPU; and tpu-schd's account of each wait in its ``TOK`` reply
(``TOK <quota_ms> <waited_ms> <throttled_ms>``), and its charge for a
hold (the part of it inside the window), against a live ``tpu-schd``,
the port's, built from ``runtime/csrc/``."""

import contextlib
import os
import socket
import socketserver
import subprocess
import threading
import time

import pytest
import torch

from kubeshare_tpu_torch.models import llama
from kubeshare_tpu_torch.models.serving import DecodeServer
from kubeshare_tpu_torch.models.train import make_train_step
from kubeshare_tpu_torch.nodeconfig.files import ConfigEntry, write_config_file
from kubeshare_tpu_torch.runtime import native
from kubeshare_tpu_torch.runtime.client import TokenClient
from kubeshare_tpu_torch.runtime.hook import SharedChipGate
from kubeshare_tpu_torch.utils import trace

CFG = llama.LlamaConfig(vocab=64, dim=32, layers=1, num_heads=2,
                        num_kv_heads=1, mlp_dim=64, max_seq_len=48,
                        dtype="float32")
MODEL = llama.init_llama(CFG, device="cpu")


def names(log):
    return [s.name for s in log.spans]


def inside(spans, parent, name):
    return [s for s in spans if s.name == name
            and parent.t0 <= s.t0 <= s.t1 <= parent.t1]


# ---- the recorder -------------------------------------------------------

def test_the_ring_is_bounded_and_keeps_the_newest():
    assert trace.MAXLEN == 65536
    log = trace.SpanLog()
    for i in range(trace.MAXLEN + 3):
        with log.span("s", i=i):
            pass
    assert len(log.spans) == trace.MAXLEN
    assert log.spans[0].fields["i"] == 3
    assert log.spans[-1].fields["i"] == trace.MAXLEN + 2


def test_spans_nest_keep_their_fields_and_use_perf_counter():
    log = trace.SpanLog()
    before = time.perf_counter()
    with log.span("outer", a=1) as outer:
        with log.span("inner") as inner:
            inner.fields["b"] = 2
    after = time.perf_counter()
    assert names(log) == ["inner", "outer"]    # recorded as each closes
    assert before <= outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= after
    assert outer.fields == {"a": 1} and inner.fields == {"b": 2}


def test_a_span_opened_and_closed_apart_and_one_that_raises():
    log = trace.SpanLog()
    span = log.span("apart").start()
    assert names(log) == []
    span.end()
    with pytest.raises(ValueError):
        with log.span("raises"):
            raise ValueError("boom")
    assert names(log) == ["apart", "raises"]


def test_ranges_appear_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    log = trace.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with log.span("outer"):
            with log.span("inner"):
                torch.ones(4).sum()
    recorded = {e.name for e in prof.events()}
    assert {"kubeshare.outer", "kubeshare.inner"} <= recorded
    assert names(log) == ["inner", "outer"]


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(trace._profiler, "record_function", record_function)
    log = trace.SpanLog()
    with log.span("off"):
        pass
    assert entered == []
    monkeypatch.setattr(trace._profiler, "_is_profiler_enabled", True)
    with log.span("on"):
        pass
    assert entered == ["kubeshare.on"]
    assert names(log) == ["off", "on"]


# ---- the decode server ------------------------------------------------

def test_server_records_admits_bursts_and_their_syncs():
    server = DecodeServer(MODEL, slots=2, prompt_buckets=(8, 16))
    server.admit([1, 2, 3])
    server.admit(list(range(1, 12)))
    out = server.step_burst(4)
    assert sorted(len(t) for t in out.values()) == [4, 4]
    spans = list(server.trace.spans)
    admits = [s for s in spans if s.name == "serve.admit"]
    assert [a.fields["tokens"] for a in admits] == [3, 11]
    for a in admits:
        assert len(inside(spans, a, "serve.sync")) == 1
    (burst,) = [s for s in spans if s.name == "serve.burst"]
    assert burst.fields["steps"] == 4
    assert len(inside(spans, burst, "serve.sync")) == 1
    assert len(spans) == 2 * 2 + 2


def test_burst_fallback_near_the_horizon_counts_the_steps_run():
    server = DecodeServer(MODEL, slots=2, prompt_buckets=(16,))
    server.admit(list(range(1, 17)))
    server.host_len[0] = CFG.max_seq_len - 4
    server.cache["length"][0] = CFG.max_seq_len - 4
    out = server.step_burst(8)
    assert len(out[0]) == 4 and server.active == [False, False]
    spans = list(server.trace.spans)
    burst = spans[-1]
    assert burst.name == "serve.burst" and burst.fields["steps"] == 4
    assert len(inside(spans, burst, "serve.sync")) == 4
    server.step_burst(8)                       # nothing active: no step
    assert server.trace.spans[-1].fields["steps"] == 0
    server.admit([5, 6])
    server.step_burst(1)                       # quantum 1: one step
    assert server.trace.spans[-1].fields["steps"] == 1


def test_a_full_pool_and_an_oversized_prompt_are_still_spanned():
    server = DecodeServer(MODEL, slots=1, prompt_buckets=(8,))
    assert server.admit([1] * 9) is None
    server.admit([1, 2])
    assert server.admit([3]) is None
    admits = [s for s in server.trace.spans if s.name == "serve.admit"]
    assert [a.fields["tokens"] for a in admits] == [9, 2, 1]


# ---- the training step --------------------------------------------------

def test_train_step_records_one_span_a_call():
    model = llama.init_llama(CFG, device="cpu", trainable=True)
    _, step = make_train_step(llama.llama_loss, model, learning_rate=1e-3)
    tokens = torch.randint(0, CFG.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    losses = [float(step(tokens)) for _ in range(3)]
    assert names(step.trace) == ["train.step"] * 3
    assert losses[2] < losses[0]                # it still trains
    spans = list(step.trace.spans)
    assert all(a.t1 <= b.t0 for a, b in zip(spans, spans[1:]))


# ---- the gate ---------------------------------------------------------

class FakeClient:
    """The token protocol's client surface, answering at once."""

    def __init__(self, waited=(12.5, 7.25)):
        self.lines = []
        self._waited = waited

    def acquire(self, est_ms=0.0):
        self.lines.append("ACQ")
        if self._waited is not None:
            self.waited = self._waited
        return 50.0

    def release(self, used_ms):
        self.lines.append("REL")

    def close(self):
        pass


def test_gate_records_acquire_hold_and_drain_in_order():
    client = FakeClient()
    gate = SharedChipGate(client, fail_open=False)
    gate.begin()
    gate.begin()                                # held: no second acquire
    gate.flush(torch.ones(2))
    assert client.lines == ["ACQ", "REL"]
    acquire, hold, drain = sorted(gate.trace.spans, key=lambda s: s.t0)
    assert [acquire.name, hold.name, drain.name] == [
        "gate.acquire", "gate.hold", "gate.drain"]
    assert acquire.fields == {"waited_ms": 12.5, "throttled_ms": 7.25}
    assert acquire.t1 <= hold.t0 <= drain.t0 <= drain.t1 <= hold.t1
    assert gate.compute_ms == pytest.approx(1e3 * (hold.t1 - hold.t0),
                                            rel=0.5, abs=0.5)


def test_gate_spans_around_compute_and_wrap_and_a_client_without_waits():
    gate = SharedChipGate(FakeClient(waited=None), fail_open=False)
    gated = gate.wrap(lambda x: x * 2)
    gated(torch.ones(2))
    assert sorted(names(gate.trace)) == ["gate.acquire", "gate.drain",
                                         "gate.hold"]
    acquire = gate.trace.spans[0]
    assert acquire.fields == {"waited_ms": 0.0, "throttled_ms": 0.0}
    with gate.compute():
        pass
    assert names(gate.trace)[3:] == ["gate.acquire", "gate.hold"]


# ---- the TOK reply ------------------------------------------------------

class _Reply(socketserver.StreamRequestHandler):
    def handle(self):
        for raw in self.rfile:
            verb = raw.decode().split()[0]
            reply = self.server.tok if verb == "ACQ" else "OK"
            self.wfile.write((reply + "\n").encode())


@pytest.mark.parametrize("tok, quota, waited", [
    ("TOK 50.000", 50.0, (0.0, 0.0)),
    ("TOK 20.000 31.500 30.250", 20.0, (31.5, 30.25)),
])
def test_token_client_reads_both_tok_forms(tok, quota, waited):
    server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Reply)
    server.daemon_threads = True
    server.tok = tok
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with TokenClient("127.0.0.1", server.server_address[1],
                         pod="ns/p") as client:
            assert client.waited == (0.0, 0.0)
            assert client.acquire() == quota
            assert client.waited == waited
            client.release(1.0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


# ---- tpu-schd's account, live ---------------------------------------

WINDOW_MS = 200


@pytest.fixture
def schd(tmp_path):
    """The port's tpu-schd, window 200 ms, quota 20 ms: pod a at limit
    0.5 (100 ms a window), pod b at limit 1.0."""
    try:
        binary = native.build_binary("tpu-schd")
    except RuntimeError as e:
        pytest.skip(f"tpu-schd not built: {e}")
    write_config_file(str(tmp_path), "chip-0", [
        ConfigEntry("default/a", 0.5, 0.0, 0),
        ConfigEntry("default/b", 1.0, 0.5, 0)])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [binary, "-p", os.path.join(str(tmp_path), "config"), "-f", "chip-0",
         "-P", str(port), "-q", "20", "-m", "5", "-w", str(WINDOW_MS),
         "-H", "127.0.0.1"], stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 10
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 0.2).close()
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.05)
        yield port
    finally:
        proc.kill()
        proc.wait()


def _raw_acquire(port, pod):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        f = s.makefile("rw", newline="\n")
        f.write(f"ACQ {pod} 0\n")
        f.flush()
        reply = f.readline().strip()
        f.write(f"REL {pod} 1\n")
        f.flush()
        assert f.readline().strip() == "OK"
    return reply


def test_a_lease_granted_at_once_waited_nothing(schd):
    assert _raw_acquire(schd, "default/b") == "TOK 20.000 0.000 0.000"


def test_the_reference_client_reads_the_longer_grant(schd):
    from kubeshare_tpu.runtime.client import TokenClient as ReferenceClient

    with ReferenceClient("127.0.0.1", schd, pod="default/b") as client:
        assert client.acquire() == 20.0
        client.release(1.0)
        assert {s.pod for s in client.stats()} == {"default/a", "default/b"}


def test_a_pod_past_its_limit_is_told_it_was_throttled(schd):
    with TokenClient("127.0.0.1", schd, pod="default/a") as client:
        client.acquire()
        assert client.waited == (0.0, 0.0)
        client.release(150.0)          # past 0.5 x 200 ms until it expires
        t0 = time.perf_counter()
        client.acquire()
        blocked_ms = 1e3 * (time.perf_counter() - t0)
        waited, throttled = client.waited
        client.release(1.0)
    assert 0.0 < throttled <= waited <= blocked_ms + 1.0
    assert throttled > 0.25 * WINDOW_MS


def test_a_pod_waiting_its_turn_is_not_throttled(schd):
    holder = TokenClient("127.0.0.1", schd, pod="default/b")
    waiter = TokenClient("127.0.0.1", schd, pod="default/a")
    try:
        holder.acquire()
        got = threading.Thread(target=waiter.acquire)
        got.start()
        time.sleep(0.3)
        holder.release(1.0)
        got.join(timeout=10)
        assert not got.is_alive()
        waited, throttled = waiter.waited
        waiter.release(1.0)
    finally:
        holder.close()
        waiter.close()
    assert waited > 0.0 and throttled == 0.0


# ---- the charge: the part of each hold inside the window ----------------


def _held_ms(holds, start, end):
    """Client-side hold time, in ms, of ``(grant, release)`` intervals
    (``perf_counter`` seconds) inside ``[start, end]``."""
    return 1e3 * sum(max(0.0, min(r, end) - max(g, start)) for g, r in holds)


def _hold_back_to_back(client, hold_s, run_s):
    """Acquire, hold for ``hold_s``, release with the hold's true wall
    time since the grant, again at once, for ``run_s``; returns the
    holds and each grant's ``client.waited``."""
    holds, waits = [], []
    end = time.perf_counter() + run_s
    while time.perf_counter() < end:
        client.acquire()
        granted = time.perf_counter()
        waits.append(client.waited)
        time.sleep(hold_s)
        released = time.perf_counter()
        client.release(1e3 * (released - granted))
        holds.append((granted, released))
    return holds, waits


def test_a_hold_that_straddles_the_window_start_is_charged_its_tail(schd):
    with TokenClient("127.0.0.1", schd, pod="default/b") as client:
        client.acquire()
        t0 = time.perf_counter()
        client.release(150.0)      # the hold [t - 150, t], t its REL
        t1 = time.perf_counter()
        time.sleep(0.12)
        t2 = time.perf_counter()
        usage = {s.pod: s.window_usage_ms for s in client.stats()}["default/b"]
        t3 = time.perf_counter()
    # tpu-schd's STAT came 1e3 * (t2 - t1) to 1e3 * (t3 - t0) ms after
    # its REL: 150 ms less the part before the window's start, about 80
    least = max(0.0, min(150.0, WINDOW_MS - 1e3 * (t3 - t0)))
    most = max(0.0, min(150.0, WINDOW_MS - 1e3 * (t2 - t1)))
    assert least - 1.0 <= usage <= most + 1.0
    assert usage < 150.0 - 10.0


def test_a_pod_at_limit_one_holding_back_to_back_is_never_throttled(schd):
    """Holds of 70 ms: charged in full at their end, the last three of
    a 200 ms window (210 ms) would pass 1.0 x 200 ms."""
    with TokenClient("127.0.0.1", schd, pod="default/b") as client:
        holds, waits = _hold_back_to_back(client, 0.07, 3 * WINDOW_MS / 1e3)
    assert len(holds) >= 6
    assert [throttled for _, throttled in waits] == [0.0] * len(waits)


def test_a_pod_at_limit_half_holding_back_to_back_keeps_to_its_share(schd):
    """Pod a, limit 0.5 (100 ms of a 200 ms window), holds 20 ms at a
    time for four windows: it is throttled, and after the first window
    its hold time over the last window, at each release, is at most the
    ceiling plus the hold that began under it, and about its share."""
    with TokenClient("127.0.0.1", schd, pod="default/a") as client:
        holds, waits = _hold_back_to_back(client, 0.02, 4 * WINDOW_MS / 1e3)
    assert any(throttled > 0.0 for _, throttled in waits)
    first = holds[0][0] + WINDOW_MS / 1e3
    held = []
    for g, r in holds:
        if r < first:
            continue
        held.append(_held_ms(holds, r - WINDOW_MS / 1e3, r))
        assert held[-1] <= 0.5 * WINDOW_MS + 1e3 * (r - g) + 1.0
    assert len(held) >= 4
    assert sorted(held)[len(held) // 2] >= 0.4 * WINDOW_MS
