"""The readers of the program's own spans (``perfbench/lib/program.py``
and the metrics built on it): None where a run has nothing to read,
the expected values on hand-made spans and a hand-made device trace,
and numbers from a traced tiny run of the program on the CPU."""

from types import SimpleNamespace as NS

import pytest

from perfbench.lib.catalog import Catalog
from perfbench.lib.trace import DeviceOp, Trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_catalog import BENCH, REPO

PROGRAM = {
    "mistral7b.chat": ["gate_throttle_ms.serve", "decode_launch_ms",
                       "prefill_launch_ms_per_ktok",
                       "device_idle_unheld.serve", "gate_unheld.serve"],
    "phi3mini.finetune": ["gate_throttle_ms.train", "gate_drain_ms.train",
                          "train_launch_ms", "device_idle_unheld.train",
                          "gate_unheld.train"],
}
NEW = [name for names in PROGRAM.values() for name in names]


def read(name, run):
    return Catalog(REPO / "BENCHMARK.json").reader(name)(run)


def span(name, t0, t1, **fields):
    return NS(name=name, t0=t0, t1=t1, fields=fields)


def pod(gate=(), server=(), step=()):
    return NS(gate=NS(trace=NS(spans=list(gate))),
              server=NS(trace=NS(spans=list(server))),
              step=NS(trace=NS(spans=list(step))))


def run(kind, pods, trace=None, window=(100.0, 110.0)):
    return NS(kind=kind, pods=pods, trace=trace, window=window)


def test_the_new_metrics_are_entries_of_their_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in PROGRAM.items():
        for name in names:
            assert entries[name]["workloads"] == [cell]


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_of_a_missing_thing_returns_none(name):
    class Empty:
        kind, trace, pods = "serve", None, []
        window = (0.0, 1.0)

    assert read(name, Empty()) is None
    for kind in ("serve", "train"):
        # a program without spans: the pods' owners keep no trace
        bare = run(kind, [NS(gate=NS(), server=NS(), step=NS())],
                   Trace(window_s=4.0, perf0=100.0,
                         device=[DeviceOp("k", 0.0, 1.0, 0)]))
        assert read(name, bare) is None
        # spans, but none that started in the window
        late = run(kind, [pod(
            gate=[span("gate.acquire", 200.0, 200.1, waited_ms=1.0,
                       throttled_ms=1.0), span("gate.drain", 200.1, 200.2),
                  span("gate.hold", 200.1, 200.3)],
            server=[span("serve.burst", 200.0, 200.1, steps=4),
                    span("serve.admit", 200.2, 200.3, tokens=5)],
            step=[span("train.step", 200.0, 200.1)])])
        assert read(name, late) is None


def test_device_idle_unheld_takes_the_holds_out_of_the_idle():
    # device busy [0, 1] and [2, 3] of a 4-s slice; one hold [0, 1.5]
    trace = Trace(window_s=4.0, perf0=100.0,
                  device=[DeviceOp("k", 0.0, 1.0, 0),
                          DeviceOp("k", 2.0, 3.0, 0)])
    for kind in ("serve", "train"):
        r = run(kind, [pod(gate=[span("gate.hold", 100.0, 101.5)])], trace)
        assert read(f"device_idle.{kind}", r) == pytest.approx(50.0)
        assert read(f"device_idle_unheld.{kind}", r) == pytest.approx(37.5)
        # holds of two pods, one reaching past the slice, one before it
        r = run(kind, [pod(gate=[span("gate.hold", 100.0, 101.5)]),
                       pod(gate=[span("gate.hold", 99.0, 99.5),
                                 span("gate.hold", 103.5, 105.0)])], trace)
        assert read(f"device_idle_unheld.{kind}", r) == pytest.approx(25.0)
        other = "train" if kind == "serve" else "serve"
        assert read(f"device_idle_unheld.{other}", r) is None


def test_gate_unheld_is_the_window_with_no_hold_open():
    # a 10-s window [100, 110]; pod one holds [99, 101] and [104, 105],
    # pod two [100.5, 102] and [109, 111]: held 2 + 1 + 1 = 4 s
    one = pod(gate=[span("gate.hold", 99.0, 101.0),
                    span("gate.hold", 104.0, 105.0)])
    two = pod(gate=[span("gate.hold", 100.5, 102.0),
                    span("gate.hold", 109.0, 111.0)])
    for kind in ("serve", "train"):
        assert read(f"gate_unheld.{kind}", run(kind, [one, two])) == (
            pytest.approx(60.0))
        # a traced slice [103, 106] leaves the window's other 7 s, of
        # which 3 are held
        traced = run(kind, [one, two], Trace(window_s=3.0, perf0=103.0))
        assert read(f"gate_unheld.{kind}", traced) == pytest.approx(
            100.0 * 4 / 7)


def test_host_readings_leave_out_spans_in_the_traced_slice():
    # the profiler records [104, 107]: the burst at 105 and the one
    # reaching into it from 103.9 are not counted, nor the step there;
    # the acquires are, as gate_wait_ms counts them
    server = [span("serve.burst", 101.000, 101.040, steps=16),
              span("serve.sync", 101.005, 101.035),
              span("serve.burst", 103.900, 104.100, steps=16),
              span("serve.burst", 105.000, 105.500, steps=16)]
    gate = [span("gate.acquire", 101.0, 101.1, waited_ms=10.0,
                 throttled_ms=10.0),
            span("gate.acquire", 105.0, 105.1, waited_ms=90.0,
                 throttled_ms=90.0)]
    step = [span("train.step", 101.0, 101.2), span("train.step", 105.0, 106.0)]
    trace = Trace(window_s=3.0, perf0=104.0)
    r = run("serve", [pod(gate=gate, server=server)], trace)
    assert read("decode_launch_ms", r) == pytest.approx(0.625)
    assert read("gate_throttle_ms.serve", r) == pytest.approx(50.0)
    r = run("train", [pod(gate=gate, step=step)], trace)
    assert read("train_launch_ms", r) == pytest.approx(200.0)
    # untraced, every one of them counts
    r = run("train", [pod(gate=gate, step=step)])
    assert read("train_launch_ms", r) == pytest.approx(600.0)


def test_launch_times_leave_out_the_syncs():
    # a burst of 16 steps, 40 ms long, with a 30-ms sync inside
    server = [span("serve.burst", 101.000, 101.040, steps=16),
              span("serve.sync", 101.005, 101.035),
              # an admit of 2,000 tokens, 100 ms, with a 20-ms sync
              span("serve.admit", 102.000, 102.100, tokens=2000),
              span("serve.sync", 102.080, 102.100),
              # a sync outside any parent counts for none
              span("serve.sync", 103.0, 103.5)]
    r = run("serve", [pod(server=server)])
    assert read("decode_launch_ms", r) == pytest.approx(0.625)
    assert read("prefill_launch_ms_per_ktok", r) == pytest.approx(40.0)
    # two pods: the sums over both, each parent with its own pod's syncs
    other = [span("serve.burst", 101.000, 101.100, steps=4),
             span("serve.sync", 101.010, 101.020)]
    r = run("serve", [pod(server=server), pod(server=other)])
    assert read("decode_launch_ms", r) == pytest.approx(1e3 * (0.010 + 0.090)
                                                        / 20)


def test_gate_and_step_means():
    gate = [span("gate.acquire", 101.0, 101.2, waited_ms=180.0,
                 throttled_ms=150.0),
            span("gate.hold", 101.2, 101.5),
            span("gate.drain", 101.4, 101.45),
            span("gate.acquire", 102.0, 102.1, waited_ms=90.0,
                 throttled_ms=0.0),
            span("gate.drain", 102.3, 102.33),
            span("gate.acquire", 103.0, 103.1)]      # raised: no fields
    step = [span("train.step", 101.2, 101.5), span("train.step", 102.1, 102.2)]
    for kind in ("serve", "train"):
        r = run(kind, [pod(gate=gate, step=step)])
        assert read(f"gate_throttle_ms.{kind}", r) == pytest.approx(75.0)
    r = run("train", [pod(gate=gate, step=step)])
    assert read("gate_drain_ms.train", r) == pytest.approx(40.0)
    assert read("train_launch_ms", r) == pytest.approx(200.0)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train"])
def test_a_traced_tiny_run_reports_the_host_readings(tmp_path, cell):
    bench_path = tiny.checkout(tmp_path)
    # a window long enough to leave spans on both sides of the 0.5-s
    # traced slice, which the host readings leave out
    result, _ = tiny.run(bench_path, cell, trace=True, seconds=1.5)
    real = "mistral7b.chat" if cell == "tiny.serve" else "phi3mini.finetune"
    metrics = result["metrics"]
    for name in PROGRAM[real]:
        if name.startswith("device_idle"):
            assert name not in metrics     # no device on the CPU
        else:
            assert metrics[name]["value"] >= 0.0
