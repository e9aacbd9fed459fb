"""Arithmetic the metric readers share (``perfbench/metrics/*.py``).
Every reader returns None where its run has nothing for it to read."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

from . import roofline
from .trace import launched_within, overlap

PEAK = roofline.PEAK_FLOPS["bfloat16"]


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    ordered = sorted(values)
    if not ordered:
        return None
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def in_window(run, t: float) -> bool:
    return run.window[0] <= t < run.window[1]


def spans(run, kind: str, name: str) -> List:
    """The pods' host spans ``name`` that started in the window."""
    if run.kind != kind:
        return []
    return [s for p in run.pods for s in p.spans.get(name, [])
            if in_window(run, s[0])]


def gate_wait_ms(run, kind: str) -> Optional[float]:
    waits = spans(run, kind, "gate_wait")
    if not waits:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, *_ in waits) / len(waits)


def device_idle(run, kind: str) -> Optional[float]:
    trace = run.trace
    if run.kind != kind or trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def flash_roofline(run, fragment: str, kind: str) -> Optional[float]:
    """Least time over device time of every call of the kernel whose
    name holds ``fragment`` in the traced slice. A call's least time is
    the mean over the flash calls of one training forward at the
    trainer's shape, as the family lists them (``attention_calls``: each
    layer's shape at the model's head dim, and its window)."""
    if run.kind != "train" or run.trace is None:
        return None
    calls = run.trace.kernels(fragment)
    if not calls:
        return None
    t = run.traffic
    planned = run.family.attention_calls(run.spec, t["rows"], t["seq_len"])
    least = math.fsum(roofline.flash_bound_s(*call, kind)
                      for call in planned) / len(planned)
    return 100.0 * len(calls) * least / sum(d.end - d.start for d in calls)


def traced_flops(run, name: str, flops_of) -> Optional[float]:
    """Operations of the pods' spans ``name`` inside the traced slice,
    each span's share by its overlap with the slice."""
    trace = run.trace
    if trace is None:
        return None
    total = 0.0
    for p in run.pods:
        for span in p.spans.get(name, []):
            share = overlap(span[0] - trace.perf0, span[1] - trace.perf0,
                            trace.window_s)
            if share > 0:
                total += share * flops_of(span)
    return total


def mfu(flops: Optional[float], run) -> Optional[float]:
    if not flops or run.trace is None:
        return None
    return 100.0 * flops / (run.trace.window_s * PEAK)


def optimizer_ms(run) -> Optional[float]:
    """Device time of the kernels launched inside the optimizer's step
    (``Optimizer.step#...`` in the trace), a step."""
    trace = run.trace
    if run.kind != "train" or trace is None:
        return None
    # a step counts when every training step around it (host spans,
    # which end in the pod's drain) ended inside the slice, so that its
    # kernels were all recorded
    held = [(t0 - trace.perf0, t1 - trace.perf0) for p in run.pods
            for t0, t1, *_ in p.spans.get("train_step", [])]
    steps = [r for r in trace.optimizer if 0.0 <= r.start and all(
        t1 <= trace.window_s for t0, t1 in held if t0 <= r.start <= t1)]
    launched = launched_within(trace, steps)
    if not steps or not launched:
        return None
    device_s = sum(d.end - d.start for ops in launched.values() for d in ops)
    return 1e3 * device_s / len(steps)
