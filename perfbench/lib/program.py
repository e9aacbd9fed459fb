"""The program's own spans (``kubeshare_tpu_torch/utils/trace.py``), as
the metric readers read them: each pod's ``SharedChipGate`` (``gate``),
model server (``server``) and training step (``step``) keeps a
``trace`` whose ``spans`` have ``name``, ``t0``, ``t1`` and ``fields``,
on ``time.perf_counter()``. A program that keeps no such log gives no
spans, so every reader built on this returns None there."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .readers import in_window
from .trace import union


def logs(run, kind: str, owner: str) -> List[List]:
    """Each pod's spans of ``owner`` (``gate``, ``server`` or ``step``),
    oldest first; empty where the run is not of ``kind`` or the program
    keeps no log there."""
    if run.kind != kind:
        return []
    out = []
    for pod in run.pods:
        log = getattr(getattr(pod, owner, None), "trace", None)
        if log is not None:
            out.append(list(log.spans))
    return out


def named(spans: List, name: str) -> List:
    return [s for s in spans if s.name == name]


def slice_bounds(run) -> Optional[Tuple[float, float]]:
    """The traced slice on ``perf_counter``, where the run has one."""
    trace = run.trace
    if trace is None:
        return None
    return trace.perf0, trace.perf0 + trace.window_s


def counted(run, span) -> bool:
    """Whether a host reading counts ``span``: it started in the window
    and does not overlap the traced slice, in which the profiler slows
    the host's launches several times over."""
    if not in_window(run, span.t0):
        return False
    bounds = slice_bounds(run)
    return bounds is None or span.t1 <= bounds[0] or span.t0 >= bounds[1]


def in_run(run, kind: str, owner: str, name: str,
           slice_too: bool = False) -> List:
    """The pods' spans ``name`` of ``owner`` that ``counted``; with
    ``slice_too``, every one that started in the window, as the
    harness's own timings count them."""
    return [s for spans in logs(run, kind, owner) for s in named(spans, name)
            if (in_window(run, s.t0) if slice_too else counted(run, s))]


def mean_ms(spans: List) -> Optional[float]:
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)


def mean_field(spans: List, field: str) -> Optional[float]:
    values = [s.fields[field] for s in spans if field in s.fields]
    if not values:
        return None
    return sum(values) / len(values)


def self_ms(run, kind: str, owner: str, parent: str, child: str,
            weight: str, scale: float = 1.0) -> Optional[float]:
    """Σ(each ``parent`` span that ``counted``, less the ``child`` spans
    inside it) in ms, over Σ of the parents' field ``weight`` ×
    ``scale``: a parent's self time per unit of its work."""
    own = work = 0.0
    for spans in logs(run, kind, owner):
        children = named(spans, child)
        starts = [c.t0 for c in children]
        for p in named(spans, parent):
            if not counted(run, p):
                continue
            i, inside = bisect.bisect_left(starts, p.t0), 0.0
            while i < len(children) and children[i].t0 < p.t1:
                if children[i].t1 <= p.t1:
                    inside += children[i].t1 - children[i].t0
                i += 1
            own += p.t1 - p.t0 - inside
            work += p.fields.get(weight, 0)
    if not work:
        return None
    return 1e3 * own / (work * scale)


def idle_unheld(run, kind: str) -> Optional[float]:
    """The share of the traced slice, in %, in which no operation ran on
    the device and no pod held a token (``gate.hold``): idle that is the
    sharing layer's, not a holder's host's."""
    trace = run.trace
    gates = logs(run, kind, "gate")
    if trace is None or not trace.device or not gates:
        return None
    held = [(s.t0 - trace.perf0, s.t1 - trace.perf0) for spans in gates
            for s in named(spans, "gate.hold")]
    held = [(max(0.0, a), min(trace.window_s, b)) for a, b in held]
    covered = union(trace.busy() + [(a, b) for a, b in held if b > a])
    return 100.0 * (1.0 - sum(b - a for a, b in covered) / trace.window_s)


def unheld(run, kind: str) -> Optional[float]:
    """The share of the window, in %, in which no pod held a token (no
    ``gate.hold`` open), over the whole window less the traced slice:
    the time the sharing layer gave the device to no one. None where no
    hold falls in it."""
    gates = logs(run, kind, "gate")
    if not gates:
        return None
    w0, w1 = run.window
    bounds = slice_bounds(run)
    parts = [(w0, w1)] if bounds is None else [
        (a, b) for a, b in ((w0, min(w1, bounds[0])),
                            (max(w0, bounds[1]), w1)) if b > a]
    holds = [(s.t0, s.t1) for spans in gates for s in named(spans, "gate.hold")]
    total = held = 0.0
    for a, b in parts:
        total += b - a
        clipped = [(max(a, t0), min(b, t1)) for t0, t1 in holds]
        held += sum(y - x for x, y in union([(x, y) for x, y in clipped
                                             if y > x]))
    if not held:
        return None        # no hold in the window: nothing to read
    return 100.0 * (1.0 - held / total)
