"""What a ``--trace 1`` run reads from ``torch.profiler``: the device's
operations over the traced slice, the harness's own host spans
(``perfbench.*`` annotations), and each kernel's launching host op.

``union`` is a frozen copy of the interval arithmetic of
``kubeshare_tpu_torch/bench/headline.py::_busy_share``, applied here to
the profiler's device intervals instead of a burst's events (a burst's
gaps counted as busy there; here only time in which an operation ran on
the device counts).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW_MARK = "perfbench.trace_window"
MARK_PREFIX = "perfbench."
OPTIMIZER_PREFIX = "Optimizer.step#"


def union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals covering ``spans``."""
    out: List[Tuple[float, float]] = []
    cur_start = cur_end = None
    for s, e in sorted(spans):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                out.append((cur_start, cur_end))
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        out.append((cur_start, cur_end))
    return out


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class DeviceOp:
    name: str
    start: float          # seconds from the traced slice's start
    end: float
    launcher: int         # correlation id of the host op that launched it


@dataclass
class HostOp:
    name: str
    start: float
    end: float
    thread: int


@dataclass
class Trace:
    """The traced slice: every time in seconds from its start;
    ``perf0`` is ``time.perf_counter()`` at that start, so a host span
    (t0, t1) of the harness sits at (t0 - perf0, t1 - perf0)."""
    window_s: float
    perf0: float
    device: List[DeviceOp] = field(default_factory=list)
    marks: List[HostOp] = field(default_factory=list)
    host_ops: Dict[int, HostOp] = field(default_factory=dict)
    optimizer: List[HostOp] = field(default_factory=list)

    def busy(self) -> List[Tuple[float, float]]:
        """Intervals in which an operation ran on the device, clipped to
        the slice."""
        clipped = [(max(0.0, d.start), min(self.window_s, d.end))
                   for d in self.device]
        return union([(s, e) for s, e in clipped if e > s])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time in the slice."""
        total: Dict[str, float] = defaultdict(float)
        for d in self.device:
            total[d.name[:120]] += min(self.window_s, d.end) - max(0.0, d.start)
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])
                if s > 0][:top]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Device idle time, by the harness spans open on the host in the
        middle of each gap (names joined by '+'), longest total first."""
        edges = [0.0]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window_s)
        total: Dict[str, float] = defaultdict(float)
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            names = sorted({m.name[len(MARK_PREFIX):] for m in self.marks
                            if m.start <= mid <= m.end})
            total["+".join(names) or "no harness span"] += e - s
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])
                ][:top]

    def kernels(self, fragment: str) -> List[DeviceOp]:
        return [d for d in self.device if fragment in d.name
                and 0.0 <= d.start < self.window_s]


def _annotation(event) -> bool:
    """A ``record_function`` range, which the profiler also draws on the
    device over the work launched inside it: not an operation."""
    if getattr(event, "is_user_annotation", None) and event.is_user_annotation():
        return True
    return event.name().startswith((MARK_PREFIX, "Optimizer.", "## "))


def read(prof, perf0: float) -> Optional[Trace]:
    """The slice marked by ``WINDOW_MARK`` in a stopped profiler."""
    events = prof.profiler.kineto_results.events()
    window = None
    for e in events:
        if e.name() == WINDOW_MARK:
            window = (_ns(e, "start"), _ns(e, "start") + _ns(e, "duration"))
    if window is None:
        return None
    t0 = window[0]
    trace = Trace(window_s=(window[1] - t0) / 1e9, perf0=perf0)
    for e in events:
        start = (_ns(e, "start") - t0) / 1e9
        end = start + _ns(e, "duration") / 1e9
        if str(e.device_type()).endswith("CUDA"):
            if _annotation(e):
                continue      # a host range's shadow on the device
            if end > 0 and start < trace.window_s:
                trace.device.append(DeviceOp(e.name(), start, end,
                                             int(e.linked_correlation_id())))
            continue
        name = e.name()
        op = HostOp(name, start, end, int(e.start_thread_id()))
        if name.startswith(MARK_PREFIX) and name != WINDOW_MARK:
            trace.marks.append(op)
        elif name.startswith(OPTIMIZER_PREFIX):
            trace.optimizer.append(op)
        elif name.startswith("aten::"):
            # the ops that launch kernels; the runtime's own events
            # (cudaLaunchKernel ...) number their correlations apart
            trace.host_ops[int(e.correlation_id())] = op
    return trace


def launched_within(trace: Trace, ranges: Sequence[HostOp]) -> Dict[int, List[DeviceOp]]:
    """Device operations whose launching host op started inside one of
    ``ranges`` on the same thread, by the range's index."""
    out: Dict[int, List[DeviceOp]] = defaultdict(list)
    for d in trace.device:
        op = trace.host_ops.get(d.launcher)
        if op is None:
            continue
        for i, r in enumerate(ranges):
            if r.thread == op.thread and r.start <= op.start <= r.end:
                out[i].append(d)
                break
    return out


def overlap(t0: float, t1: float, window_s: float) -> float:
    """The share of the span (t0, t1), in slice seconds, inside the
    slice."""
    if t1 <= t0:
        return 0.0
    return max(0.0, min(t1, window_s) - max(t0, 0.0)) / (t1 - t0)
