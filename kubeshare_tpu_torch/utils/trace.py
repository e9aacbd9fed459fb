"""Spans of the port's own hot paths (the shape of
``kubeshare_tpu/utils/trace.py``'s ``Tracer.span(name, **fields)``,
without its histograms, Chrome export or scheduler wiring).

An owner (a gate, a model server, a training step) holds a
:class:`SpanLog`; ``log.span(name, **fields)`` times a block::

    with log.span("serve.burst") as span:
        ...
        span.fields["steps"] = steps

Each span closed is kept as a :class:`Span` (``name``, ``t0``, ``t1``,
``fields``) in a bounded ring, the oldest dropped first. Times are
``time.perf_counter()`` seconds, the clock a benchmark's own spans and
its profiler slice are taken on, so a program span can be laid over the
device's busy intervals.

The log is always on: two clock reads and one append, with no lock, as
one thread owns each log. While a ``torch.profiler`` records, a span
also opens ``record_function("kubeshare." + name)``, so an exported
profile shows it on the timeline; otherwise that costs one read of the
profiler's enabled flag.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict

from torch.autograd import profiler as _profiler

MAXLEN = 65536
RANGE_PREFIX = "kubeshare."


class Span:
    """One span: a context manager, or ``start()`` and ``end()`` where
    it opens and closes in different calls. Recorded in its log at
    ``end``."""

    __slots__ = ("name", "t0", "t1", "fields", "_log", "_range")

    def __init__(self, log: "SpanLog", name: str, fields: Dict[str, Any]):
        self.name = name
        self.fields = fields
        self.t0 = self.t1 = 0.0
        self._log = log
        self._range = None

    def start(self) -> "Span":
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def end(self) -> None:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._log.spans.append(self)

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class SpanLog:
    """The spans one owner recorded, oldest first (``spans``, at most
    ``MAXLEN``)."""

    def __init__(self):
        self.spans: Deque[Span] = deque(maxlen=MAXLEN)

    def span(self, name: str, **fields: Any) -> Span:
        return Span(self, name, fields)
