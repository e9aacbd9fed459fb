"""Multi-tenant device executor: weighted-fair in-process co-location
(port of ``kubeshare_tpu/runtime/executor.py``, unchanged but for the
completion barrier).

The arbiter planes (tpu-schd / SharedChipGate) share a device between
*processes*. This is the complementary serving-side shape: ONE process
hosts several tenants (models) on one device and schedules their
dispatches itself.

Scheduling is start-time weighted fair queuing (virtual time): each
tenant carries ``vtime`` advanced by ``elapsed / weight`` per executed
call; the dispatcher always runs the backlogged tenant with the least
vtime. Work within a tenant stays FIFO. Device time is measured by
waiting for the call's CUDA work to finish (``hook._block`` on the
dispatch thread's current stream, where the call queued it: one
dispatch in flight — fairness over pipelining, the right trade for
co-located serving).

Optionally a :class:`~kubeshare_tpu_torch.runtime.hook.SharedChipGate`
can be attached so the whole executor also holds arbiter tokens while
it runs (two-level: inter-process tokens outside, intra-process WFQ
inside).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Mapping, Optional, Tuple

from .hook import _block


class TenantStats:
    __slots__ = ("calls", "device_seconds")

    def __init__(self):
        self.calls = 0
        self.device_seconds = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"calls": self.calls, "device_seconds": self.device_seconds}


class _Tenant:
    __slots__ = ("name", "weight", "queue", "vtime", "stats")

    def __init__(self, name: str, weight: float, vtime: float):
        self.name = name
        self.weight = weight
        self.queue: collections.deque = collections.deque()
        self.vtime = vtime
        self.stats = TenantStats()


class ChipExecutor:
    """Run tenants' callables on the local device, weighted-fair.

    ``tenants`` maps name -> weight (relative device-time share, like
    the scheduler's ``tpu_request`` fractions). ``submit`` returns a
    Future resolving to the callable's result, its CUDA work finished.
    """

    def __init__(
        self,
        tenants: Mapping[str, float],
        gate=None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if not tenants:
            raise ValueError("ChipExecutor needs at least one tenant")
        for name, weight in tenants.items():
            if weight <= 0:
                raise ValueError(f"tenant {name}: weight must be > 0")
        self.clock = clock
        self.gate = gate
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._tenants = {
            name: _Tenant(name, weight, 0.0) for name, weight in tenants.items()
        }
        self._vnow = 0.0  # virtual-time frontier (last served vtime)
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------

    def submit(self, tenant: str, fn: Callable, *args, **kwargs) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("executor closed")
            t = self._tenants.get(tenant)
            if t is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            if not t.queue:
                # idle -> backlogged: start at the virtual-time
                # frontier — an idle past earns no banked credit
                # (start-time WFQ), so a returning tenant shares from
                # now on instead of monopolizing to "catch up"
                busy = [
                    x.vtime for x in self._tenants.values() if x.queue
                ]
                t.vtime = max(t.vtime, min(busy) if busy else self._vnow)
            t.queue.append((fn, args, kwargs, fut))
            self._work.notify()
        return fut

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: t.stats.as_dict() for name, t in self._tenants.items()
            }

    def close(self, wait: bool = True) -> None:
        """Stop accepting work; by default drain what's queued."""
        with self._lock:
            self._closed = True
            self._work.notify()
        if wait:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ---------------------------------------------------

    def _pick(self) -> Optional[_Tenant]:
        backlogged = [t for t in self._tenants.values() if t.queue]
        if not backlogged:
            return None
        return min(backlogged, key=lambda t: (t.vtime, t.name))

    def _flush_gate(self) -> None:
        if self.gate is not None:
            try:
                self.gate.flush(None)  # return any held token lease
            except Exception:
                pass

    def _next_item(self) -> Optional[Tuple[_Tenant, tuple]]:
        """Block until an item is ready; None once closed and drained.
        Any held arbiter token is returned BEFORE sleeping — the lease
        is never held across executor idle (hook.py burst discipline)."""
        while True:
            with self._lock:
                tenant = self._pick()
                if tenant is not None:
                    return tenant, tenant.queue.popleft()
                if self._closed:
                    return None
            self._flush_gate()  # may drain the device: outside the lock
            with self._lock:
                if self._pick() is None and not self._closed:
                    self._work.wait()

    def _dispatch(self) -> None:
        while True:
            nxt = self._next_item()
            if nxt is None:
                self._flush_gate()
                return
            tenant, (fn, args, kwargs, fut) = nxt
            if not fut.set_running_or_notify_cancel():
                continue
            started = self.clock()
            result = None
            error: Optional[BaseException] = None
            try:
                if self.gate is not None:
                    # amortized hold: one token spans many dispatches
                    # up to its quota (per-call acquire/release would
                    # pay a TCP round trip per model step)
                    self.gate.begin()
                result = _block(fn(*args, **kwargs))
                if self.gate is not None:
                    self.gate.maybe_release(result)
            except BaseException as e:  # tenant bug: fails ITS future only
                error = e
                self._flush_gate()
            elapsed = self.clock() - started
            with self._lock:
                tenant.vtime += elapsed / tenant.weight
                self._vnow = tenant.vtime
                tenant.stats.calls += 1
                tenant.stats.device_seconds += elapsed
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(result)
