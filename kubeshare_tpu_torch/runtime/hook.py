"""PyTorch-side gating (port of ``kubeshare_tpu/runtime/hook.py``).

A wrapped step function acquires a compute token from the node's
arbiter before dispatching device work and reports the measured time
back on release. CUDA work is asynchronous, so the wrapper drains the
caller's work inside the token hold: an event recorded on the calling
thread's current stream, and waited for. That is the counterpart of the
reference's ``jax.block_until_ready(result)``: it waits for the work
this caller queued and not for other streams' work, so pods that
dispatch from their own threads on their own streams are each billed
for their own work only.

HBM caps are enforced two ways:
- cooperatively via ``request_memory`` accounting against the arbiter
  (an over-cap allocation raises ``HbmCapExceeded`` before dispatch);
- preventively: ``apply_hbm_env_cap`` caps PyTorch's caching allocator
  with ``torch.cuda.set_per_process_memory_fraction`` before the first
  allocation.

Usage in a pod (env injected by the scheduler)::

    gate = install_gate()          # reads KUBESHARE_* env
    step = gate.wrap(decode_step)  # or: with gate.compute(): ...
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

from .client import TokenClient, TokenProtocolError

# the scheduler's env contract (kubeshare_tpu/scheduler/constants.py)
ENV_POD_MANAGER_PORT = "KUBESHARE_POD_MANAGER_PORT"
ENV_HBM_LIMIT = "KUBESHARE_HBM_LIMIT_BYTES"


class HbmCapExceeded(MemoryError):
    pass


class SharedChipGate:
    def __init__(
        self,
        client: Optional[TokenClient],
        hbm_limit_bytes: int = 0,
        fail_open: bool = True,
        drain: Optional[Callable[[Any], Any]] = None,
    ):
        """``drain`` overrides the completion barrier applied inside a
        token hold (default ``_block``: the calling thread's current
        stream on the result's devices; ``fetch_drain`` copies the
        result to the host)."""
        self.client = client
        self.hbm_limit = hbm_limit_bytes
        self.fail_open = fail_open
        self.drain = drain
        self._hbm_used = 0
        self.tokens_acquired = 0
        self.compute_ms = 0.0
        self._held = False
        self._quota_ms = 0.0
        self._hold_start = 0.0

    def _drain(self, result: Any) -> Any:
        if self.drain is not None:
            return self.drain(result)
        return _block(result)

    # ---- compute gating --------------------------------------------

    @contextmanager
    def compute(self, est_ms: float = 0.0):
        """Hold a compute token around a block of device work."""
        acquired = False
        if self.client is not None:
            try:
                self.client.acquire(est_ms)
                acquired = True
                self.tokens_acquired += 1
            except (TokenProtocolError, OSError):
                if not self.fail_open:
                    raise
        start = time.perf_counter()
        try:
            yield
        finally:
            used_ms = (time.perf_counter() - start) * 1e3
            self.compute_ms += used_ms
            if acquired:
                try:
                    self.client.release(used_ms)
                except (TokenProtocolError, OSError):
                    if not self.fail_open:
                        raise

    def wrap(self, fn: Callable, est_ms: float = 0.0) -> Callable:
        """Gate a step function; drains its results inside the token
        hold so released time reflects real device occupancy."""

        @functools.wraps(fn)
        def gated(*args, **kwargs):
            with self.compute(est_ms):
                result = fn(*args, **kwargs)
                result = self._drain(result)
            return result

        return gated

    # ---- amortized token holding -----------------------------------
    #
    # Per-call acquire/release costs a TCP round trip (~100us). A held
    # token covers as many dispatches as fit in its quota: steps run
    # asynchronously inside the hold, and when the quota's wall-clock
    # expires the device is drained and the token returned with the
    # measured hold time.

    def begin(self, est_ms: float = 0.0) -> None:
        """Ensure a compute token is held (no-op if already holding)."""
        if self.client is None or self._held:
            return
        try:
            self._quota_ms = self.client.acquire(est_ms)
            self._held = True
            self._hold_start = time.perf_counter()
            self.tokens_acquired += 1
        except (TokenProtocolError, OSError):
            if not self.fail_open:
                raise

    def _release_hold(self, result: Any) -> Any:
        result = self._drain(result)
        used_ms = (time.perf_counter() - self._hold_start) * 1e3
        self.compute_ms += used_ms
        self._held = False
        try:
            self.client.release(used_ms)
        except (TokenProtocolError, OSError):
            if not self.fail_open:
                raise
        return result

    def maybe_release(self, result: Any = None) -> Any:
        """Call after each dispatched step: if the held quota expired,
        drain the device and return the token."""
        if self.client is None or not self._held:
            return result
        elapsed_ms = (time.perf_counter() - self._hold_start) * 1e3
        if elapsed_ms >= self._quota_ms:
            result = self._release_hold(result)
        return result

    def flush(self, result: Any = None) -> Any:
        """Drain and return the token unconditionally (end of stream)."""
        if self.client is not None and self._held:
            result = self._release_hold(result)
        return result

    @contextmanager
    def burst(self, est_ms: float = 0.0):
        """Hold one token across a burst of async dispatches, draining
        and returning it at burst end: the lease is never held across
        the caller's input stall. For continuous dispatch loops, call
        begin()/maybe_release() directly."""
        self.begin(est_ms)
        try:
            yield self
        finally:
            self.flush()

    # ---- HBM accounting --------------------------------------------

    def request_memory(self, delta_bytes: int) -> None:
        """Account an allocation; raises HbmCapExceeded over the cap."""
        if self.hbm_limit and self._hbm_used + delta_bytes > self.hbm_limit:
            raise HbmCapExceeded(
                f"HBM cap {self.hbm_limit} exceeded: "
                f"{self._hbm_used} + {delta_bytes}"
            )
        if self.client is not None:
            try:
                granted, used, cap = self.client.request_memory(delta_bytes)
            except (TokenProtocolError, OSError):
                if not self.fail_open:
                    raise
                granted = True
            if not granted:
                raise HbmCapExceeded(
                    f"arbiter denied {delta_bytes} bytes (cap {self.hbm_limit})"
                )
        self._hbm_used = max(0, self._hbm_used + delta_bytes)

    def track_arrays(self, *tensors) -> None:
        """Account the device footprint of concrete tensors."""
        total = sum(t.numel() * t.element_size() for t in tensors
                    if isinstance(t, torch.Tensor))
        if total:
            self.request_memory(total)

    def close(self) -> None:
        if self.client is not None:
            self.client.close()


def _tensors(result: Any):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for value in result.values():
            yield from _tensors(value)
    elif isinstance(result, (list, tuple)):
        for value in result:
            yield from _tensors(value)


def _block(result: Any) -> Any:
    """Wait until the work queued so far on the calling thread's current
    stream, on each CUDA device holding one of the result's tensors
    (nested in lists, tuples and dicts), has finished. Other streams'
    work is not waited for: a ``torch.cuda.synchronize`` would wait for
    every stream on the card, and so for every co-located pod's queued
    work."""
    devices = {t.device for t in _tensors(result) if t.is_cuda}
    for device in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return result


def fetch_drain(result: Any) -> Any:
    """Host-fetch completion barrier: copies every tensor of the result
    to the host (which waits for it) and returns the result unchanged.
    Select with ``KUBESHARE_DRAIN=fetch`` (see ``install_gate``)."""
    for t in _tensors(result):
        t.cpu()
    return result


def apply_hbm_env_cap(limit_bytes: int, total_hbm: int = 0,
                      device: int = 0) -> None:
    """Cap PyTorch's caching allocator on ``device`` at ``limit_bytes``
    (a fraction of ``total_hbm``, default the card's memory). Call it
    before the first allocation: memory already held is not returned."""
    if limit_bytes <= 0:
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"HBM cap of {limit_bytes} bytes but no CUDA device")
    if total_hbm <= 0:
        total_hbm = torch.cuda.get_device_properties(device).total_memory
    fraction = max(0.01, min(1.0, limit_bytes / total_hbm))
    torch.cuda.set_per_process_memory_fraction(fraction, device)


_GATE: Optional[SharedChipGate] = None


def install_gate(
    host: str = "127.0.0.1",
    port: Optional[int] = None,
    hbm_limit: Optional[int] = None,
    fail_open: bool = True,
) -> SharedChipGate:
    """Build the process-wide gate from the env the scheduler injected
    (KUBESHARE_POD_MANAGER_PORT / KUBESHARE_HBM_LIMIT_BYTES). Without a
    manager port (whole-device or dev run), the gate is a no-op."""
    global _GATE
    if port is None:
        port = int(os.environ.get(ENV_POD_MANAGER_PORT, "0") or "0")
    if hbm_limit is None:
        hbm_limit = int(os.environ.get(ENV_HBM_LIMIT, "0") or "0")
    client = None
    if port:
        try:
            client = TokenClient(host, port)
        except OSError:
            if not fail_open:
                raise
    apply_hbm_env_cap(hbm_limit)
    drain = None
    if os.environ.get("KUBESHARE_DRAIN", "") == "fetch":
        drain = fetch_drain
    _GATE = SharedChipGate(
        client, hbm_limit_bytes=hbm_limit, fail_open=fail_open,
        drain=drain,
    )
    return _GATE


def current_gate() -> Optional[SharedChipGate]:
    return _GATE
