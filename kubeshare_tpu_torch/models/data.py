"""Host-to-device input prefetch (port of ``kubeshare_tpu/models/data.py``).

A background thread pulls batches from the caller's iterator and stages
them on the device ahead of the training loop, so the input pipeline
runs while the card computes the previous step: bounded depth, the
producer's exceptions re-raised in the consumer, ``close()`` joins the
thread, and an abandoned prefetcher is stopped by its GC finalizer.

The default transfer, ``stage_to_device``, copies CPU tensors through
pinned memory on a side stream of the prefetcher's own and waits for the
copy on the producer's thread, so a batch is complete when it is
queued. The consumer marks each CUDA tensor it takes as used on its own
current stream (``record_stream``), so the caching allocator does not
hand the memory to a later copy while the consumer's kernels read it.
"""

from __future__ import annotations

import functools
import queue
import threading
import warnings
import weakref
from typing import Any, Callable, Iterator, Optional

import torch

from ..utils.device import DeviceLike, resolve_device

_SENTINEL = object()


def _map_tensors(fn: Callable, item: Any) -> Any:
    if isinstance(item, torch.Tensor):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map_tensors(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map_tensors(fn, v) for v in item)
    return item


def stage_to_device(item: Any, device: torch.device,
                    stream: Optional["torch.cuda.Stream"] = None) -> Any:
    """``item``'s tensors (nested in lists, tuples and dicts) on
    ``device``. To a CUDA device, CPU tensors go through pinned memory
    on ``stream``, and the call returns when the copies have landed."""
    if device.type != "cuda":
        return _map_tensors(lambda t: t.to(device), item)

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.device == device:
            return t
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        staged = _map_tensors(copy, item)
        done = torch.cuda.Event()
        done.record()
    done.synchronize()
    return staged


def _worker(source, q, stop, transfer):
    """Module-level on purpose: the thread must NOT capture the
    Prefetcher, or the running closure would keep it alive and the GC
    finalizer that stops an abandoned prefetcher could never fire."""

    def put_or_stop(obj) -> bool:
        # every put stays interruptible by ``stop``, the sentinel and a
        # terminal exception included, or an abandoned prefetcher with a
        # full queue strands this daemon thread
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in source:
            if stop.is_set():
                return
            if transfer is not None:
                item = transfer(item)
            if not put_or_stop(item):
                return
        put_or_stop(_SENTINEL)
    except BaseException as e:  # re-raised at the consumer
        put_or_stop(e)


def _claim(t: torch.Tensor) -> torch.Tensor:
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


class Prefetcher:
    """Iterate ``source`` on a background thread, applying ``transfer``
    (default ``stage_to_device`` onto ``device``: CUDA unless the caller
    passes ``device="cpu"``; ``None`` queues the items as they come) to
    each item before queueing it, at most ``size`` staged batches ahead.
    Iterable; exceptions from the source or the transfer re-raise in the
    consumer. ``close()`` (or exhausting the source) stops the thread;
    an abandoned handle is stopped by a GC finalizer (the worker holds
    no reference back to it)."""

    def __init__(self, source: Iterator, size: int = 2,
                 transfer: Optional[Callable] = stage_to_device,
                 device: DeviceLike = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        if transfer is stage_to_device:
            device = resolve_device(device)
            stream = torch.cuda.Stream(device) if device.type == "cuda" else None
            transfer = functools.partial(stage_to_device, device=device,
                                         stream=stream)
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_worker,
            args=(source, self._queue, self._stop, transfer),
            daemon=True,
        )
        self._thread.start()
        # dropping the handle without close() stops the thread too
        self._finalizer = weakref.finalize(self, self._stop.set)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # the worker may have queued its last items, the
                    # sentinel or its exception between our timeout and
                    # its exit: drain before quitting, or a pipeline
                    # error would be swallowed
                    try:
                        item = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        raise StopIteration
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return _map_tensors(_claim, item)

    def close(self) -> None:
        """Stop the background thread and drop staged batches."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # a wedged transfer can outlive the join: make it observable
            # instead of returning as if shutdown completed
            warnings.warn(
                "Prefetcher worker did not stop within 5s (transfer "
                "blocked?); thread remains daemon-alive",
                RuntimeWarning,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_to_device(source: Iterator, size: int = 2,
                       transfer: Optional[Callable] = stage_to_device,
                       device: DeviceLike = None) -> Prefetcher:
    """Convenience constructor (see Prefetcher)."""
    return Prefetcher(source, size=size, transfer=transfer, device=device)
