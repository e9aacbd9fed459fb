"""Graceful-shutdown signal handling (a copy of
``kubeshare_tpu/utils/signals.py``).

The first SIGINT/SIGTERM sets a stop event the daemons poll or wait on;
a second signal exits the process at once.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable

_installed_lock = threading.Lock()
_installed = False


def setup_signal_handler(
    signums: Iterable[int] = (signal.SIGINT, signal.SIGTERM),
) -> threading.Event:
    """Install once-only handlers; returns the stop event. Raises
    RuntimeError on a second call: handlers are process-wide."""
    global _installed
    with _installed_lock:
        if _installed:
            raise RuntimeError("setup_signal_handler called twice")
        _installed = True

    stop = threading.Event()

    def _handler(signum, frame):
        if stop.is_set():
            os._exit(1)  # second signal: hard exit
        stop.set()

    for signum in signums:
        signal.signal(signum, _handler)
    return stop
