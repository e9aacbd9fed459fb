"""A live ``tpu-schd`` token arbiter for benchmarks, and their thread
fan-out (copies of ``start_arbiter``, ``stop_arbiter``, ``run_threads``
and ``p99`` from ``bench_common.py``).

The arbiter is the native isolation runtime's per-device scheduler
(``runtime_native/tpu_schd.cc``). When its binary is missing it is
built with ``make -C runtime_native build/tpu-schd`` (g++ only). Where
``bench_common.start_arbiter`` returns None when the arbiter cannot
start, this copy raises: a gated benchmark without its arbiter is not
the benchmark.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Callable, List, Sequence

from ..nodeconfig.files import ConfigEntry, write_config_file
from ..runtime.client import TokenClient

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE = os.path.join(REPO, "runtime_native")
SCHD = os.path.join(NATIVE, "build", "tpu-schd")


def build_schd() -> str:
    """The path of ``tpu-schd``, built first if it is missing."""
    if not os.path.exists(SCHD):
        out = subprocess.run(["make", "-C", NATIVE, "build/tpu-schd"],
                             capture_output=True, text=True)
        if out.returncode != 0 or not os.path.exists(SCHD):
            raise RuntimeError(f"building {SCHD} failed:\n{out.stderr}")
    return SCHD


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_arbiter(
    tmpdir: str,
    chip: str,
    entries: Sequence[ConfigEntry],
    port: int,
    base_quota_ms: float = 20,
    min_quota_ms: float = 2,
    window_ms: float = 1000,
    slots: int = 2,
) -> subprocess.Popen:
    """Spawn a real tpu-schd on ``port`` over a fresh config file and
    return the process once it answers; raise if it does not."""
    schd = build_schd()
    write_config_file(tmpdir, chip, list(entries))
    proc = subprocess.Popen(
        [schd, "-p", os.path.join(tmpdir, "config"), "-f", chip,
         "-P", str(port), "-q", str(base_quota_ms), "-m", str(min_quota_ms),
         "-w", str(window_ms), "-c", str(slots), "-H", "127.0.0.1"],
        stderr=subprocess.DEVNULL,
    )
    for _ in range(100):
        try:
            TokenClient("127.0.0.1", port, pod="probe").close()
            return proc
        except OSError:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    stop_arbiter(proc)
    raise RuntimeError(f"tpu-schd did not answer on port {port} "
                       f"(exit code {proc.returncode})")


def stop_arbiter(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def p99(values: Sequence[float]) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]


def run_threads(workers: List[Callable[[], None]]) -> float:
    """Run workers concurrently; re-raise the first worker exception (a
    benchmark must fail loudly, not emit a bogus number). Returns the
    elapsed wall seconds."""
    errors: List[BaseException] = []

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)
        return run

    threads = [threading.Thread(target=guard(fn)) for fn in workers]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0
