"""A live ``tpu-schd`` token arbiter and ``tpu-pmgr`` pod managers for
benchmarks, and their thread fan-out (copies of ``start_arbiter``,
``stop_arbiter``, ``run_threads`` and ``p99`` from ``bench_common.py``).

The arbiter is the port's per-device scheduler
(``runtime/csrc/tpu_schd.cc``), a pod manager the native isolation
runtime's per-pod bridge (``runtime_native/tpu_pmgr.cc``), which pins
the pod's identity on every command it forwards: a bench or a pod can
then run pod -> ``tpu-pmgr`` -> ``tpu-schd`` as a node deploys them.
Both are built with g++ at first use
(``runtime/native.py::build_binary``). Where ``bench_common.start_arbiter``
returns None when the arbiter cannot start, this copy raises: a gated
benchmark without its arbiter is not the benchmark.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..nodeconfig.files import ConfigEntry, write_config_file
from ..runtime.client import TokenClient
from ..runtime.native import build_binary

# a tpu-schd binary to run in place of the port's build (tests)
SCHD: Optional[str] = None


def available() -> bool:
    """Whether the arbiter can run here: the port's tpu-schd builds."""
    try:
        build_binary("tpu-schd")
    except RuntimeError:
        return False
    return True


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
    schd = SCHD or build_binary("tpu-schd")
    write_config_file(tmpdir, chip, list(entries))
    proc = subprocess.Popen(
        [schd, "-p", os.path.join(tmpdir, "config"), "-f", chip,
         "-P", str(port), "-q", str(base_quota_ms), "-m", str(min_quota_ms),
         "-w", str(window_ms), "-c", str(slots), "-H", "127.0.0.1"],
        stderr=subprocess.DEVNULL,
    )
    return _answering(proc, "tpu-schd", port)


def start_pod_manager(pod: str, port: int, arbiter_port: int,
                      host: str = "127.0.0.1") -> subprocess.Popen:
    """Spawn a real tpu-pmgr for ``pod`` on ``port``, forwarding to the
    arbiter on ``arbiter_port``, and return it once it answers; raise if
    it does not."""
    pmgr = build_binary("tpu-pmgr")
    env = dict(os.environ, SCHEDULER_IP="127.0.0.1",
               SCHEDULER_PORT=str(arbiter_port), POD_MANAGER_IP=host,
               POD_MANAGER_PORT=str(port), POD_NAME=pod)
    proc = subprocess.Popen([pmgr], env=env, stderr=subprocess.DEVNULL)
    return _answering(proc, "tpu-pmgr", port)


def _answering(proc: subprocess.Popen, name: str, port: int
               ) -> subprocess.Popen:
    for _ in range(100):
        try:
            TokenClient("127.0.0.1", port, pod="probe").close()
            return proc
        except OSError:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    stop_arbiter(proc)
    raise RuntimeError(f"{name} did not answer on port {port} "
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
