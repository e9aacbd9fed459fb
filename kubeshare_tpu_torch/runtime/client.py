"""Token-protocol clients (copies of ``TokenClient``,
``load_native_library`` and ``NativeTokenClient`` from
``kubeshare_tpu/runtime/client.py``: the port keeps its own rather than
importing the JAX package).

``TokenClient`` is pure Python; ``NativeTokenClient`` binds the native
runtime's ``libtpuhook.so`` with ``ctypes`` (built with ``make -C
runtime_native build/libtpuhook.so`` when it is missing). Both speak
the ACQ/REL/MEM/STAT line protocol to a ``tpu-pmgr`` (in-pod) or
directly to a ``tpu-schd`` (tests, node-local tools).
"""

from __future__ import annotations

import ctypes
import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..constants import ENV_POD_NAME, LIBRARY_PATH


class TokenProtocolError(RuntimeError):
    pass


@dataclass
class PodStat:
    pod: str
    window_usage_ms: float
    mem_used: int
    mem_cap: int


class TokenClient:
    """One TCP connection speaking the ACQ/REL/MEM/STAT line protocol.

    ``waited`` is the last grant's ``(waited_ms, throttled_ms)``: how
    long the arbiter held the ACQ in all, and the part of it the pod was
    past its limit (``(0.0, 0.0)`` when the reply does not say)."""

    def __init__(self, host: str, port: int, pod: str = "", timeout: float = 30.0):
        self.pod = pod or os.environ.get(ENV_POD_NAME, "-") or "-"
        self.waited: Tuple[float, float] = (0.0, 0.0)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._file = self._sock.makefile("rw", newline="\n")

    def _roundtrip(self, line: str) -> str:
        self._file.write(line + "\n")
        self._file.flush()
        reply = self._file.readline()
        if not reply:
            raise TokenProtocolError(f"connection closed after {line!r}")
        return reply.strip()

    def acquire(self, est_ms: float = 0.0, timeout: Optional[float] = None) -> float:
        """Block until a compute token is granted; returns quota ms
        (None timeout = wait indefinitely for the token)."""
        previous = self._sock.gettimeout()
        self._sock.settimeout(timeout)
        try:
            reply = self._roundtrip(f"ACQ {self.pod} {est_ms:.3f}")
        finally:
            self._sock.settimeout(previous)
        if not reply.startswith("TOK "):
            raise TokenProtocolError(f"unexpected ACQ reply {reply!r}")
        # "TOK <quota_ms>" from runtime_native's tpu-schd; the port's
        # (csrc/tpu_schd.cc) adds "<waited_ms> <throttled_ms>"
        parts = reply.split()
        self.waited = ((float(parts[2]), float(parts[3])) if len(parts) >= 4
                       else (0.0, 0.0))
        return float(parts[1])

    def release(self, used_ms: float) -> None:
        reply = self._roundtrip(f"REL {self.pod} {used_ms:.3f}")
        if reply != "OK":
            raise TokenProtocolError(f"unexpected REL reply {reply!r}")

    def request_memory(self, delta_bytes: int) -> Tuple[bool, int, int]:
        """Account an HBM delta. Returns (granted, used, cap)."""
        reply = self._roundtrip(f"MEM {self.pod} {delta_bytes}")
        parts = reply.split()
        if len(parts) != 3 or parts[0] not in ("OK", "DENY"):
            raise TokenProtocolError(f"unexpected MEM reply {reply!r}")
        return parts[0] == "OK", int(parts[1]), int(parts[2])

    def stats(self) -> List[PodStat]:
        reply = self._roundtrip("STAT")
        if not reply.startswith("STAT "):
            raise TokenProtocolError(f"unexpected STAT reply {reply!r}")
        n = int(reply.split()[1])
        out = []
        for _ in range(n):
            line = self._file.readline().strip()
            pod, usage, used, cap = line.split()
            out.append(PodStat(pod, float(usage), int(used), int(cap)))
        return out

    def ping(self) -> bool:
        return self._roundtrip("PING") == "PONG"

    def close(self) -> None:
        try:
            self._file.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_native_library(path: Optional[str] = None) -> ctypes.CDLL:
    """``libtpuhook.so``: ``path``, else the in-repo build (made first
    if it is missing), else the node's library directory."""
    if path:
        candidates = [path]
    else:
        from .native import build_binary

        try:
            candidates = [build_binary("libtpuhook.so")]
        except RuntimeError:
            candidates = []
        candidates.append(os.path.join(LIBRARY_PATH, "libtpuhook.so"))
    last_error: Optional[Exception] = None
    for candidate in candidates:
        if candidate and os.path.exists(candidate):
            try:
                lib = ctypes.CDLL(os.path.abspath(candidate))
            except OSError as e:
                last_error = e
                continue
            lib.tpuhook_connect.restype = ctypes.c_void_p
            lib.tpuhook_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.tpuhook_acquire.restype = ctypes.c_double
            lib.tpuhook_acquire.argtypes = [ctypes.c_void_p, ctypes.c_double]
            lib.tpuhook_release.restype = ctypes.c_int
            lib.tpuhook_release.argtypes = [ctypes.c_void_p, ctypes.c_double]
            lib.tpuhook_mem.restype = ctypes.c_int
            lib.tpuhook_mem.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
            lib.tpuhook_close.restype = None
            lib.tpuhook_close.argtypes = [ctypes.c_void_p]
            return lib
    raise FileNotFoundError(
        f"libtpuhook.so not found in {candidates}: {last_error}"
    )


class NativeTokenClient:
    """ctypes wrapper over libtpuhook.so (the surface of TokenClient
    without ``stats``; ``request_memory`` reports only the verdict)."""

    def __init__(self, host: str, port: int, lib_path: Optional[str] = None):
        self._lib = load_native_library(lib_path)
        self._handle = self._lib.tpuhook_connect(host.encode(), port)
        if not self._handle:
            raise ConnectionError(f"libtpuhook: cannot connect to {host}:{port}")

    def acquire(self, est_ms: float = 0.0) -> float:
        quota = self._lib.tpuhook_acquire(self._handle, est_ms)
        if quota < 0:
            raise TokenProtocolError("native acquire failed")
        return quota

    def release(self, used_ms: float) -> None:
        if self._lib.tpuhook_release(self._handle, used_ms) != 0:
            raise TokenProtocolError("native release failed")

    def request_memory(self, delta_bytes: int) -> Tuple[bool, int, int]:
        result = self._lib.tpuhook_mem(self._handle, delta_bytes)
        if result < 0:
            raise TokenProtocolError("native mem call failed")
        return bool(result), 0, 0

    def close(self) -> None:
        if self._handle:
            self._lib.tpuhook_close(self._handle)
            self._handle = None
