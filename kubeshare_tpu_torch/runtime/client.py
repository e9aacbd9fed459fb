"""Token-protocol client (a copy of ``TokenClient`` from
``kubeshare_tpu/runtime/client.py``: pure Python, so the port keeps its
own rather than importing the JAX package).

Speaks the ACQ/REL/MEM/STAT line protocol to a ``tpu-pmgr`` (in-pod)
or directly to a ``tpu-schd`` (tests, node-local tools).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Tuple


class TokenProtocolError(RuntimeError):
    pass


@dataclass
class PodStat:
    pod: str
    window_usage_ms: float
    mem_used: int
    mem_cap: int


class TokenClient:
    """One TCP connection speaking the ACQ/REL/MEM/STAT line protocol."""

    def __init__(self, host: str, port: int, pod: str = "", timeout: float = 30.0):
        self.pod = pod or os.environ.get("KUBESHARE_POD_NAME", "-") or "-"
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
        return float(reply.split()[1])

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
