"""The per-device config-file contract the native isolation runtime
reads (a copy of ``kubeshare_tpu/nodeconfig/files.py``; the files are
byte-identical, because the C++ ``tpu-schd`` parses them).

``<base>/config/<uuid>``::

    N
    namespace/name limit request memory
    ...                               (xN)

``<base>/podmanagerport/<uuid>``::

    N
    namespace/name port
    ...                               (xN)

Writes are atomic (temporary file + rename), so the runtime's file
watcher never reads a half-written file.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import List


@dataclass
class ConfigEntry:
    pod: str            # namespace/name
    limit: float
    request: float
    memory: int


@dataclass
class PortEntry:
    pod: str
    port: int


def _atomic_write(path: str, content: str) -> None:
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_config_file(base: str, uuid: str, entries: List[ConfigEntry]) -> str:
    path = os.path.join(base, "config", uuid)
    lines = [str(len(entries))]
    lines += [
        f"{e.pod} {e.limit:g} {e.request:g} {e.memory}" for e in entries
    ]
    _atomic_write(path, "\n".join(lines) + "\n")
    return path


def write_port_file(base: str, uuid: str, entries: List[PortEntry]) -> str:
    path = os.path.join(base, "podmanagerport", uuid)
    lines = [str(len(entries))]
    lines += [f"{e.pod} {e.port}" for e in entries]
    _atomic_write(path, "\n".join(lines) + "\n")
    return path


def _entry_lines(path: str) -> List[str]:
    """The entry lines of a count-prefixed file (none for an empty one)."""
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        return []
    return lines[1 : int(lines[0]) + 1]


def read_config_file(path: str) -> List[ConfigEntry]:
    entries = []
    for line in _entry_lines(path):
        pod, limit, request, memory = line.split()
        entries.append(
            ConfigEntry(pod=pod, limit=float(limit), request=float(request),
                        memory=int(memory))
        )
    return entries


def read_port_file(path: str) -> List[PortEntry]:
    entries = []
    for line in _entry_lines(path):
        pod, port = line.split()
        entries.append(PortEntry(pod=pod, port=int(port)))
    return entries


def list_chip_files(base: str) -> List[str]:
    """The device uuids that have a config file under ``base``."""
    config_dir = os.path.join(base, "config")
    if not os.path.isdir(config_dir):
        return []
    return sorted(
        f for f in os.listdir(config_dir) if not f.startswith(".")
    )
