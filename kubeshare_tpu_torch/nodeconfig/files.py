"""The per-device config file ``tpu-schd`` reads (a copy of
``ConfigEntry`` and ``write_config_file`` from
``kubeshare_tpu/nodeconfig/files.py``).

``<base>/config/<uuid>``::

    N
    namespace/name limit request memory
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
