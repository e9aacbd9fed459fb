"""Per-node config daemon: requirements -> per-device runtime files (a
copy of ``kubeshare_tpu/nodeconfig/daemon.py``).

On every sync it groups this node's ``tpu_requirement`` samples by
device uuid and rewrites the config and port files; a device whose last
pod vanished is zeroed (``0\\n``), never deleted: the launcher treats a
zeroed file as "stop every pod manager of this device" and a missing
file as "nothing ever ran here".

The requirement source is a callable returning samples (in-process, or
``metrics.scrape.scrape_requirements`` over HTTP). Only fractional
(limit <= 1.0) pods are written: whole-device pods are not time-sliced.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Set

from ..utils import expfmt
from ..utils.logger import get_logger
from .files import (
    ConfigEntry,
    PortEntry,
    list_chip_files,
    write_config_file,
    write_port_file,
)


class NodeConfigDaemon:
    def __init__(
        self,
        node_name: str,
        base_dir: str,
        requirement_source: Callable[[], Sequence[expfmt.Sample]],
        log=None,
    ):
        self.node_name = node_name
        self.base_dir = base_dir
        self.requirement_source = requirement_source
        self.log = log or get_logger("nodeconfig", level=0)

    def sync(self) -> Dict[str, int]:
        """One reconcile pass. Returns {uuid: pod count} written."""
        samples = [
            s
            for s in self.requirement_source()
            if s.labels.get("node") == self.node_name
        ]
        by_uuid: Dict[str, List[expfmt.Sample]] = {}
        for s in samples:
            try:
                if float(s.labels.get("limit", "0")) > 1.0:
                    continue  # whole-device pods are not time-sliced
            except ValueError:
                continue
            for uuid in s.labels.get("uuid", "").split(","):
                if uuid:
                    by_uuid.setdefault(uuid, []).append(s)

        written: Dict[str, int] = {}
        for uuid, pod_samples in by_uuid.items():
            config_entries: List[ConfigEntry] = []
            port_entries: List[PortEntry] = []
            for s in pod_samples:
                labels = s.labels
                pod = f"{labels.get('namespace', 'default')}/{labels.get('pod', '?')}"
                try:
                    # parse every field before touching either list, so a
                    # malformed sample cannot leave the two files (one
                    # contract) disagreeing about which pods exist
                    config_entry = ConfigEntry(
                        pod=pod,
                        limit=float(labels.get("limit", "0")),
                        request=float(labels.get("request", "0")),
                        memory=int(labels.get("memory", "0")),
                    )
                    port_entry = PortEntry(
                        pod=pod, port=int(labels.get("port", "0"))
                    )
                except ValueError as e:
                    self.log.error("skipping malformed sample for %s: %s", pod, e)
                    continue
                config_entries.append(config_entry)
                port_entries.append(port_entry)
            config_entries.sort(key=lambda e: e.pod)
            port_entries.sort(key=lambda e: e.pod)
            write_config_file(self.base_dir, uuid, config_entries)
            write_port_file(self.base_dir, uuid, port_entries)
            written[uuid] = len(config_entries)

        # zero the files of devices that no longer host any pod
        for uuid in self._stale_uuids(set(by_uuid)):
            write_config_file(self.base_dir, uuid, [])
            write_port_file(self.base_dir, uuid, [])
            written[uuid] = 0
        return written

    def _stale_uuids(self, live: Set[str]) -> List[str]:
        return [u for u in list_chip_files(self.base_dir) if u not in live]

    def ensure_chip_files(self, uuids: Sequence[str]) -> None:
        """Pre-create zeroed files for every local device, so the
        launcher can watch them from boot."""
        existing = set(list_chip_files(self.base_dir))
        for uuid in uuids:
            if uuid not in existing:
                write_config_file(self.base_dir, uuid, [])
                write_port_file(self.base_dir, uuid, [])
