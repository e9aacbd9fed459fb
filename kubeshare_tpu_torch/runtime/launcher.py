"""Node launcher: one arbiter per device, one pod manager per pod (a
port of ``kubeshare_tpu/runtime/launcher.py``).

For every local device it makes sure a config file exists (zeroed),
starts one ``tpu-schd`` (port = base + the device's index), and keeps
one ``tpu-pmgr`` per entry of the device's podmanagerport file. File
changes are found by polling mtimes; a vanished pod's manager is
SIGKILLed, and a dead child of either kind is restarted. The binaries
are built with g++ at first use (``runtime/native.py``: the port's
``tpu-schd``, ``runtime_native``'s ``tpu-pmgr``), else taken from the
node's library directory.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..constants import CHIP_ARBITER_BASE_PORT, LIBRARY_PATH
from ..nodeconfig.files import PortEntry, read_port_file
from ..utils import expfmt
from ..utils.httpserv import MetricServer
from ..utils.logger import get_logger
from .client import TokenClient
from .native import build_binary


def default_binary(name: str) -> str:
    """``native.build_binary(name)``, made up to date first; where it
    cannot be built, the node's installed copy. Raises if neither
    exists."""
    try:
        return build_binary(name)
    except RuntimeError:
        installed = os.path.join(LIBRARY_PATH, name)
        if os.path.exists(installed):
            return installed
        raise


@dataclass
class ChipRuntime:
    uuid: str
    port: int
    scheduler_proc: Optional[subprocess.Popen] = None
    pod_managers: Dict[str, subprocess.Popen] = field(default_factory=dict)
    desired: Dict[str, PortEntry] = field(default_factory=dict)
    port_file_mtime: float = -1.0


class NodeLauncher:
    def __init__(
        self,
        base_dir: str,
        chip_uuids: Sequence[str],
        schd_binary: str = "",
        pmgr_binary: str = "",
        base_port: int = CHIP_ARBITER_BASE_PORT,
        base_quota_ms: float = 300.0,
        min_quota_ms: float = 20.0,
        window_ms: float = 10000.0,
        lease_slots: int = 2,
        log=None,
    ):
        self.base_dir = base_dir
        self.schd_binary = schd_binary or default_binary("tpu-schd")
        self.pmgr_binary = pmgr_binary or default_binary("tpu-pmgr")
        self.base_quota_ms = base_quota_ms
        self.min_quota_ms = min_quota_ms
        self.window_ms = window_ms
        self.lease_slots = lease_slots
        self.log = log or get_logger("launcher", level=1)
        self.chips: Dict[str, ChipRuntime] = {
            uuid: ChipRuntime(uuid=uuid, port=base_port + i)
            for i, uuid in enumerate(chip_uuids)
        }

    # ---- arbiter fan-out -------------------------------------------

    def start_arbiters(self) -> None:
        config_dir = os.path.join(self.base_dir, "config")
        os.makedirs(config_dir, exist_ok=True)
        for chip in self.chips.values():
            path = os.path.join(config_dir, chip.uuid)
            if not os.path.exists(path):
                with open(path, "w") as f:
                    f.write("0\n")
            self._spawn_schd(chip)

    def _spawn_schd(self, chip: ChipRuntime) -> None:
        config_dir = os.path.join(self.base_dir, "config")
        chip.scheduler_proc = subprocess.Popen(
            [
                self.schd_binary,
                "-p", config_dir,
                "-f", chip.uuid,
                "-P", str(chip.port),
                "-q", str(self.base_quota_ms),
                "-m", str(self.min_quota_ms),
                "-w", str(self.window_ms),
                "-c", str(self.lease_slots),
            ],
        )
        self.log.info(
            "tpu-schd for device %s on port %d (pid %d)",
            chip.uuid, chip.port, chip.scheduler_proc.pid,
        )

    # ---- pod-manager reconciliation --------------------------------

    def reconcile(self) -> None:
        """One pass: (a) restart any dead child, since a crashed arbiter
        or pod manager must not silently disable isolation; (b) diff
        every device's port file against the desired set; start the
        new managers, kill the vanished ones."""
        for chip in self.chips.values():
            # (a) liveness, independent of file changes
            if (
                chip.scheduler_proc is not None
                and chip.scheduler_proc.poll() is not None
            ):
                self.log.error(
                    "tpu-schd for device %s died (rc=%s), restarting",
                    chip.uuid, chip.scheduler_proc.returncode,
                )
                self._spawn_schd(chip)
            for key, proc in list(chip.pod_managers.items()):
                if proc.poll() is not None:
                    self.log.error("pod manager %s died, restarting", key)
                    del chip.pod_managers[key]
                    entry = chip.desired.get(key)
                    if entry is not None:
                        chip.pod_managers[key] = self._spawn_pmgr(chip, entry)

            # (b) port-file diff
            path = os.path.join(self.base_dir, "podmanagerport", chip.uuid)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if mtime == chip.port_file_mtime:
                continue
            chip.port_file_mtime = mtime
            try:
                entries = read_port_file(path)
            except (OSError, ValueError) as e:
                self.log.error("bad port file %s: %s", path, e)
                continue
            chip.desired = {f"{e.pod}:{e.port}": e for e in entries}
            for key, proc in list(chip.pod_managers.items()):
                if key not in chip.desired:
                    self._kill(proc)
                    del chip.pod_managers[key]
                    self.log.info("pod manager %s stopped", key)
            for key, entry in chip.desired.items():
                if key not in chip.pod_managers:
                    chip.pod_managers[key] = self._spawn_pmgr(chip, entry)
                    self.log.info(
                        "pod manager %s started on port %d", key, entry.port
                    )

    def _spawn_pmgr(self, chip: ChipRuntime, entry: PortEntry
                    ) -> subprocess.Popen:
        env = os.environ.copy()
        env.update(
            {
                "SCHEDULER_IP": "127.0.0.1",
                "SCHEDULER_PORT": str(chip.port),
                "POD_MANAGER_IP": "0.0.0.0",
                "POD_MANAGER_PORT": str(entry.port),
                "POD_NAME": entry.pod,
            }
        )
        return subprocess.Popen(
            [self.pmgr_binary], env=env, start_new_session=True
        )

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
        proc.wait()

    def usage_samples(self) -> List[expfmt.Sample]:
        """Per-pod isolation state straight from the live arbiters:
        ``tpu_pod_window_usage_ms{chip,pod}`` (ms of compute-token hold
        inside the arbiter's sliding window), ``tpu_pod_hbm_used_bytes``
        and ``tpu_pod_hbm_cap_bytes`` (the memory the interposer charged
        against the pod's cap; cap 0 = uncapped), and an up gauge per
        device."""
        samples = []
        for chip in self.chips.values():
            up = 0.0
            try:
                # short timeout: one wedged arbiter must not stall the
                # whole scrape; broad except: a death mid-conversation
                # raises protocol and parse errors, not just OSError,
                # and a scrape degrades to up=0, it never aborts
                with TokenClient(
                    "127.0.0.1", chip.port, pod="launcher-metrics",
                    timeout=2.0,
                ) as client:
                    for stat in client.stats():
                        labels = {"chip": chip.uuid, "pod": stat.pod}
                        samples.append(expfmt.Sample(
                            "tpu_pod_window_usage_ms", labels,
                            stat.window_usage_ms,
                        ))
                        samples.append(expfmt.Sample(
                            "tpu_pod_hbm_used_bytes", labels,
                            float(stat.mem_used),
                        ))
                        samples.append(expfmt.Sample(
                            "tpu_pod_hbm_cap_bytes", labels,
                            float(stat.mem_cap),
                        ))
                up = 1.0
            except Exception:
                pass  # arbiter restarting; reconcile will respawn it
            samples.append(expfmt.Sample(
                "tpu_chip_arbiter_up", {"chip": chip.uuid}, up
            ))
        return samples

    def serve_metrics(self, host: str = "0.0.0.0", port: int = 0
                      ) -> MetricServer:
        """Start a /metrics endpoint over :meth:`usage_samples`."""
        server = MetricServer(host=host, port=port)
        server.route("/metrics", lambda: expfmt.render(self.usage_samples()))
        return server.start()

    def run(self, poll_interval: float = 0.5, stop=None) -> None:
        """Reconcile until ``stop`` (a threading.Event) is set, or
        forever if none is given. Children are always torn down on
        exit."""
        self.start_arbiters()
        try:
            while stop is None or not stop.is_set():
                self.reconcile()
                if stop is None:
                    time.sleep(poll_interval)
                elif stop.wait(poll_interval):
                    break
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        for chip in self.chips.values():
            for proc in chip.pod_managers.values():
                self._kill(proc)
            chip.pod_managers.clear()
            if chip.scheduler_proc is not None:
                if chip.scheduler_proc.poll() is None:
                    chip.scheduler_proc.kill()
                chip.scheduler_proc.wait()
                chip.scheduler_proc = None
