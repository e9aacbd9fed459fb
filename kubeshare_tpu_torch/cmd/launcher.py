"""Node isolation-runtime launcher daemon (port of
``kubeshare_tpu/cmd/launcher.py``, same flags): one ``tpu-schd`` per
local device, one ``tpu-pmgr`` per sharing pod, reconciled from the
files the config daemon writes. Without ``--chips`` the devices are the
GPUs NVML enumerates.

    python -m kubeshare_tpu_torch.cmd.launcher [--chips UUID,...]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..constants import CHIP_ARBITER_BASE_PORT, CONFIG_DIR
from ..metrics.collector import NvmlChipBackend
from ..runtime.launcher import NodeLauncher
from ..utils.signals import setup_signal_handler
from .common import add_common_flags, component_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeshare-tpu-launcher", description=__doc__.split("\n")[0]
    )
    add_common_flags(parser)
    parser.add_argument("--base-dir", default=os.path.dirname(CONFIG_DIR))
    parser.add_argument(
        "--chips", default="",
        help="comma-separated device uuids; default: the GPUs NVML "
             "enumerates",
    )
    parser.add_argument("--schd-binary", default="")
    parser.add_argument("--pmgr-binary", default="")
    parser.add_argument("--base-port", type=int, default=CHIP_ARBITER_BASE_PORT)
    parser.add_argument("--base-quota-ms", type=float, default=300.0)
    parser.add_argument("--min-quota-ms", type=float, default=20.0)
    parser.add_argument("--window-ms", type=float, default=10000.0)
    parser.add_argument(
        "--lease-slots", type=int, default=2,
        help="concurrent compute leases per device (1 = strict reference "
             "semantics; 2 hides per-hold drain latency)",
    )
    parser.add_argument("--poll-interval", type=float, default=0.5)
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve per-pod arbiter state on this port (0 = off): "
             "tpu_pod_window_usage_ms, tpu_pod_hbm_used_bytes, "
             "tpu_pod_hbm_cap_bytes, tpu_chip_arbiter_up",
    )
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = component_logger("launcher", args)
    chips = [u for u in args.chips.split(",") if u]
    if not chips:
        backend = NvmlChipBackend()
        chips = [c.uuid for c in backend.enumerate()]
        backend.close()
    if not chips:
        log.warning("no local devices; launcher idle (device-less node)")
    launcher = NodeLauncher(
        base_dir=args.base_dir,
        chip_uuids=chips,
        schd_binary=args.schd_binary,
        pmgr_binary=args.pmgr_binary,
        base_port=args.base_port,
        base_quota_ms=args.base_quota_ms,
        min_quota_ms=args.min_quota_ms,
        window_ms=args.window_ms,
        lease_slots=args.lease_slots,
        log=log,
    )
    metrics_server = None
    if args.metrics_port:
        metrics_server = launcher.serve_metrics(port=args.metrics_port)
        log.info("usage metrics on :%d/metrics", metrics_server.port)
    stop = setup_signal_handler()
    try:
        launcher.run(poll_interval=args.poll_interval, stop=stop)
    except KeyboardInterrupt:
        pass  # run()'s finally already tore the children down
    finally:
        if metrics_server is not None:
            metrics_server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
