"""Per-node config daemon (port of ``kubeshare_tpu/cmd/nodeconfig.py``,
same flags): poll the aggregator's ``tpu_requirement`` endpoint for this
node's pods and rewrite the per-device config and port files the
launcher watches.

    python -m kubeshare_tpu_torch.cmd.nodeconfig --aggregator-url URL
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional, Sequence

from ..constants import CONFIG_DIR
from ..metrics.scrape import scrape_requirements
from ..nodeconfig.daemon import NodeConfigDaemon
from ..utils.signals import setup_signal_handler
from .common import add_common_flags, component_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeshare-tpu-nodeconfig", description=__doc__.split("\n")[0]
    )
    add_common_flags(parser)
    parser.add_argument(
        "--node-name", default=os.environ.get("NODE_NAME", socket.gethostname()),
        help="this node's name (downward-API NODE_NAME in-cluster)",
    )
    parser.add_argument(
        "--base-dir", default=os.path.dirname(CONFIG_DIR),
        help="directory holding config/ and podmanagerport/ trees",
    )
    parser.add_argument(
        "--aggregator-url", required=True,
        help="tpu_requirement endpoint (aggregator or Prometheus federate)",
    )
    parser.add_argument("--interval", type=float, default=5.0,
                        help="seconds between syncs")
    parser.add_argument(
        "--chips", default="",
        help="comma-separated local device uuids to pre-create zeroed "
             "files for",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="one sync then exit (CI / cron mode)",
    )
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = component_logger("nodeconfig", args)

    def source():
        try:
            return scrape_requirements(args.aggregator_url, node=args.node_name)
        except OSError as e:
            # an unreachable aggregator must not zero live files: the
            # sync is skipped and the last written state kept
            log.error("scrape %s failed: %s", args.aggregator_url, e)
            raise

    daemon = NodeConfigDaemon(args.node_name, args.base_dir, source, log=log)
    chips = [u for u in args.chips.split(",") if u]
    if chips:
        daemon.ensure_chip_files(chips)
    log.info("nodeconfig for %s -> %s", args.node_name, args.base_dir)
    if args.once:
        try:
            daemon.sync()
        except OSError:
            return 1  # scrape failure already logged by source()
        return 0
    stop = setup_signal_handler()
    while not stop.is_set():
        try:
            daemon.sync()
        except OSError:
            pass  # already logged; retry next tick
        stop.wait(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
