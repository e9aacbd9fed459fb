"""Per-node device-inventory exporter (port of
``kubeshare_tpu/cmd/collector.py``, same flags): enumerate the node's
GPUs through NVML and serve ``tpu_capacity`` on :9004. On a node without
a driver the endpoint stays up and empty.

    python -m kubeshare_tpu_torch.cmd.collector [--fake-chips N]
"""

from __future__ import annotations

import argparse
import socket
from typing import Optional, Sequence

from ..metrics.collector import (
    COLLECTOR_PORT,
    ChipInfo,
    Collector,
    FakeChipBackend,
    NvmlChipBackend,
    SubcoreBackend,
)
from ..utils.signals import setup_signal_handler
from .common import add_common_flags, component_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeshare-tpu-collector", description=__doc__.split("\n")[0]
    )
    add_common_flags(parser)
    parser.add_argument("--node-name", default=socket.gethostname())
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=COLLECTOR_PORT)
    parser.add_argument(
        "--fake-chips", type=int, default=-1, metavar="N",
        help="serve N synthetic devices instead of enumerating hardware "
             "(dev machines / CI)",
    )
    parser.add_argument(
        "--fake-model", default="tpu-v5e",
        help="device model for --fake-chips inventories",
    )
    parser.add_argument(
        "--subcores", default="off", metavar="off|auto|N",
        help="enumerate per-core rows instead of whole devices: 'auto' "
             "uses the per-model core count, an integer forces a split "
             "factor (MIG instances come from NVML itself)",
    )
    return parser


def make_backend(args: argparse.Namespace):
    if args.fake_chips >= 0:
        backend = FakeChipBackend(
            [
                ChipInfo(
                    uuid=f"{args.node_name}-fake-{i}",
                    model=args.fake_model,
                    memory=16 << 30,
                    index=i,
                )
                for i in range(args.fake_chips)
            ]
        )
    else:
        backend = NvmlChipBackend()
    if args.subcores != "off":
        cores = "auto" if args.subcores == "auto" else int(args.subcores)
        backend = SubcoreBackend(backend, cores)
    return backend


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = component_logger("collector", args)
    collector = Collector(args.node_name, make_backend(args))
    server = collector.serve(host=args.host, port=args.port)
    log.info(
        "collector for node %s serving on %s:%d (%d devices)",
        args.node_name, args.host, server.port,
        len(collector.backend.enumerate()),
    )
    stop = setup_signal_handler()
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
