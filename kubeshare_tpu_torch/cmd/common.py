"""Shared CLI plumbing (a copy of ``kubeshare_tpu/cmd/common.py``):
``--level`` verbosity and ``--log-dir`` on every command."""

from __future__ import annotations

import argparse

from ..constants import LOG_DIR
from ..utils.logger import get_logger


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--level", type=int, default=1,
        help="log verbosity 0..3 (WARNING..DEBUG)",
    )
    parser.add_argument(
        "--log-dir", default="",
        help=f"also log to <dir>/<component>.log (e.g. {LOG_DIR})",
    )


def component_logger(component: str, args: argparse.Namespace):
    return get_logger(
        component, level=args.level, log_dir=args.log_dir or None
    )
