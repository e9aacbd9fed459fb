"""Mutating admission webhook daemon for CUDA nodes (the twin of
``kubeshare_tpu/cmd/webhook.py``).

    python -m kubeshare_tpu_torch.cmd.webhook --port 9443 \
        --tls-cert /tls/tls.crt --tls-key /tls/tls.key

Serves the AdmissionReview mutate endpoint that puts the library mount
and the CUDA interposer's env into fractional shared pods at creation
(``cluster/webhook.py`` has the protocol and the patches), until SIGINT
or SIGTERM.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..cluster.webhook import WebhookServer
from ..utils.signals import setup_signal_handler
from .common import add_common_flags, component_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeshare-tpu-torch-webhook", description=__doc__
    )
    add_common_flags(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9443)
    parser.add_argument("--tls-cert", default="",
                        help="PEM cert (kube-apiserver requires TLS; "
                             "omit only for local testing)")
    parser.add_argument("--tls-key", default="")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = component_logger("webhook", args)
    server = WebhookServer(
        host=args.host, port=args.port,
        tls_cert=args.tls_cert, tls_key=args.tls_key,
    ).start()
    log.info(
        "admission webhook on %s:%d (%s)", args.host, server.port,
        "tls" if args.tls_cert else "PLAINTEXT - testing only",
    )
    stop = setup_signal_handler()
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
