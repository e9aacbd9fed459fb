"""Tiny threaded HTTP server for metric exposition endpoints (a copy of
``MetricServer`` from ``kubeshare_tpu/utils/httpserv.py``, its exact
routes only).

Each exporter (the collector's inventory, the launcher's per-pod usage)
serves paths whose text exposition a callback produces at scrape time.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict


class MetricServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._routes: Dict[str, Callable[[], str]] = {}
        routes = self._routes

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                fn = routes.get(self.path.partition("?")[0])
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = fn().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # silence per-request stderr noise
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def route(self, path: str, fn: Callable[[], str]) -> None:
        self._routes[path] = fn

    def start(self) -> "MetricServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() waits on an event only serve_forever() sets: guard
        # against stop() before or without start(), which would hang
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
