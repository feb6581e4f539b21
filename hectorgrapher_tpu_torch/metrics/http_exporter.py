"""Prometheus HTTP scrape endpoint (counterpart of
hectorgrapher_tpu/metrics/http_exporter.py), serving this package's
process-wide registry (metrics.GLOBAL_FACTORY) unless given another.

(ref: cloud/map_builder_server_main.cc:40-46 — the server main starts
prometheus::Exposer on :9100 and registers the metrics registry with it.)

A stdlib ThreadingHTTPServer serving GET /metrics with the text exposition
format from FamilyFactory.text_format; /healthz answers liveness probes.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from hectorgrapher_tpu_torch.metrics.metrics import GLOBAL_FACTORY, FamilyFactory

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Serve a FamilyFactory over HTTP for Prometheus scrapes."""

    def __init__(self, factory: Optional[FamilyFactory] = None, address: str = "127.0.0.1", port: int = 9100):
        self._factory = factory or GLOBAL_FACTORY
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path in ("/metrics", "/"):
                    body = exporter._factory.text_format().encode() + b"\n"
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    self.send_response(200)
                    self.send_header("Content-Length", "3")
                    self.end_headers()
                    self.wfile.write(b"ok\n")
                else:
                    self.send_error(404)

            def log_message(self, *args):  # quiet: scrapes are periodic
                pass

        # port=0 picks a free port (tests); real deployments pass 9100.
        self._server = ThreadingHTTPServer((address, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(target=self._server.serve_forever, name="metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
