"""Live metrics export: a stdlib-only HTTP endpoint over a registry.

``MetricsServer`` serves two routes from a daemon thread:

* ``GET /metrics``  — the registry's Prometheus text exposition
  (``MetricsRegistry.to_prometheus()``), rendered at request time so a
  scrape always sees the live counters;
* ``GET /healthz``  — a small JSON liveness document (status, uptime,
  plus whatever the owner passes as ``health_extra``).

Everything is read-only and pure host Python (``http.server`` +
``threading``) — scraping cannot touch device state, so the endpoint is
safe to leave on while the scheduler holds the zero-syncs-per-token
invariant.  ``repro_torch.launch.serve --metrics-port`` is the CLI wiring.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from repro_torch.runtime.telemetry import MetricsRegistry

__all__ = ["MetricsServer", "PROM_CONTENT_TYPE"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Threaded ``/metrics`` + ``/healthz`` endpoint over one registry.

        srv = MetricsServer(registry, port=9090)
        port = srv.start()          # port=0 picks a free one
        ... curl localhost:9090/metrics ...
        srv.stop()
    """

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "127.0.0.1",
                 health_extra: Optional[Callable[[], Dict[str, Any]]] = None
                 ) -> None:
        self.registry = registry
        self.host = host
        self.port = port
        self.health_extra = health_extra
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    def _handler_class(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:        # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = outer.registry.to_prometheus().encode()
                    self._reply(200, PROM_CONTENT_TYPE, body)
                elif path == "/healthz":
                    doc = {"status": "ok",
                           "uptime_s": round(time.time() - outer._t0, 3)}
                    if outer.health_extra is not None:
                        try:
                            doc.update(outer.health_extra())
                        except Exception as e:   # liveness must not 500
                            doc["health_extra_error"] = repr(e)
                    self._reply(200, "application/json",
                                (json.dumps(doc) + "\n").encode())
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass                         # scrapes don't spam stderr

        return Handler

    def start(self) -> int:
        """Bind and serve from a daemon thread; returns the bound port
        (useful with ``port=0``)."""
        if self._httpd is not None:
            return self.port
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler_class())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
