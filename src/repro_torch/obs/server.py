"""Operational endpoints: Prometheus text exposition (a copy of
``repro.obs.server``).

``MetricsServer`` is a daemon-thread HTTP server exposing the active
registry as ``/metrics`` (Prometheus text format 0.0.4) and
``/metrics.json`` (the JSON snapshot) — the scrape surface for service
mode (``serve --service --metrics-port``).

``start_profiler_server`` is the reference's hook for attaching a
profiler to a live serving process.  torch has no profiler server, so it
returns None, the reference's "unavailable" answer, and the caller says
so and continues.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["MetricsServer", "start_metrics_server",
           "start_profiler_server"]


class MetricsServer:
    """Threaded HTTP exposition of one ``MetricsRegistry``."""

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(outer.registry.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = outer.registry.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not launcher output
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-metrics", daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def start_metrics_server(registry, port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start the exposition thread; ``port=0`` binds an ephemeral port
    (read it back from ``.port``)."""
    return MetricsServer(registry, port=port, host=host).start()


def start_profiler_server(port: int):
    """None: torch has no profiler server to attach to (the caller
    reports and continues — observability must never take the service
    down).  Trace a run with ``--trace-out`` or ``torch.profiler``
    instead."""
    return None
