"""Live ``/metrics`` for training runs (counterpart of
``bigdl_tpu/obs/http.py``): the registry's plaintext exposition
(``obs.metrics.MetricsRegistry.render``, the format serving's page uses)
on a daemon-thread HTTP listener inside a training or perf process::

    python -m bigdl_tpu_torch.cli.perf -m resnet50 --obs --metricsPort 9100 &
    curl localhost:9100/metrics     # step-phase histograms, live

GET ``/metrics`` (Prometheus text) and ``/healthz`` (liveness JSON) only,
bound to localhost by default, one thread per connection through the
stdlib ``ThreadingHTTPServer``. A scrape reads instrument snapshots under
their own short locks, so the listener never blocks training, and its
threads die with the process."""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["MetricsServer", "start_metrics_server"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 (stdlib naming)
        if self.path == "/metrics":
            try:
                data = self.server.registry.render().encode()
            except Exception as e:  # a broken gauge fn must not 500-loop
                data = f"# render error: {e}\n".encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif self.path == "/healthz":
            data = json.dumps({"status": "ok"}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            data = json.dumps(
                {"error": f"unknown path {self.path}"}).encode()
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)


class MetricsServer:
    """A running training-side metrics listener; ``close()`` to stop."""

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0):
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.registry = registry  # type: ignore[attr-defined]
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, kwargs={"poll_interval": 0.5},
            name="obs-metrics", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(registry, port: int = 0,
                         host: str = "127.0.0.1", strict: bool = False
                         ) -> Optional[MetricsServer]:
    """Start the listener (port 0 picks a free port; the bound port is
    printed and rides in the perf line's ``obs``). A failed bind is a
    warning returning None (observability must not kill the run it
    observes), unless ``strict`` (the CLI's explicit ``--metricsPort N``)
    makes a taken port a clean SystemExit."""
    try:
        srv = MetricsServer(registry, host=host, port=port)
    except OSError as e:
        if strict:
            raise SystemExit(
                f"--metricsPort {port}: cannot bind {host}:{port} ({e}); "
                "pick another port or use --metricsPort 0 to auto-pick "
                "a free one")
        logger.warning("obs metrics listener failed to bind %s:%d: %s",
                       host, port, e)
        return None
    logger.info("obs metrics listening on %s", srv.url)
    print(f"obs metrics listening on {srv.url}", flush=True)
    return srv
