"""Stdlib HTTP serving surface, JSON in and out (counterpart of
``bigdl_tpu/serving/server.py``):

* ``POST /predict``  — ``{"inputs": [...]}`` -> argmax predictions (scores
  with ``"return_scores": true``), through the micro-batcher;
* ``POST /generate`` — ``{"tokens": [...], "max_new_tokens": N}`` ->
  generated ids from the continuous-batching decoder; optional
  ``temperature`` / ``top_k`` / ``top_p`` / ``seed``;
* ``GET /healthz`` (liveness), ``/readyz`` (every worker healthy and no
  overload shed), ``/metrics`` (plaintext, with config provenance).

Errors: malformed input 400, admission rejection or overload shed 429
with ``Retry-After``, deadline expired before compute 504, dead or wedged
worker or timeout 503, engine failure 500; every error body is
``{"error": ...}``. Under overload ``/generate`` sheds first while
``/predict`` keeps admitting. Streaming (``"stream": true``), request
tracing, fault injection and replicas are not ported yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             WorkerDied)

logger = logging.getLogger(__name__)

__all__ = ["ServingApp", "make_server", "run_server"]

_MAX_BODY = 64 * 1024 * 1024  # refuse absurd payloads before np.asarray


class ServingApp:
    """The wiring between HTTP handlers and the serving stack: engine and
    batcher for /predict, decoder for /generate, one metrics registry.
    Handlers return ``(status, payload_dict)``, testable without sockets.

    ``default_deadline_ms`` bounds every request (a request's
    ``"deadline_ms"`` overrides it); past ``shed_generate_frac`` of either
    queue's capacity ``/generate`` sheds with 429; ``watchdog`` gives the
    readiness verdict for ``/readyz``."""

    def __init__(self, *, name: str, metrics, engine=None, batcher=None,
                 decoder=None, request_timeout_s: float = 120.0,
                 default_deadline_ms: Optional[float] = None,
                 shed_generate_frac: float = 0.75, watchdog=None):
        self.name = name
        self.metrics = metrics
        self.engine, self.batcher, self.decoder = engine, batcher, decoder
        self.watchdog = watchdog
        self.clock = time.monotonic
        self.request_timeout_s = float(request_timeout_s)
        self.default_deadline_ms = (float(default_deadline_ms)
                                    if default_deadline_ms else None)
        if not 0.0 < shed_generate_frac <= 1.0:
            raise ValueError(f"shed_generate_frac must be in (0, 1], "
                             f"got {shed_generate_frac}")
        self.shed_generate_frac = float(shed_generate_frac)
        self._m_requests = {
            ep: metrics.counter(f"requests_{ep}_total",
                                f"completed /{ep} requests")
            for ep in ("predict", "generate")}
        self._m_errors = metrics.counter(
            "request_errors_total", "requests answered 4xx/5xx")
        self._m_expired = metrics.counter(
            "requests_expired_total",
            "requests answered 504 (deadline expired before compute)")
        self._m_shed = metrics.counter(
            "requests_shed_total",
            "requests shed 429 by tiered overload degradation")
        self._m_worker_dead = metrics.counter(
            "requests_worker_dead_total",
            "requests answered 503 fast (dead/wedged worker)")
        self._m_latency = {
            ep: metrics.histogram(f"latency_{ep}_ms",
                                  f"/{ep} request latency (receipt to "
                                  f"response ready)")
            for ep in ("predict", "generate")}

    def _deadline_from(self, payload: dict) -> Optional[float]:
        ms = payload.get("deadline_ms", self.default_deadline_ms)
        if ms is None:
            return None
        return self.clock() + float(ms) / 1000.0

    def _shed_generate(self) -> bool:
        frac = self.shed_generate_frac
        if (self.batcher is not None
                and self.batcher.queue_depth
                >= frac * self.batcher.max_queue):
            return True
        return (self.decoder is not None
                and len(self.decoder._waiting)
                >= frac * self.decoder.max_waiting)

    # ------------------------------------------------------------ endpoints
    def handle_healthz(self):
        return 200, {"status": "ok", "model": self.name}

    def handle_readyz(self):
        detail = {"model": self.name}
        ok = True
        if self.watchdog is not None and not self.watchdog.ready():
            ok = False
            detail["failed_workers"] = self.watchdog.failures
        for comp_name, comp in (("batcher", self.batcher),
                                ("decoder", self.decoder)):
            if comp is not None and not comp.alive():
                ok = False
                detail.setdefault("dead", []).append(comp_name)
        if self._shed_generate():
            detail["shedding"] = "generate"
        detail["status"] = "ready" if ok else "unready"
        return (200 if ok else 503), detail

    def handle_predict(self, payload: dict):
        if self.engine is None:
            return 400, {"error": "no /predict engine for this model"}
        inputs = payload.get("inputs")
        if inputs is None:
            return 400, {"error": "missing 'inputs'"}
        try:
            x = np.asarray(inputs)
            if x.dtype == object:
                raise ValueError("ragged inputs")
            if np.issubdtype(x.dtype, np.floating):
                x = x.astype(np.float32)
            elif np.issubdtype(x.dtype, np.integer):
                x = x.astype(np.int32)
            else:
                raise ValueError(f"unsupported dtype {x.dtype}")
            if x.ndim < 2:
                raise ValueError("inputs must be a batch (rows on axis 0)")
            self.engine.validate(x)
        except ValueError as e:
            return 400, {"error": f"bad inputs: {e}"}
        deadline = self._deadline_from(payload)
        if self.batcher is not None:
            futs = [self.batcher.submit(row, deadline=deadline) for row in x]
            scores = np.stack([f.result(self.request_timeout_s)
                               for f in futs])
        else:
            if deadline is not None and self.clock() >= deadline:
                raise DeadlineExceeded("deadline expired before compute")
            scores = self.engine.predict_scores(x)
        out = {"predictions": np.argmax(scores, axis=-1).tolist()}
        if payload.get("return_scores"):
            out["scores"] = np.asarray(scores, np.float64).tolist()
        return 200, out

    def handle_generate(self, payload: dict):
        if self.decoder is None:
            return 400, {"error": "no /generate decoder for this model "
                                  "(serve a transformer_lm* model)"}
        if payload.get("stream"):
            return 400, {"error": "streaming /generate is not ported yet; "
                                  "omit 'stream'"}
        tokens = payload.get("tokens")
        if (not isinstance(tokens, (list, tuple)) or not tokens
                or not all(isinstance(t, int) for t in tokens)):
            return 400, {"error": "'tokens' must be a non-empty list of ints"}
        try:
            fut = self.decoder.submit(
                tokens, payload.get("max_new_tokens", 16),
                payload.get("temperature", 0.0), payload.get("stop_token"),
                deadline=self._deadline_from(payload),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                seed=int(payload.get("seed", 0)))
        except (TypeError, ValueError) as e:
            return 400, {"error": str(e)}
        return 200, {"tokens": fut.result(self.request_timeout_s),
                     "prompt_len": len(tokens)}

    def handle_metrics(self) -> str:
        return self.metrics.render()

    def dispatch_post(self, path: str, payload: dict):
        ep = path.strip("/")
        handler = {"predict": self.handle_predict,
                   "generate": self.handle_generate}.get(ep)
        if handler is None:
            return 404, {"error": f"unknown endpoint {path}"}
        if ep == "generate" and self._shed_generate():
            self._m_shed.inc()
            self._m_errors.inc()
            return 429, {"error": "overloaded: shedding /generate "
                                  "(retry, or use /predict capacity)"}
        t0 = time.perf_counter()
        try:
            status, body = handler(payload)
        except AdmissionError as e:
            status, body = 429, {"error": str(e)}
        except DeadlineExceeded as e:
            self._m_expired.inc()
            status, body = 504, {"error": f"deadline exceeded: {e}"}
        except WorkerDied as e:
            self._m_worker_dead.inc()
            status, body = 503, {"error": str(e)}
        except TimeoutError as e:
            status, body = 503, {"error": str(e)}
        except Exception as e:
            logger.exception("/%s failed", ep)
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        if status == 200:
            self._m_requests[ep].inc()
            self._m_latency[ep].observe((time.perf_counter() - t0) * 1000.0)
        else:
            self._m_errors.inc()
        return status, body

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.batcher is not None:
            self.batcher.close()
        if self.engine is not None:
            self.engine.close()
        if self.decoder is not None:
            self.decoder.close()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> ServingApp:
        return self.server.app  # type: ignore[attr-defined]

    def _send(self, status: int, data: bytes, ctype: str) -> None:
        self.send_response(status)
        if status == 429:
            self.send_header("Retry-After", "1")
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, status: int, body: dict) -> None:
        self._send(status, json.dumps(body).encode(), "application/json")

    def do_GET(self):  # noqa: N802 (stdlib naming)
        if self.path == "/healthz":
            self._send_json(*self.app.handle_healthz())
        elif self.path == "/readyz":
            self._send_json(*self.app.handle_readyz())
        elif self.path == "/metrics":
            self._send(200, self.app.handle_metrics().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > _MAX_BODY:
            self._send_json(400, {"error": "missing or oversized body"})
            return
        try:
            payload = json.loads(self.rfile.read(length))
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            self._send_json(400, {"error": f"bad JSON: {e}"})
            return
        self._send_json(*self.app.dispatch_post(self.path, payload))

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's 5 drops the connects of a burst of
    # concurrent clients past it, which TCP retries only after 1 s
    request_queue_size = 128


def make_server(app: ServingApp, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and attach the app; the caller runs
    ``serve_forever``."""
    srv = _Server((host, port), _Handler)
    srv.app = app  # type: ignore[attr-defined]
    return srv


def run_server(app: ServingApp, host: str = "127.0.0.1",
               port: int = 8000) -> int:
    """Foreground serve loop with clean SIGINT/SIGTERM shutdown."""
    import signal

    srv = make_server(app, host, port)
    print(f"serving {app.name} on http://{host}:{srv.server_address[1]}",
          flush=True)

    def _stop(signum, frame):
        # shutdown() must come from another thread than serve_forever's
        threading.Thread(target=srv.shutdown, daemon=True).start()

    prev = {sig: signal.signal(sig, _stop)
            for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        srv.serve_forever(poll_interval=0.2)
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)
        srv.server_close()
        app.close()
        print("serving shutdown clean", flush=True)
    return 0
