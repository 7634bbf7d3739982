"""Stdlib HTTP serving surface, JSON in and out (counterpart of
``bigdl_tpu/serving/server.py``):

* ``POST /predict``  — ``{"inputs": [...]}`` -> argmax predictions (scores
  with ``"return_scores": true``), through the micro-batcher;
* ``POST /generate`` — ``{"tokens": [...], "max_new_tokens": N}`` ->
  generated ids from the continuous-batching decoder; optional
  ``temperature`` / ``top_k`` / ``top_p`` / ``seed``. With ``"stream":
  true`` the answer is a chunked ``text/event-stream``: one ``data:
  {"tokens": [...]}`` frame per emitting decode round (the accepted tokens
  only under ``--speculate``, so the frames concatenate to the buffered
  answer), then ``data: {"done": true, "prompt_len": N, "tokens_out":
  M}``; a client that goes away mid-stream has its request cancelled,
  which frees its slot and its KV pages;
* ``GET /healthz`` (liveness), ``/readyz`` (every worker healthy and no
  overload shed), ``/metrics`` (plaintext, with config provenance);
* ``GET /debug/requests`` (the request tracer's flight recorder; 404 with
  ``--reqTrace off``) and ``GET /debug/slots`` (the decoder's slot table
  and KV page-pool occupancy).

Every response carries ``x-request-id`` (a valid client-supplied id wins,
else one is minted) and ``x-model-version`` (the weights' version, which a
fleet's rolling swap bumps). Process roles add routes through
``extra_routes`` (the fleet worker's ``/control/state`` and
``/admin/reload``).

Errors: malformed input 400, admission rejection or overload shed 429
with ``Retry-After``, deadline expired before compute 504, dead or wedged
worker, timeout or an injected ``dispatch`` fault 503, engine failure 500;
every error body is ``{"error": ...}``, and an error before a stream's
first byte is such a plain response. Under overload ``/generate`` sheds
first, also while the SLO burn rate is saturated, and ``/predict`` keeps
admitting. Replicas (``--strategy dp``) are not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue as _queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from bigdl_tpu_torch.obs.spans import span as _obs_span
from bigdl_tpu_torch.resilience.faults import TransientFault
from bigdl_tpu_torch.resilience.faults import hook as _fault_hook
from bigdl_tpu_torch.serving import reqtrace as _reqtrace
from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             WorkerDied)

logger = logging.getLogger(__name__)

__all__ = ["ServingApp", "make_server", "run_server"]

_MAX_BODY = 64 * 1024 * 1024  # refuse absurd payloads before np.asarray


class _GenerateStream:
    """One streamed /generate: the queue the decode loop's emit sink feeds
    (``(tokens, done)`` a round), the request's future (the error of a
    termination that never emits: expiry while waiting, shutdown), the
    decoder that owns the slot, and the prompt length for the last
    frame."""

    __slots__ = ("rid", "queue", "future", "decoder", "prompt_len")

    def __init__(self, rid, queue, future, decoder, prompt_len):
        self.rid = rid
        self.queue = queue
        self.future = future
        self.decoder = decoder
        self.prompt_len = prompt_len


class ServingApp:
    """The wiring between HTTP handlers and the serving stack: engine and
    batcher for /predict, decoder for /generate, one metrics registry.
    Handlers return ``(status, payload_dict)``, testable without sockets.

    ``default_deadline_ms`` bounds every request (a request's
    ``"deadline_ms"`` overrides it); past ``shed_generate_frac`` of either
    queue's capacity, or with the SLO burn saturated, ``/generate`` sheds
    with 429; ``watchdog`` gives the readiness verdict for ``/readyz``;
    ``version`` is the weights' version echoed as ``x-model-version``.

    dp mode (``serve --strategy dp:N``): pass ``replicas`` (a
    :class:`~bigdl_tpu_torch.serving.replicas.ReplicaSet`) instead of
    engine/batcher/decoder; each request goes to the least-loaded live
    replica, ``/readyz`` aggregates the replicas' verdicts, and
    ``/generate`` sheds only when every live replica is saturated.
    ``tp_link``: rank 0's ``TPLink`` of a tp:K server (a list of them,
    one a replica, under dp:N+tp:K), closed (the followers released) when
    the app closes."""

    def __init__(self, *, name: str, metrics, engine=None, batcher=None,
                 decoder=None, request_timeout_s: float = 120.0,
                 default_deadline_ms: Optional[float] = None,
                 shed_generate_frac: float = 0.75, watchdog=None,
                 version: str = "v0", replicas=None, tp_link=None):
        if replicas is not None and (engine is not None
                                     or batcher is not None
                                     or decoder is not None):
            raise ValueError("pass either replicas= or "
                             "engine/batcher/decoder, not both")
        self.name = name
        self.metrics = metrics
        self.replicas = replicas
        self.tp_link = tp_link
        self.engine, self.batcher, self.decoder = engine, batcher, decoder
        self.watchdog = watchdog
        self.clock = time.monotonic
        # the weights' version, bumped by a fleet's rolling swap
        self.model_version = str(version)
        # process-role routes: {("GET"|"POST", path): handler(payload)}
        # returning (status, body)
        self.extra_routes = {}
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
        self._m_injected = metrics.counter(
            "faults_injected_requests_total",
            "requests failed by an installed --faultPlan")
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
        """Tiered degradation: past ``shed_generate_frac`` of either
        queue's capacity, or while the SLO burn rate says every recent
        request misses its targets, /generate sheds."""
        frac = self.shed_generate_frac
        if self.replicas is not None and self.replicas.shed_generate(frac):
            return True
        if (self.batcher is not None
                and self.batcher.queue_depth
                >= frac * self.batcher.max_queue):
            return True
        if (self.decoder is not None
                and len(self.decoder._waiting)
                >= frac * self.decoder.max_waiting):
            return True
        rt = _reqtrace.get()
        return rt is not None and rt.slo is not None and rt.slo.should_shed()

    # ------------------------------------------------------------ endpoints
    def handle_healthz(self):
        return 200, {"status": "ok", "model": self.name}

    def handle_readyz(self):
        if self.replicas is not None:
            # the fleet is ready while one replica can serve (a dead one is
            # routed around); the body names every replica's verdict
            ok, detail = self.replicas.ready_detail()
            detail["model"] = self.name
            if self._shed_generate():
                detail["shedding"] = "generate"
            detail["status"] = "ready" if ok else "unready"
            return (200 if ok else 503), detail
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

    @contextlib.contextmanager
    def _route(self, endpoint: str, rid: Optional[str]):
        """(engine, batcher, decoder) of the request: the least-loaded
        live replica's in dp mode (WorkerDied, a 503, when none lives; the
        choice is noted in the request's record), else the app's own. The
        caller submits inside the block: until then the pick counts in
        its replica's load (:meth:`ReplicaSet.routed`)."""
        if self.replicas is None:
            yield self.engine, self.batcher, self.decoder
            return
        with self.replicas.routed(endpoint) as rep:
            rt = _reqtrace.get()
            if rt is not None:
                rt.note_replica(rid, rep.index)
            yield rep.engine, rep.batcher, rep.decoder

    def handle_predict(self, payload: dict, rid: Optional[str] = None):
        with self._route("predict", rid) as (engine, batcher, _):
            if engine is None:
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
                    raise ValueError(
                        "inputs must be a batch (rows on axis 0)")
                engine.validate(x)
            except ValueError as e:
                return 400, {"error": f"bad inputs: {e}"}
            deadline = self._deadline_from(payload)
            if batcher is not None:
                futs = batcher.submit_many(list(x), deadline=deadline,
                                           rid=rid)
            else:
                if deadline is not None and self.clock() >= deadline:
                    raise DeadlineExceeded(
                        "deadline expired before compute")
                scores = engine.predict_scores(
                    x, rids=([rid] * len(x) if rid is not None else None))
        if batcher is not None:
            scores = np.stack([f.result(self.request_timeout_s)
                               for f in futs])
        out = {"predictions": np.argmax(scores, axis=-1).tolist()}
        if payload.get("return_scores"):
            out["scores"] = np.asarray(scores, np.float64).tolist()
        return 200, out

    @staticmethod
    def _parse_generate(payload: dict):
        """``(tokens, options)`` and None, or None and the error: one
        validation for the buffered and the streamed /generate."""
        tokens = payload.get("tokens")
        if (not isinstance(tokens, (list, tuple)) or not tokens
                or not all(isinstance(t, int) for t in tokens)):
            return None, "'tokens' must be a non-empty list of ints"
        try:
            opts = {"max_new": payload.get("max_new_tokens", 16),
                    "temperature": payload.get("temperature", 0.0),
                    "stop": payload.get("stop_token"),
                    "top_k": int(payload.get("top_k", 0)),
                    "top_p": float(payload.get("top_p", 1.0)),
                    "seed": int(payload.get("seed", 0))}
        except (TypeError, ValueError):
            return None, "'top_k'/'seed' must be ints, 'top_p' a float"
        return (list(tokens), opts), None

    def _submit_generate(self, payload: dict, rid, emit=None):
        """``(tokens, future)`` of an admitted /generate, or ``(None,
        (status, body))``; ``future.decoder`` is the decoder it went to
        (the routed replica's)."""
        if self.decoder is None and self.replicas is None:
            return None, (400, {"error": "no /generate decoder for this "
                                         "model (serve a transformer_lm* "
                                         "model)"})
        parsed, err = self._parse_generate(payload)
        if parsed is None:
            return None, (400, {"error": err})
        tokens, o = parsed
        with self._route("generate", rid) as (_, _, decoder):
            if decoder is None:
                return None, (400, {"error": "no /generate decoder for "
                                             "this model"})
            try:
                fut = decoder.submit(
                    tokens, o["max_new"], o["temperature"], o["stop"],
                    deadline=self._deadline_from(payload),
                    top_k=o["top_k"], top_p=o["top_p"], seed=o["seed"],
                    rid=rid, emit=emit)
            except (TypeError, ValueError) as e:
                return None, (400, {"error": str(e)})
        fut.decoder = decoder
        return tokens, fut

    def handle_generate(self, payload: dict, rid: Optional[str] = None):
        tokens, fut = self._submit_generate(payload, rid)
        if tokens is None:
            return fut
        return 200, {"tokens": fut.result(self.request_timeout_s),
                     "prompt_len": len(tokens)}

    def handle_metrics(self) -> str:
        return self.metrics.render()

    def handle_debug_requests(self):
        """The flight recorder: in-flight request records and the recent
        completed ones; 404 while ``--reqTrace`` is off."""
        rt = _reqtrace.get()
        if rt is None:
            return 404, {"enabled": False,
                         "error": "request tracing off (start with "
                                  "--reqTrace on)"}
        return 200, rt.snapshot()

    def handle_debug_slots(self):
        """The decoder's slot table and KV page-pool occupancy and the
        batcher's queue, with or without ``--reqTrace``."""
        if self.replicas is not None:
            return 200, self.replicas.debug_snapshot()
        if self.decoder is not None:
            out = self.decoder.debug_snapshot()
        else:
            out = {"slots": [], "slots_total": 0, "slots_active": 0,
                   "waiting": 0, "kv": {"paged": False}}
        if self.batcher is not None:
            out["batcher"] = {
                "queue_depth": self.batcher.queue_depth,
                "max_queue": self.batcher.max_queue,
                "worker_up": self.batcher.alive()}
        return 200, out

    # ------------------------------------------------------------- dispatch
    def _admit(self, ep: str, payload: dict, rid):
        """Open the request's lifecycle record (with ``--reqTrace`` on);
        returns the rid."""
        rt = _reqtrace.get()
        if rt is None:
            return rid
        prompt_n = max_new = None
        if ep == "generate":
            toks = payload.get("tokens")
            if isinstance(toks, (list, tuple)):
                prompt_n = len(toks)
            try:
                max_new = int(payload.get("max_new_tokens", 16))
            except (TypeError, ValueError):
                max_new = None
        return rt.admit(ep, rid, prompt_tokens=prompt_n, max_new=max_new)

    def _shed(self, rid):
        self._m_shed.inc()
        self._m_errors.inc()
        rt = _reqtrace.get()
        if rt is not None:
            rt.finish(rid, "shed", status=429)
        return 429, {"error": "overloaded: shedding /generate "
                              "(retry, or use /predict capacity)"}

    def _failed(self, rid, e: BaseException, where: str):
        """The status and body of a request that raised, its counters,
        and its lifecycle record's terminal state."""
        rt = _reqtrace.get()
        if isinstance(e, AdmissionError):
            state, status, body = "rejected", 429, {"error": str(e)}
        elif isinstance(e, DeadlineExceeded):
            self._m_expired.inc()
            state, status = "expired", 504
            body = {"error": f"deadline exceeded: {e}"}
        elif isinstance(e, WorkerDied):
            self._m_worker_dead.inc()
            state, status, body = "worker_dead", 503, {"error": str(e)}
        elif isinstance(e, TransientFault):
            self._m_injected.inc()
            state, status = "error", 503
            body = {"error": f"injected fault: {e}"}
        elif isinstance(e, TimeoutError):
            state, status, body = "error", 503, {"error": str(e)}
        else:
            logger.exception("%s failed", where)
            state, status = "error", 500
            body = {"error": f"{type(e).__name__}: {e}"}
        self._m_errors.inc()
        if rt is not None:
            rt.finish(rid, state, status=status, error=body["error"])
        return status, body

    def dispatch_post(self, path: str, payload: dict,
                      rid: Optional[str] = None):
        ep = path.strip("/")
        handler = {"predict": self.handle_predict,
                   "generate": self.handle_generate}.get(ep)
        if handler is None:
            return 404, {"error": f"unknown endpoint {path}"}
        # the record opens at admission: a shed request leaves one too
        rid = self._admit(ep, payload, rid)
        if ep == "generate" and self._shed_generate():
            return self._shed(rid)
        t0 = time.perf_counter()
        try:
            _fault_hook("request")  # no-op unless --faultPlan installed
            with _obs_span("request", endpoint=ep):
                status, body = handler(payload, rid=rid)
        except Exception as e:
            return self._failed(rid, e, f"/{ep}")
        rt = _reqtrace.get()
        if status == 200:
            self._m_requests[ep].inc()
            self._m_latency[ep].observe((time.perf_counter() - t0) * 1000.0)
            if rt is not None:
                # the decoder already finished a /generate's record (this
                # fills in its status); a /predict's ends here
                rt.finish(rid, "finished", status=200)
        else:
            self._m_errors.inc()
            if rt is not None:
                rt.finish(rid, "bad_request" if status == 400 else "error",
                          status=status,
                          error=str(body.get("error", "")) or None)
        return status, body

    # ------------------------------------------------------------ streaming
    def start_generate_stream(self, payload: dict,
                              rid: Optional[str] = None):
        """Admission of a streamed /generate: the shed, validation and
        error ladder of :meth:`dispatch_post`, but the request is
        submitted with a queue-backed emit sink and ``(200,
        _GenerateStream)`` returned for the handler to drain. Every
        failure before the stream returns a plain ``(status, body)``."""
        rid = self._admit("generate", payload, rid)
        if self._shed_generate():
            return self._shed(rid)
        q: _queue_mod.Queue = _queue_mod.Queue()
        tokens, fut = None, None
        if self._parse_generate(payload)[0] is not None:
            try:
                _fault_hook("request")  # no-op unless --faultPlan installed
                # the sink runs under the decoder's lock: hand off only
                tokens, fut = self._submit_generate(
                    payload, rid,
                    emit=lambda new, done: q.put_nowait((list(new), done)))
            except Exception as e:
                return self._failed(rid, e, "/generate stream admission")
        else:
            fut = self._submit_generate(payload, rid)[1]
        if tokens is None:
            status, body = fut
            self._m_errors.inc()
            rt = _reqtrace.get()
            if rt is not None:
                rt.finish(rid, "bad_request", status=status,
                          error=body["error"])
            return status, body
        return 200, _GenerateStream(rid, q, fut, fut.decoder, len(tokens))

    def finish_generate_stream(self, rid: Optional[str], ok: bool,
                               t0: float) -> None:
        """Account a drained stream as :meth:`dispatch_post` accounts a
        buffered answer (the decoder already ended its record; this fills
        in HTTP 200), or count the error."""
        if ok:
            self._m_requests["generate"].inc()
            self._m_latency["generate"].observe(
                (time.perf_counter() - t0) * 1000.0)
            rt = _reqtrace.get()
            if rt is not None:
                rt.finish(rid, "finished", status=200)
        else:
            self._m_errors.inc()

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.batcher is not None:
            self.batcher.close()
        if self.engine is not None:
            self.engine.close()
        if self.decoder is not None:
            self.decoder.close()
        if self.replicas is not None:
            self.replicas.close()
        links = (self.tp_link if isinstance(self.tp_link, (list, tuple))
                 else [self.tp_link])
        for link in links:
            if link is not None:
                link.close()  # a tp:K server's followers return
        rt = _reqtrace.get()
        if rt is not None:
            rt.close()  # flush the access log


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> ServingApp:
        return self.server.app  # type: ignore[attr-defined]

    def _rid(self) -> str:
        """The id echoed on every response: a valid client-supplied
        ``x-request-id`` wins, else one is minted (also with tracing
        off)."""
        return (_reqtrace.sanitize_rid(self.headers.get("x-request-id"))
                or _reqtrace.mint_rid())

    def _head(self, status: int, rid: str, ctype: str) -> None:
        self.send_response(status)
        if status == 429:
            self.send_header("Retry-After", "1")
        self.send_header("x-request-id", rid)
        self.send_header("x-model-version", self.app.model_version)
        self.send_header("Content-Type", ctype)

    def _send(self, status: int, data: bytes, ctype: str, rid: str) -> None:
        self._head(status, rid, ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, status: int, body: dict, rid: str) -> None:
        self._send(status, json.dumps(body).encode(), "application/json",
                   rid)

    def do_GET(self):  # noqa: N802 (stdlib naming)
        rid = self._rid()
        app = self.app
        routes = {"/healthz": app.handle_healthz,
                  "/readyz": app.handle_readyz,
                  "/debug/requests": app.handle_debug_requests,
                  "/debug/slots": app.handle_debug_slots}
        if self.path in routes:
            self._send_json(*routes[self.path](), rid=rid)
        elif self.path == "/metrics":
            self._send(200, app.handle_metrics().encode(),
                       "text/plain; version=0.0.4", rid)
        elif ("GET", self.path) in app.extra_routes:
            self._send_json(*app.extra_routes[("GET", self.path)](None),
                            rid=rid)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"},
                            rid=rid)

    def do_POST(self):  # noqa: N802
        rid = self._rid()
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > _MAX_BODY:
            self._send_json(400, {"error": "missing or oversized body"},
                            rid=rid)
            return
        try:
            payload = json.loads(self.rfile.read(length))
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            self._send_json(400, {"error": f"bad JSON: {e}"}, rid=rid)
            return
        if ("POST", self.path) in self.app.extra_routes:
            self._send_json(*self.app.extra_routes[("POST", self.path)](
                payload), rid=rid)
            return
        if self.path.strip("/") == "generate" and payload.get("stream"):
            self._stream_generate(payload, rid)
            return
        self._send_json(*self.app.dispatch_post(self.path, payload, rid=rid),
                        rid=rid)

    # ------------------------------------------------------------ streaming
    def _write_chunk(self, data: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame (``b""`` terminates)."""
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    @staticmethod
    def _sse(obj: dict) -> bytes:
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    def _stream_generate(self, payload: dict, rid: str) -> None:
        """A streamed /generate: chunked SSE frames, one per emitting
        decode round, then the ``done`` frame; a write that fails (the
        client went away) cancels the request, freeing its slot and
        pages; past the request timeout the request is cancelled and an
        error frame ends the stream."""
        app = self.app
        t0 = time.perf_counter()
        status, obj = app.start_generate_stream(payload, rid=rid)
        if status != 200:
            self._send_json(status, obj, rid=rid)
            return
        stream: _GenerateStream = obj
        rt = _reqtrace.get()
        ok, first, n_out, counted = False, True, 0, False
        deadline = time.monotonic() + app.request_timeout_s
        try:
            self._head(200, rid, "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            while True:
                try:
                    toks, done = stream.queue.get(timeout=0.05)
                except _queue_mod.Empty:
                    if stream.future.done() and stream.queue.empty():
                        # ended without a last emit (expiry, cancel,
                        # shutdown): its error is the last frame
                        try:
                            stream.future.result(0)
                            err = "stream ended without tokens"
                        except Exception as e:
                            err = str(e)
                        self._write_chunk(self._sse({"error": err}))
                        break
                    if time.monotonic() > deadline:
                        stream.decoder.cancel(
                            rid, reason="server stream timeout")
                        self._write_chunk(
                            self._sse({"error": "stream timeout"}))
                        break
                    continue
                if first and rt is not None:
                    # the first byte is about to leave: the TTFT the
                    # client feels, and the one --slo judges
                    rt.note_first_byte(rid)
                self._write_chunk(self._sse({"tokens": toks}))
                first = False
                n_out += len(toks)
                if done:
                    self._write_chunk(self._sse(
                        {"done": True, "prompt_len": stream.prompt_len,
                         "tokens_out": n_out}))
                    ok = True
                    break
            if ok:
                # counted before the stream's last byte leaves: a client
                # that has read the whole stream finds it in /metrics
                app.finish_generate_stream(rid, ok, t0)
                counted = True
            self._write_chunk(b"")  # the terminating chunk
        except OSError:  # BrokenPipeError, ConnectionResetError
            # the client went away: free the slot and its pages now
            # instead of decoding into a dead pipe
            stream.decoder.cancel(rid)
        finally:
            if not counted:
                app.finish_generate_stream(rid, ok, t0)

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
    """Foreground serve loop with clean SIGINT/SIGTERM shutdown. The
    ``serving <name> on http://host:port`` line is what a fleet router
    reads a worker's port from."""
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
