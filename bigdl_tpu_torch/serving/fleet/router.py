"""Fleet router (counterpart of ``bigdl_tpu/serving/fleet/router.py``):
the front-door process that spawns, monitors and proxies for K engine
worker processes (``python -m bigdl_tpu_torch.serving.fleet.worker``).

Each worker is the ``serve`` stack in its own process on its own port
(on one card, K processes share it, each with its own CUDA context,
graphs and KV pool), or under ``--strategy tp:K`` a group of K rank
processes behind one (``fleet.worker.run_group``). Each worker runs in a
session of its own, and the router takes down its whole process group
when it dies, restarts or closes. This router is all clients see:

* ``POST /predict`` / ``POST /generate`` — proxied to the routable worker
  with the lowest SLO-burn-weighted queue depth, ``(1 + depth) * (1 + w *
  burn)``, ties to the lowest index. A streamed ``/generate`` passes its
  SSE chunks through as they arrive. A connect failure fails over to the
  next worker.
* worker lifecycle — a worker that exits is restarted under the
  :class:`~bigdl_tpu_torch.resilience.supervisor.RetryPolicy`
  (exponential backoff, deterministic jitter, a budget) and rejoins on
  its first ``ready`` heartbeat. ``/readyz`` stays 200 while one worker
  is routable.
* ``GET /metrics`` — the router's own counters plus every worker's page
  re-exported with a ``worker="i"`` label and summed fleet totals
  (:mod:`bigdl_tpu_torch.obs.aggregate`).
* ``GET /debug/fleet`` — the routing table: each worker's state, queue
  depth, burn, version and restarts.
* ``POST /admin/reload`` — the rolling weight swap (:mod:`fleet.swap`),
  one worker at a time.

Every response, proxied or the router's own (the 503 when no worker
lives too), carries ``x-request-id``; a proxied one carries the worker's
``x-model-version``. The router is a plain HTTP process: it imports no
torch and makes no CUDA call.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from bigdl_tpu_torch.resilience.supervisor import RetryPolicy
from bigdl_tpu_torch.serving import reqtrace as _reqtrace
from bigdl_tpu_torch.serving.fleet import control, swap
from bigdl_tpu_torch.serving.fleet.worker import RESTARTS_ENV

logger = logging.getLogger(__name__)

__all__ = ["FleetRouter", "NoLiveWorker", "WorkerHandle", "run_fleet",
           "worker_base_argv"]

_MAX_BODY = 64 * 1024 * 1024
_PORT_RE = re.compile(r"serving .+ on http://[^:]+:(\d+)")

# serve/fleet flags the ROUTER owns — stripped from the argv forwarded
# to workers (each entry: flag -> number of value tokens that follow)
_ROUTER_FLAGS = {"--fleet": 1, "--port": 1, "-p": 1, "--host": 1,
                 "--model": 1, "--modelVersion": 1,
                 "--fleetHeartbeatS": 1, "--fleetRestartBudget": 1}
_ROUTER_SWITCHES = {"--randomInit"}


def _kill_group(proc, sig=signal.SIGKILL) -> None:
    """Send ``sig`` to the process group of worker ``proc`` (a session of
    its own: its tp ranks too), whatever of it is left."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


class NoLiveWorker(RuntimeError):
    """Every worker is dead, unreachable, or draining."""


def worker_base_argv(argv: List[str]) -> List[str]:
    """The serve argv minus everything the router owns (fleet shape,
    bind address, weights source + version — re-attached per spawn so a
    worker restarted AFTER a rolling swap boots with the swapped
    checkpoint, not the original one)."""
    out: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a.split("=", 1)[0]
        if key in _ROUTER_SWITCHES:
            i += 1
            continue
        if key in _ROUTER_FLAGS:
            i += 1 + (0 if "=" in a else _ROUTER_FLAGS[key])
            continue
        out.append(a)
        i += 1
    return out


class WorkerHandle:
    """Router-side view of one worker process: the Popen, the parsed
    port, the last heartbeat, and the restart bookkeeping."""

    def __init__(self, index: int):
        self.index = int(index)
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.state = "starting"          # router-side lifecycle verdict
        self.status: Optional[control.WorkerStatus] = None
        self.draining = False            # router-side (rolling swap)
        self.restarts = 0
        self.restart_at: Optional[float] = None
        self.gave_up = False
        self.missed = 0
        self.last_seen = 0.0
        self.last_rc: Optional[int] = None

    def process_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def routable(self) -> bool:
        return (self.process_alive() and self.port is not None
                and self.state == "ready" and not self.draining
                and not self.gave_up)

    def score(self, burn_weight: float) -> float:
        st = self.status
        depth = (st.queue_depth + st.decode_active) if st else 0
        burn = st.slo_burn if st else 0.0
        return (1.0 + depth) * (1.0 + burn_weight * burn)

    def describe(self) -> dict:
        out = {"worker": self.index, "port": self.port,
               "state": ("dead" if not self.process_alive()
                         else self.state),
               "pid": self.proc.pid if self.proc is not None else None,
               "alive": self.process_alive(),
               "routable": self.routable(),
               "draining": self.draining,
               "restarts": self.restarts, "gave_up": self.gave_up}
        if self.last_rc is not None:
            out["last_rc"] = self.last_rc
        if self.status is not None:
            out.update(queue_depth=self.status.queue_depth,
                       decode_active=self.status.decode_active,
                       slo_burn=self.status.slo_burn,
                       goodput=self.status.goodput,
                       model_version=self.status.model_version)
        return out


class FleetRouter:
    """Spawns and supervises K workers and owns the routing table. The
    HTTP proxying lives in :class:`_RouterHandler`; everything here is
    socket-free and unit-testable."""

    def __init__(self, name: str, n_workers: int, *,
                 make_argv: Optional[Callable[[int], List[str]]] = None,
                 base_argv: Optional[List[str]] = None,
                 checkpoint: Optional[str] = None,
                 random_init: bool = False, version: str = "v0",
                 host: str = "127.0.0.1", heartbeat_s: float = 0.5,
                 burn_weight: float = 4.0,
                 restart_policy: Optional[RetryPolicy] = None,
                 proxy_timeout_s: float = 150.0,
                 start_timeout_s: float = 300.0,
                 miss_limit: int = 6, env: Optional[dict] = None,
                 provenance: Optional[dict] = None):
        if n_workers < 1:
            raise ValueError(f"fleet needs >= 1 worker, got {n_workers}")
        self.name = name
        self.host = host
        self.heartbeat_s = float(heartbeat_s)
        self.burn_weight = float(burn_weight)
        self.restart_policy = restart_policy or RetryPolicy(
            budget=8, base_s=0.25, multiplier=2.0, max_s=10.0,
            jitter=0.5)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.start_timeout_s = float(start_timeout_s)
        self.miss_limit = int(miss_limit)
        self.checkpoint = checkpoint
        self.random_init = bool(random_init)
        self.version = str(version)
        self._make_argv = make_argv
        self.base_argv = list(base_argv or [])
        self._env = env
        self._handles = [WorkerHandle(i) for i in range(n_workers)]
        self._lock = threading.RLock()
        self._reload_lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

        from bigdl_tpu_torch.obs.metrics import MetricsRegistry
        self.metrics = MetricsRegistry(namespace="bigdl_fleet")
        self._m_requests = {
            ep: self.metrics.counter(f"requests_{ep}_total",
                                     f"/{ep} requests proxied")
            for ep in ("predict", "generate")}
        self._m_reroutes = self.metrics.counter(
            "proxy_reroutes_total",
            "requests failed over to another worker after a connect "
            "failure")
        self._m_5xx = self.metrics.counter(
            "responses_5xx_total",
            "5xx responses the ROUTER originated (no live worker, "
            "upstream died mid-request)")
        self._m_restarts = self.metrics.counter(
            "worker_restarts_total",
            "worker processes restarted by the supervisor policy")
        self._m_reloads = self.metrics.counter(
            "reloads_total", "rolling weight swaps completed")
        self.metrics.gauge("workers", "fleet size",
                           fn=lambda: len(self._handles))
        self.metrics.gauge("workers_routable",
                           "workers currently in rotation",
                           fn=lambda: sum(h.routable()
                                          for h in self._handles))
        prov = {"model": name, "fleet_workers": n_workers,
                "model_version": lambda: self.version,
                "checkpoint": checkpoint or "randomInit"}
        if provenance:
            prov.update(provenance)
        self.metrics.set_provenance(prov)

    # ------------------------------------------------------------ lifecycle
    def worker_argv(self, index: int) -> List[str]:
        if self._make_argv is not None:
            return list(self._make_argv(index))
        av = [sys.executable, "-m", "bigdl_tpu_torch.serving.fleet.worker"]
        av += self.base_argv
        if self.checkpoint:
            av += ["--model", self.checkpoint]
        elif self.random_init:
            av += ["--randomInit"]
        av += ["--modelVersion", self.version, "--host", self.host,
               "--port", "0", "--workerIndex", str(index)]
        return av

    def _spawn(self, h: WorkerHandle) -> None:
        env = dict(self._env if self._env is not None else os.environ)
        env[RESTARTS_ENV] = str(h.restarts)
        argv = self.worker_argv(h.index)
        h.port = None
        h.status = None
        h.state = "starting"
        h.missed = 0
        h.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  bufsize=1, env=env,
                                  start_new_session=True)
        logger.info("fleet: worker %d spawned pid=%d", h.index,
                    h.proc.pid)
        threading.Thread(target=self._pump, args=(h, h.proc),
                         daemon=True,
                         name=f"fleet-w{h.index}-log").start()

    def _pump(self, h: WorkerHandle, proc: subprocess.Popen) -> None:
        """Forward one worker's stdout (prefixed) and parse the serve
        banner for the ephemeral port."""
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                m = _PORT_RE.search(line)
                if m and proc is h.proc:
                    h.port = int(m.group(1))
                print(f"[worker {h.index}] {line}", flush=True)
        except (ValueError, OSError):
            pass  # stream closed during shutdown

    def start(self) -> None:
        """Spawn the fleet and the monitor; block until every worker
        heartbeats ready (or the start timeout passes with >= 1 ready —
        stragglers keep booting under the monitor's eye)."""
        for h in self._handles:
            self._spawn(h)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="fleet-monitor")
        self._monitor.start()
        deadline = time.monotonic() + self.start_timeout_s
        while time.monotonic() < deadline:
            if all(h.routable() or h.gave_up for h in self._handles):
                break
            time.sleep(0.1)
        live = sum(h.routable() for h in self._handles)
        if live == 0:
            self.close()
            raise SystemExit(
                f"fleet: no worker became ready within "
                f"{self.start_timeout_s:.0f}s — see [worker N] output "
                f"above")
        logger.info("fleet: %d/%d workers ready", live,
                    len(self._handles))

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            for h in self._handles:
                try:
                    self._check_worker(h)
                except Exception:
                    logger.exception("fleet: monitor check for worker "
                                     "%d failed", h.index)
            self._stop.wait(self.heartbeat_s)

    def _check_worker(self, h: WorkerHandle) -> None:
        now = time.monotonic()
        if h.proc is None:
            return
        rc = h.proc.poll()
        if rc is not None:
            if h.state != "dead":
                # fresh death: take down what is left of its group (a tp
                # worker's ranks), record it and schedule the supervised
                # restart (the fleet keeps serving on the survivors;
                # /readyz stays 200 while >= 1 worker is routable)
                _kill_group(h.proc)
                h.state = "dead"
                h.status = None
                h.last_rc = rc
                if h.restarts >= self.restart_policy.budget:
                    h.gave_up = True
                    logger.error(
                        "fleet: worker %d exited rc=%d — restart "
                        "budget (%d) exhausted, leaving it down",
                        h.index, rc, self.restart_policy.budget)
                    return
                h.restarts += 1
                d = self.restart_policy.delay(h.restarts)
                h.restart_at = now + d
                logger.warning(
                    "fleet: worker %d exited rc=%d — restart %d/%d "
                    "in %.2fs", h.index, rc, h.restarts,
                    self.restart_policy.budget, d)
            elif (not h.gave_up and h.restart_at is not None
                    and now >= h.restart_at):
                h.restart_at = None
                self._m_restarts.inc()
                self._spawn(h)
            return
        if h.port is None:
            return  # still booting: no banner yet
        st = control.fetch_status(self.host, h.port,
                                  timeout=max(self.heartbeat_s, 2.0))
        if st is None:
            h.missed += 1
            if h.missed >= self.miss_limit and h.state == "ready":
                # alive but unresponsive (wedged interpreter): route
                # around it; the first heartbeat that lands rejoins it
                h.state = "unreachable"
                logger.warning("fleet: worker %d missed %d heartbeats "
                               "— out of rotation", h.index, h.missed)
            return
        self.note_status(h, st, now)

    def note_status(self, h: WorkerHandle, st: control.WorkerStatus,
                    t_req: float) -> None:
        """Take heartbeat ``st``, requested at ``t_req`` (monotonic), into
        the routing table, unless one requested later is there already (a
        monitor poll that started before a reload ended must not undo the
        reload's ``ready``)."""
        with self._lock:
            if t_req < h.last_seen:
                return
            h.missed = 0
            h.last_seen = t_req
            h.status = st
            h.state = st.state if st.state in control.WORKER_STATES \
                else "ready"

    def close(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(self.heartbeat_s + 2.0)
        for h in self._handles:
            if h.proc is not None and h.proc.poll() is None:
                _kill_group(h.proc, signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        for h in self._handles:
            if h.proc is None:
                continue
            try:
                h.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(5.0)
            _kill_group(h.proc)  # any rank its leader left behind

    # -------------------------------------------------------------- routing
    def worker_handles(self) -> List[WorkerHandle]:
        return list(self._handles)

    def set_draining(self, h: WorkerHandle, flag: bool) -> None:
        h.draining = bool(flag)

    def note_reloaded(self, checkpoint: str, version: str) -> None:
        """A rolling swap finished: restarts from here on boot with the
        NEW checkpoint/version (a worker killed after the swap rejoins
        at the swapped weights, not the originals)."""
        self.checkpoint = checkpoint
        self.random_init = False
        self.version = str(version)
        self._m_reloads.inc()

    def pick(self, exclude=()) -> WorkerHandle:
        cands = [h for h in self._handles
                 if h.routable() and h.index not in exclude]
        if not cands:
            raise NoLiveWorker("no live fleet worker")
        return min(cands, key=lambda h: (h.score(self.burn_weight),
                                         h.index))

    # ------------------------------------------------------------ endpoints
    def handle_healthz(self):
        return 200, {"status": "ok", "model": self.name,
                     "role": "fleet-router"}

    def handle_readyz(self):
        detail = {"model": self.name, "role": "fleet-router",
                  "workers": len(self._handles),
                  "workers_routable": sum(h.routable()
                                          for h in self._handles),
                  "worker_states": {
                      str(h.index): ("dead" if not h.process_alive()
                                     else h.state)
                      for h in self._handles}}
        ok = detail["workers_routable"] >= 1
        detail["status"] = "ready" if ok else "unready"
        return (200 if ok else 503), detail

    def handle_debug_fleet(self):
        return 200, {"model": self.name, "version": self.version,
                     "checkpoint": self.checkpoint or "randomInit",
                     "workers": [h.describe() for h in self._handles]}

    def handle_admin_reload(self, payload):
        payload = payload or {}
        ckpt = payload.get("checkpoint")
        version = payload.get("version")
        if not ckpt or not version:
            return 400, {"error": "reload needs 'checkpoint' and "
                                  "'version'"}
        if not self._reload_lock.acquire(blocking=False):
            return 409, {"error": "a rolling reload is already in "
                                  "progress"}
        try:
            results = swap.rolling_reload(
                self, str(ckpt), str(version),
                drain_timeout_s=float(payload.get("drain_timeout_s",
                                                  60.0)))
        finally:
            self._reload_lock.release()
        failed = [r for r in results if r.get("status") == "error"]
        status = 500 if failed else 200
        return status, {"status": "error" if failed else "reloaded",
                        "version": str(version), "workers": results}

    def handle_metrics(self) -> str:
        """The router's own page plus every worker's page, re-exported
        with a ``worker`` label and summed into fleet series."""
        from bigdl_tpu_torch.obs.aggregate import aggregate_pages
        pages = {}
        for h in self._handles:
            if not h.process_alive() or h.port is None:
                continue
            try:
                status, text = _http_get_text(self.host, h.port,
                                              "/metrics", timeout=3.0)
            except OSError:
                continue
            if status == 200:
                pages[str(h.index)] = text
        out = self.metrics.render()
        if pages:
            out += "\n" + aggregate_pages(pages, label="worker")
        return out

    # --------------------------------------------------------------- serve
    def serve(self, port: int = 8000) -> int:
        """Foreground router loop, mirroring ``run_server``'s banner and
        clean-shutdown contract (SIGTERM -> rc 0 + shutdown marker)."""
        import signal

        self.start()
        srv = make_router_server(self, port)
        actual = srv.server_address[1]
        logger.info("serving fleet %s on http://%s:%d (%d workers)",
                    self.name, self.host, actual, len(self._handles))
        print(f"serving {self.name} fleet on http://{self.host}:{actual}",
              flush=True)

        def _sig(signum, frame):
            threading.Thread(target=srv.shutdown, daemon=True).start()

        prev = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev[sig] = signal.signal(sig, _sig)
            except ValueError:
                pass  # non-main thread (tests)
        try:
            srv.serve_forever(poll_interval=0.2)
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)
            srv.server_close()
            self.close()
            print("serving shutdown clean", flush=True)
        return 0


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's 5 drops the connects of a burst of
    # concurrent clients past it, which TCP retries only after 1 s
    request_queue_size = 128


def make_router_server(router: "FleetRouter",
                       port: int = 0) -> ThreadingHTTPServer:
    """Bind the router's HTTP front (port 0 = ephemeral); the caller runs
    ``serve_forever``."""
    srv = _Server((router.host, port), _RouterHandler)
    srv.router = router  # type: ignore[attr-defined]
    return srv


def _http_get_text(host, port, path, timeout=5.0):
    import http.client
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def router(self) -> FleetRouter:
        return self.server.router  # type: ignore[attr-defined]

    def _rid(self) -> str:
        return (_reqtrace.sanitize_rid(self.headers.get("x-request-id"))
                or _reqtrace.mint_rid())

    def _send_json(self, status: int, body: dict, rid: str,
                   version: Optional[str] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        if status == 429:
            self.send_header("Retry-After", "1")
        self.send_header("x-request-id", rid)
        if version:
            self.send_header("x-model-version", version)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        if status >= 500:
            self.router._m_5xx.inc()

    # ------------------------------------------------------------------ GET
    def do_GET(self):  # noqa: N802
        rid = self._rid()
        r = self.router
        if self.path == "/healthz":
            self._send_json(*r.handle_healthz(), rid=rid)
        elif self.path == "/readyz":
            self._send_json(*r.handle_readyz(), rid=rid)
        elif self.path == "/debug/fleet":
            self._send_json(*r.handle_debug_fleet(), rid=rid)
        elif self.path == "/metrics":
            data = r.handle_metrics().encode()
            self.send_response(200)
            self.send_header("x-request-id", rid)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path.startswith("/debug/"):
            self._proxy("GET", self.path, None, rid, stream=False)
        else:
            self._send_json(404,
                            {"error": f"unknown path {self.path}"},
                            rid=rid)

    # ----------------------------------------------------------------- POST
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
        body = self.rfile.read(length)
        if self.path == control.RELOAD_PATH:
            try:
                payload = json.loads(body)
            except ValueError as e:
                self._send_json(400, {"error": f"bad JSON: {e}"},
                                rid=rid)
                return
            status, out = self.router.handle_admin_reload(payload)
            self._send_json(status, out, rid=rid,
                            version=self.router.version)
            return
        ep = self.path.strip("/")
        if ep not in ("predict", "generate"):
            self._send_json(404,
                            {"error": f"unknown endpoint {self.path}"},
                            rid=rid)
            return
        stream = False
        if ep == "generate":
            try:  # routing only needs the stream bit; workers validate
                stream = bool(json.loads(body).get("stream"))
            except (ValueError, AttributeError):
                pass
        self.router._m_requests[ep].inc()
        self._proxy("POST", self.path, body, rid, stream=stream)

    # ------------------------------------------------------------- proxying
    def _proxy(self, method: str, path: str, body: Optional[bytes],
               rid: str, stream: bool) -> None:
        """Forward to the best worker; connect failures fail over (the
        request never reached an engine), failures AFTER the request was
        sent answer 503/504 without a blind retry."""
        import http.client
        import socket

        r = self.router
        tried: set = set()
        while True:
            try:
                h = r.pick(exclude=tried)
            except NoLiveWorker:
                self._send_json(
                    503, {"error": "no live fleet worker"}, rid=rid,
                    version=r.version)
                return
            conn = http.client.HTTPConnection(r.host, h.port,
                                              timeout=5.0)
            try:
                conn.connect()
            except OSError:
                conn.close()
                tried.add(h.index)
                r._m_reroutes.inc()
                logger.warning("fleet: worker %d connect failed — "
                               "failing over", h.index)
                continue
            conn.sock.settimeout(r.proxy_timeout_s)
            headers = {"x-request-id": rid}
            if body is not None:
                headers["Content-Type"] = "application/json"
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            except socket.timeout:
                conn.close()
                self._send_json(
                    504, {"error": f"fleet worker {h.index} timed out "
                                   f"after {r.proxy_timeout_s:.0f}s"},
                    rid=rid, version=r.version)
                return
            except OSError as e:
                conn.close()
                self._send_json(
                    503, {"error": f"fleet worker {h.index} died "
                                   f"mid-request: {e}"},
                    rid=rid, version=r.version)
                return
            try:
                if stream and resp.status == 200:
                    self._relay_stream(resp, rid)
                else:
                    self._relay(resp, rid)
            finally:
                conn.close()
            return

    def _relay(self, resp, rid: str) -> None:
        data = resp.read()
        self.send_response(resp.status)
        self.send_header("x-request-id", rid)
        for name in ("x-model-version", "Retry-After"):
            v = resp.getheader(name)
            if v:
                self.send_header(name, v)
        self.send_header("Content-Type",
                         resp.getheader("Content-Type",
                                        "application/json"))
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _relay_stream(self, resp, rid: str) -> None:
        """SSE passthrough: http.client de-chunks the worker's frames;
        each upstream chunk is re-chunked to the client as it arrives
        (``read1``: at most one chunk a read; stated difference, the JAX
        router's ``read(4096)`` collects up to 4 KiB first). A worker
        death mid-stream surfaces as a final SSE error frame (the stream
        already committed a 200); a client disconnect just drops the
        upstream connection, which cancels the worker-side slot."""
        self.send_response(200)
        self.send_header("x-request-id", rid)
        v = resp.getheader("x-model-version")
        if v:
            self.send_header("x-model-version", v)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            while True:
                try:
                    chunk = resp.read1(65536)
                except OSError:
                    self._write_chunk(
                        b'data: {"error": "fleet worker died '
                        b'mid-stream"}\n\n')
                    break
                if not chunk:
                    break
                self._write_chunk(chunk)
            self._write_chunk(b"")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away; dropping upstream cancels the slot

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)


def run_fleet(args, argv: List[str]) -> int:
    """``serve --fleet K`` / ``cli.fleet`` entry: resolve the serving
    config once (``--strategy``, ``--quantize``, ``--speculate``,
    ``--fleet``) before any worker boots, build the router, serve; each
    worker takes ``--strategy`` with the rest of the argv."""
    from bigdl_tpu_torch.cli import common

    k = int(args.fleet)
    if k < 1:
        raise SystemExit(f"--fleet {k}: a fleet needs >= 1 worker")
    if not args.checkpoint and not args.randomInit:
        raise SystemExit(
            "fleet needs weights: pass --model CKPT (a training "
            "checkpoint dir or file) or --randomInit for smoke/bench "
            "runs")
    cfg = common.resolve_serve_config(args)
    router = FleetRouter(
        name=args.model, n_workers=k,
        base_argv=worker_base_argv(argv),
        checkpoint=args.checkpoint, random_init=args.randomInit,
        version=getattr(args, "modelVersion", None) or "v0",
        host=args.host,
        heartbeat_s=getattr(args, "fleetHeartbeatS", 0.5),
        restart_policy=RetryPolicy(
            budget=int(getattr(args, "fleetRestartBudget", 8)),
            base_s=0.25, multiplier=2.0, max_s=10.0, jitter=0.5),
        proxy_timeout_s=float(args.timeout) + 30.0,
        provenance={"strategy": args.strategy or "none",
                    "serving_replicas": cfg.serving_replicas,
                    "serving_tp": cfg.serving_tp,
                    "quantize": cfg.quantize or "off",
                    "speculate": cfg.speculate})
    return router.serve(port=args.port)
