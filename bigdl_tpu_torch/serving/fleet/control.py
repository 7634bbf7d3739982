"""Fleet control plane (counterpart of
``bigdl_tpu/serving/fleet/control.py``): the message schema and transport
between the router process and its engine workers.

The control channel is plain HTTP on the worker's own serving port, one
socket per worker. Two endpoints make the whole protocol:

* ``GET /control/state``  — the worker heartbeat: one
  :class:`WorkerStatus` JSON object per poll (state, queue depth, SLO
  burn, model version). The router polls it every ``heartbeat_s``; a
  worker that stops answering is routed around, a worker whose process
  died is restarted under the retry policy.
* ``POST /admin/reload``  — ``{"checkpoint": ..., "version": ...}``:
  drain in-flight work, copy the checkpoint's weights into the served
  tensors, bump the version stamped into provenance and the
  ``x-model-version`` response header.

Stdlib only: the router process imports no torch and holds no CUDA
context; the K workers own the card.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
from typing import Optional, Tuple

__all__ = ["CONTROL_PATH", "RELOAD_PATH", "WORKER_STATES", "WorkerStatus",
           "fetch_status", "request_json"]

CONTROL_PATH = "/control/state"
RELOAD_PATH = "/admin/reload"

# the worker lifecycle the router's routing table understands:
#   starting  — process up, engines still compiling / warming
#   ready     — in rotation
#   draining  — finishing in-flight work, no NEW requests routed
#   reloading — weight swap in progress (implies drained)
#   dead      — process exited (router-side verdict; a worker never
#               reports it about itself)
WORKER_STATES = ("starting", "ready", "draining", "reloading", "dead")


@dataclasses.dataclass
class WorkerStatus:
    """One heartbeat: everything the router's balancer needs to score a
    worker — queue depth for least-loaded, SLO burn for the weighting,
    model version for the rolling-swap bookkeeping."""

    index: int
    pid: int = 0
    port: int = 0
    state: str = "starting"
    queue_depth: int = 0
    decode_active: int = 0
    slo_burn: float = 0.0
    goodput: float = 1.0
    model_version: str = "v0"
    restarts: int = 0
    uptime_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerStatus":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in dict(d).items() if k in names}
        if "index" not in kw:
            raise ValueError("worker status missing 'index'")
        st = cls(**kw)
        if st.state not in WORKER_STATES:
            raise ValueError(f"unknown worker state {st.state!r} "
                             f"(states: {', '.join(WORKER_STATES)})")
        return st


def request_json(method: str, host: str, port: int, path: str,
                 payload: Optional[dict] = None, timeout: float = 5.0,
                 headers: Optional[dict] = None) -> Tuple[int, dict]:
    """One JSON request/response over a fresh connection. Raises OSError
    (incl. ConnectionRefusedError / socket.timeout) on transport
    failure — callers decide whether that means retry, reroute, or
    restart."""
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        body = (json.dumps(payload).encode()
                if payload is not None else None)
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        try:
            obj = json.loads(data) if data else {}
            if not isinstance(obj, dict):
                obj = {"value": obj}
        except ValueError:
            obj = {"raw": data.decode("utf-8", "replace")}
        return resp.status, obj
    finally:
        conn.close()


def fetch_status(host: str, port: int,
                 timeout: float = 2.0) -> Optional[WorkerStatus]:
    """Poll one worker heartbeat; ``None`` on any transport or schema
    failure (a missed heartbeat is data, not an exception — the monitor
    loop counts them)."""
    try:
        status, obj = request_json("GET", host, port, CONTROL_PATH,
                                   timeout=timeout)
    except OSError:
        return None
    if status != 200:
        return None
    try:
        return WorkerStatus.from_dict(obj)
    except (TypeError, ValueError):
        return None
