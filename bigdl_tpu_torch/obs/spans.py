"""Low-overhead structured span tracing (counterpart of
``bigdl_tpu/obs/spans.py``): named spans around the phases of the serving
request path (and, later, the training loop), ring-buffered and
exportable as a Chrome-trace / Perfetto JSON.

* Near-zero cost when disabled: ``span(name)`` with no tracer installed
  is one global load, one ``None`` check, and returns a shared no-op
  context manager.
* Thread-safe: each thread keeps its own nesting stack and completed
  spans append into one lock-guarded ring.
* Bounded memory: the ring (default 2^16 events) drops the oldest events
  on overflow and counts the drops.
* Deterministic under test: the clock is injectable.

``serving/reqtrace.py`` joins each request's phases onto this timeline.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Tracer", "span", "instant", "counter", "enable", "disable",
           "enabled", "get_tracer", "set_tracer"]


class Tracer:
    """Ring-buffered span collector with Chrome-trace export.

    Completed spans are dicts ``{name, ts, dur, tid, depth, args}`` with
    ``ts``/``dur`` in SECONDS on the tracer's clock (conversion to the
    Chrome format's microseconds happens at export). ``tid`` is a small
    stable per-thread integer, 0 for the first thread seen."""

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self._recorded = 0  # total ever, to report drops

    # ---------------------------------------------------------- span stack
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def record(self, name: str, t0: float, t1: float, depth: int,
               args: Optional[dict] = None,
               cat: Optional[str] = None) -> None:
        ev = {"name": name, "ts": t0, "dur": max(t1 - t0, 0.0),
              "tid": self._tid(), "depth": depth}
        if args:
            ev["args"] = args
        if cat is not None:
            ev["cat"] = cat
        with self._lock:
            self._ring.append(ev)
            self._recorded += 1

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """A zero-duration marker on the timeline (Chrome-trace ``ph: i``
        with global scope): fault injections land as flags next to the
        spans instead of only counting in the registry."""
        ev = {"name": name, "ts": self.clock(), "dur": 0.0,
              "tid": self._tid(), "depth": 0, "ph": "i"}
        if args:
            ev["args"] = args
        with self._lock:
            self._ring.append(ev)
            self._recorded += 1

    def counter(self, name: str, values: dict) -> None:
        """A Chrome-trace counter sample (``ph: C``): Perfetto renders a
        series per key over the same timeline the spans live on."""
        ev = {"name": name, "ts": self.clock(), "dur": 0.0,
              "tid": self._tid(), "depth": 0, "ph": "C",
              "args": dict(values)}
        with self._lock:
            self._ring.append(ev)
            self._recorded += 1

    # ------------------------------------------------------------ snapshot
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._recorded - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """The Chrome Trace Event Format object (``traceEvents`` of
        ``"ph": "X"`` complete events, timestamps in microseconds).
        Loadable by chrome://tracing and Perfetto; nesting is inferred
        by the viewer from interval containment per (pid, tid)."""
        pid = os.getpid()
        evs = []
        for e in self.events():
            ph = e.get("ph", "X")
            ev = {"name": e["name"], "cat": e.get("cat", "bigdl"),
                  "ph": ph,
                  "ts": round(e["ts"] * 1e6, 3),
                  "pid": pid, "tid": e["tid"]}
            if ph == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            elif ph == "i":
                ev["s"] = "g"  # global scope: a full-height flag
            if "args" in e:
                ev["args"] = e["args"]
            evs.append(ev)
        # stable viewer ordering (and easier assertions): by ts, with
        # parents before their children at equal ts (larger dur first)
        evs.sort(key=lambda ev: (ev["tid"], ev["ts"], -ev.get("dur", 0.0)))
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns the event
        count written."""
        trace = self.chrome_trace()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


class _Span:
    """Active span context manager (only allocated when a tracer is
    installed)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: Tracer, name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._tracer._stack().append(self._name)
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self._tracer.clock()
        st = self._tracer._stack()
        st.pop()
        self._tracer.record(self._name, self._t0, t1, depth=len(st),
                            args=self._args)


class _NoopSpan:
    """Shared do-nothing context manager — what ``span()`` returns when
    tracing is disabled. A singleton: the disabled path allocates
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_TRACER: Optional[Tracer] = None


def span(name: str, **args):
    """``with span("data_wait"): ...`` — time a named phase.

    Disabled (no tracer installed): one global load + ``None`` check,
    returns the shared no-op singleton. Enabled: records a completed
    span into the tracer's ring on exit, nested under any enclosing
    spans of the same thread."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return _Span(t, name, args or None)


def instant(name: str, **args) -> None:
    """Module-level instant marker — same disabled-cost contract as
    :func:`span` (one global load + ``None`` check, then nothing)."""
    t = _TRACER
    if t is not None:
        t.instant(name, args or None)


def counter(name: str, values: dict) -> None:
    """Module-level counter sample — no-op unless a tracer is
    installed."""
    t = _TRACER
    if t is not None:
        t.counter(name, values)


def enable(capacity: int = 65536,
           clock: Callable[[], float] = time.perf_counter) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _TRACER
    _TRACER = Tracer(capacity=capacity, clock=clock)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install an externally constructed tracer (tests inject a fake
    clock this way)."""
    global _TRACER
    _TRACER = tracer
