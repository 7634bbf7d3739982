"""Metrics registry: counters, gauges and fixed-bucket latency histograms
with a plaintext (Prometheus-compatible) exposition. A copy of the JAX
package's ``bigdl_tpu/obs/metrics.py`` without labelled series, which the
port does not use yet.

Each instrument guards its update with one short-held lock; histograms
estimate quantiles at render time by linear interpolation inside the
covering bucket. The config provenance (``set_provenance``) is stamped
into every scrape as an ``<ns>_info`` gauge and a ``# provenance {json}``
comment line; a callable value is resolved at each scrape.

:func:`get_registry` is the process-global registry the fault injector's
and the supervisor's counters land in; ``serve`` installs its own
registry there (:func:`set_registry`), so they share its ``/metrics``
page."""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS_MS", "ITL_BUCKETS_MS", "get_registry",
           "set_registry", "reset_registry"]

# log-spaced 100 us .. 60 s
DEFAULT_LATENCY_BUCKETS_MS: tuple = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

# inter-token latencies cluster tightly (a decode step is a few ms, TTFT
# a few tens): the TTFT/TPOT/ITL histograms of serving/reqtrace.py take
# ~2x finer buckets below 100 ms
ITL_BUCKETS_MS: tuple = (
    0.25, 0.5, 1.0, 1.5, 2.5, 4.0, 6.0, 10.0, 15.0, 25.0, 40.0, 60.0,
    100.0, 150.0, 250.0, 400.0, 600.0, 1000.0, 2500.0, 5000.0, 10000.0,
    30000.0, 60000.0)


class Counter:
    """Monotone counter; ``inc`` is one lock + one add."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value sampled from ``fn`` at render time (queue
    depth, occupancy); NaN when ``fn`` fails."""

    def __init__(self, name: str, help: str, fn: Callable[[], float]):
        self.name, self.help = name, help
        self._fn = fn

    @property
    def value(self) -> float:
        try:
            return float(self._fn())
        except Exception:
            return float("nan")


class Histogram:
    """Fixed-bucket histogram; ``bounds`` are ascending upper edges plus
    an implicit +Inf bucket, whose quantile reports the largest value
    observed."""

    def __init__(self, name: str, help: str = "",
                 bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        self.name, self.help = name, help
        self.bounds: List[float] = sorted(float(b) for b in bounds)
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self._counts), "sum": self._sum,
                    "count": self._count, "max": self._max}

    def quantile(self, q: float, snap: Optional[dict] = None) -> float:
        """Estimated q-quantile (q in [0, 1]); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = snap or self.snapshot()
        total = s["count"]
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(s["counts"]):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = s["max"] if i == len(self.bounds) else self.bounds[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return s["max"]


class MetricsRegistry:
    """Instrument factory and plaintext exposition (``render``)."""

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, namespace: str = "bigdl_serving",
                 clock: Callable[[], float] = time.time):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._provenance: dict = {}
        self._clock = clock
        self._t0 = clock()

    def _register(self, name, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
        if not isinstance(m, kind):
            raise TypeError(f"{name} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str,
              fn: Callable[[], float]) -> Gauge:
        return self._register(name, Gauge, lambda: Gauge(name, help, fn))

    def histogram(self, name: str, help: str = "",
                  bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._register(name, Histogram,
                              lambda: Histogram(name, help, bounds))

    def set_provenance(self, prov: dict) -> None:
        with self._lock:
            self._provenance = dict(prov)

    def uptime_s(self) -> float:
        return self._clock() - self._t0

    def render(self) -> str:
        ns = self.namespace
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
            prov = dict(self._provenance)
        for k, v in list(prov.items()):
            if callable(v):  # resolved at scrape time (the model version)
                try:
                    prov[k] = v()
                except Exception:
                    prov[k] = None
        lines: List[str] = []
        if prov:
            lines.append(f"# provenance {json.dumps(prov, sort_keys=True)}")
            labels = ",".join(f'{k}="{_label_escape(v)}"'
                              for k, v in sorted(prov.items()))
            lines.append(f"# HELP {ns}_info serving config provenance")
            lines.append(f"# TYPE {ns}_info gauge")
            lines.append(f"{ns}_info{{{labels}}} 1")
        lines.append(f"# HELP {ns}_uptime_seconds process uptime")
        lines.append(f"# TYPE {ns}_uptime_seconds gauge")
        lines.append(f"{ns}_uptime_seconds {self.uptime_s():.3f}")
        for m in metrics:
            full = f"{ns}_{m.name}"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            kind = ("counter" if isinstance(m, Counter) else
                    "gauge" if isinstance(m, Gauge) else "histogram")
            lines.append(f"# TYPE {full} {kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{full} {_fmt(m.value)}")
                continue
            snap = m.snapshot()
            cum = 0
            for b, c in zip(m.bounds, snap["counts"]):
                cum += c
                lines.append(f'{full}_bucket{{le="{_fmt(b)}"}} {cum}')
            lines.append(f'{full}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{full}_sum {_fmt(snap['sum'])}")
            lines.append(f"{full}_count {snap['count']}")
            for q in self.QUANTILES:
                lines.append(f'{full}{{quantile="{q}"}} '
                             f"{_fmt(m.quantile(q, snap))}")
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    f = float(v)
    if f != f:  # NaN (empty-histogram quantile, failing gauge fn)
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry(namespace: str = "bigdl") -> MetricsRegistry:
    """The process-global registry (created on first call; later
    ``namespace`` arguments are ignored: one process, one page)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry(namespace=namespace)
        return _GLOBAL


def set_registry(reg: Optional[MetricsRegistry]) -> None:
    """Install (or clear, with None) the process-global registry."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = reg


def reset_registry() -> None:
    set_registry(None)
