"""Metrics registry: counters, gauges and fixed-bucket latency histograms
with a plaintext (Prometheus-compatible) exposition. A copy of the JAX
package's ``bigdl_tpu/obs/metrics.py``: an instrument may carry labels
(``labelled`` gives a view that stamps them, as each dp serving replica
registers its series ``{replica="i"}`` on the shared page).

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
import contextlib
import json
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from bigdl_tpu_torch.obs.spans import span

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LabelledRegistry",
           "DEFAULT_LATENCY_BUCKETS_MS", "ITL_BUCKETS_MS",
           "PHASE_BUCKETS_MS", "get_registry", "set_registry",
           "reset_registry", "phase_histograms", "TRAIN_PHASES",
           "PhaseMeter"]

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

# training step phases: faster at the bottom (a warm h2d is tens of
# microseconds) and slower at the top (a first dispatch that builds the
# kernels or captures a graph) than request latencies
PHASE_BUCKETS_MS: tuple = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
    5000.0, 10000.0, 60000.0, 300000.0)

# the step-phase taxonomy: every per-step instrument and perf-JSON phase
# column derives its name from this tuple
TRAIN_PHASES = ("data_wait", "h2d", "dispatch", "device", "ckpt")


class Counter:
    """Monotone counter; ``inc`` is one lock + one add."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
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
    """Point-in-time value: either ``set()`` by its owner (the elastic
    mesh's rank count) or sampled from ``fn`` at render time (queue depth,
    occupancy; NaN when ``fn`` fails)."""

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
        self._fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        if self._fn is None:
            with self._lock:
                return self._value
        try:
            return float(self._fn())
        except Exception:
            return float("nan")


class Histogram:
    """Fixed-bucket histogram; ``bounds`` are ascending upper edges plus
    an implicit +Inf bucket, whose quantile reports the largest value
    observed."""

    def __init__(self, name: str, help: str = "",
                 bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
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

    def _register(self, name, labels, kind, factory):
        # an unlabelled instrument is keyed by its bare name; a labelled
        # series by the name and its rendered labels
        key = name if not labels else f"{name}{{{_labels_str(labels)}}}"
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = factory()
        if not isinstance(m, kind):
            raise TypeError(f"{name} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._register(name, labels, Counter,
                              lambda: Counter(name, help, labels))

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._register(name, labels, Gauge,
                              lambda: Gauge(name, help, fn, labels))

    def histogram(self, name: str, help: str = "",
                  bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._register(name, labels, Histogram,
                              lambda: Histogram(name, help, bounds, labels))

    def labelled(self, **labels: str) -> "LabelledRegistry":
        """A view that stamps ``labels`` onto every instrument made
        through it."""
        return LabelledRegistry(self, labels)

    def set_provenance(self, prov: dict) -> None:
        with self._lock:
            self._provenance = dict(prov)

    def uptime_s(self) -> float:
        return self._clock() - self._t0

    def render(self) -> str:
        ns = self.namespace
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: (
                m.name, _labels_str(m.labels)))
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
        # the series of one name are contiguous (the unlabelled one
        # first), HELP and TYPE stated once
        seen: set = set()
        for m in metrics:
            full = f"{ns}_{m.name}"
            base = m.labels or {}
            sfx = f"{{{_labels_str(base)}}}" if base else ""
            if m.name not in seen:
                seen.add(m.name)
                if m.help:
                    lines.append(f"# HELP {full} {m.help}")
                kind = ("counter" if isinstance(m, Counter) else
                        "gauge" if isinstance(m, Gauge) else "histogram")
                lines.append(f"# TYPE {full} {kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{full}{sfx} {_fmt(m.value)}")
                continue
            snap = m.snapshot()
            cum = 0
            for b, c in zip(m.bounds, snap["counts"]):
                cum += c
                lines.append(f"{full}_bucket{{"
                             f"{_labels_str(base, le=_fmt(b))}}} {cum}")
            lines.append(f'{full}_bucket{{{_labels_str(base, le="+Inf")}}} '
                         f'{snap["count"]}')
            lines.append(f"{full}_sum{sfx} {_fmt(snap['sum'])}")
            lines.append(f"{full}_count{sfx} {snap['count']}")
            for q in self.QUANTILES:
                lines.append(f"{full}{{{_labels_str(base, quantile=str(q))}}}"
                             f" {_fmt(m.quantile(q, snap))}")
        return "\n".join(lines) + "\n"


class LabelledRegistry:
    """A label-stamping view over a :class:`MetricsRegistry`: the
    instrument factories with a fixed label set merged in, so a component
    built against the plain registry (engine, batcher, decoder) can be
    one of N dp replicas without knowing it. Views nest (the inner label
    wins on a collision)."""

    def __init__(self, registry: MetricsRegistry, labels: Dict[str, str]):
        self._registry = registry
        self.labels = {str(k): str(v) for k, v in labels.items()}

    @property
    def namespace(self) -> str:
        return self._registry.namespace

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._registry.counter(name, help,
                                      labels={**self.labels, **(labels or {})})

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._registry.gauge(name, help, fn,
                                    labels={**self.labels, **(labels or {})})

    def histogram(self, name: str, help: str = "",
                  bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._registry.histogram(
            name, help, bounds, labels={**self.labels, **(labels or {})})

    def labelled(self, **labels: str) -> "LabelledRegistry":
        return LabelledRegistry(self._registry, {**self.labels, **labels})

    def uptime_s(self) -> float:
        return self._registry.uptime_s()

    def set_provenance(self, prov: dict) -> None:
        self._registry.set_provenance(prov)

    def render(self) -> str:
        return self._registry.render()


def _fmt(v) -> str:
    f = float(v)
    if f != f:  # NaN (empty-histogram quantile, failing gauge fn)
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(labels: Optional[Dict[str, str]], **extra: str) -> str:
    """Sorted ``k="v"`` labels; ``extra`` pairs (``le``, ``quantile``)
    merge after the instrument's own."""
    merged = dict(labels or {})
    merged.update(extra)
    return ",".join(
        f'{k}="{_label_escape(v)}"' for k, v in sorted(merged.items()))


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


def phase_histograms(registry: MetricsRegistry, prefix: str = "train",
                     phases: Sequence[str] = TRAIN_PHASES
                     ) -> Dict[str, Histogram]:
    """Register (or fetch) the per-step phase histograms, one
    ``<prefix>_phase_<name>_ms`` per phase, plus their cumulative
    ``<prefix>_phase_<name>_seconds_total`` counters, and return
    ``{phase: histogram}``. Idempotent (the registry dedups by name), so
    the Optimizer and the perf harness share series."""
    out = {}
    for ph in phases:
        out[ph] = registry.histogram(
            f"{prefix}_phase_{ph}_ms",
            f"per-step {ph} phase time", bounds=PHASE_BUCKETS_MS)
        registry.counter(f"{prefix}_phase_{ph}_seconds_total",
                         f"cumulative {ph} phase seconds")
    return out


class PhaseMeter:
    """Seconds by training phase (``TRAIN_PHASES``), one meter for the
    Optimizer's loop and ``cli.perf``'s: cumulative ``totals`` always;
    the per-step ``<prefix>_phase_<name>_ms`` histograms once
    :meth:`observe_into` names a registry (under ``--obs``); and
    :meth:`publish`, which adds what each phase gained since the last
    publish to its ``<prefix>_phase_<name>_seconds_total`` counter."""

    def __init__(self, prefix: str = "train"):
        self.prefix = prefix
        self.totals: Dict[str, float] = {}
        self._published: Dict[str, float] = {}
        self._hists: Optional[Dict[str, Histogram]] = None

    def observe_into(self, registry: MetricsRegistry) -> None:
        self._hists = phase_histograms(registry, self.prefix)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        if self._hists is not None and name in self._hists:
            self._hists[name].observe(seconds * 1000.0)

    @contextlib.contextmanager
    def phase(self, name: str, **args) -> Iterator[None]:
        """Meter the block as phase ``name``, inside its span."""
        t0 = time.perf_counter()
        with span(name, **args):
            yield
        self.add(name, time.perf_counter() - t0)

    def publish(self, registry: MetricsRegistry) -> None:
        for ph in TRAIN_PHASES:
            d = self.totals.get(ph, 0.0) - self._published.get(ph, 0.0)
            if d > 0.0:
                registry.counter(f"{self.prefix}_phase_{ph}_seconds_total",
                                 f"cumulative {ph} phase seconds").inc(d)
        self._published = dict(self.totals)
