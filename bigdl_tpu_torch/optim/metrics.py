"""Named metric counters of the training loop (counterpart of
``bigdl_tpu/optim/metrics.py``; reference optim/Metrics.scala), host-side
and per process. The cross-process aggregate comes with data
parallelism."""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["Metrics"]


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._sum: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._sum[name] = float(value)
            self._count[name] = 1

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._sum[name] = self._sum.get(name, 0.0) + float(value)
            self._count[name] = self._count.get(name, 0) + 1

    def get(self, name: str) -> tuple:
        with self._lock:
            return self._sum.get(name, 0.0), self._count.get(name, 0)

    def mean(self, name: str) -> float:
        s, c = self.get(name)
        return s / c if c else 0.0

    def reset(self) -> None:
        with self._lock:
            self._sum.clear()
            self._count.clear()

    def summary(self, unit: str = "s", scale: float = 1.0) -> str:
        """Every counter's sum and mean (reference Metrics.summary)."""
        with self._lock:
            lines = [f"  {k}: sum={v / scale:.4g}{unit} "
                     f"mean={v / max(1, self._count[k]) / scale:.4g}{unit}"
                     for k, v in sorted(self._sum.items())]
        return "\n".join(["Metrics:"] + lines)
