"""Triggers: predicates over the training loop's progress (epoch,
iteration, loss) that end training (counterpart of
``bigdl_tpu/optim/triggers.py``; reference optim/Trigger.scala)."""

from __future__ import annotations

from typing import Callable, Dict

__all__ = ["Trigger"]


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool], desc: str):
        self._fn = fn
        self.desc = desc

    def __call__(self, progress: Dict) -> bool:
        return self._fn(progress)

    def __repr__(self):
        return f"Trigger({self.desc})"

    @staticmethod
    def every_epoch() -> "Trigger":
        return Trigger(lambda s: s.get("epoch_finished", False), "everyEpoch")

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        """Fires when the iteration counter crosses a multiple of n."""
        def fn(s):
            it = s["iteration"]
            prev = s.get("prev_iteration", it - 1)
            return it > 0 and it // n != prev // n
        return Trigger(fn, f"severalIteration({n})")

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        """True once epoch > n (epochs are 1-based, as in the reference)."""
        return Trigger(lambda s: s["epoch"] > n, f"maxEpoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s["iteration"] >= n, f"maxIteration({n})")

    @staticmethod
    def min_loss(v: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss", float("inf")) < v,
                       f"minLoss({v})")

    @staticmethod
    def and_(*ts: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in ts), "and")

    @staticmethod
    def or_(*ts: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in ts), "or")
