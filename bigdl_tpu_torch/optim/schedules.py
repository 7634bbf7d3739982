"""Learning-rate schedules (counterpart of ``bigdl_tpu/optim/schedules.py``;
reference optim/SGD.scala:103-186): lr(base_lr, step, epoch) -> the
effective rate. Ported so far: ``Default``, and ``EpochSchedule`` with
its regimes (``Regime``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

__all__ = ["LearningRateSchedule", "Default", "Regime", "EpochSchedule"]


class LearningRateSchedule:
    def __call__(self, base_lr: float, step: int, epoch: int) -> float:
        raise NotImplementedError


@dataclass
class Default(LearningRateSchedule):
    """base_lr / (1 + step * decay) (reference SGD.Default)."""

    decay: float = 0.0

    def __call__(self, base_lr, step, epoch):
        return base_lr / (1.0 + step * self.decay)


@dataclass
class Regime:
    """[start_epoch, end_epoch] -> lr (reference SGD.Regime)."""

    start_epoch: int
    end_epoch: int
    lr: float


@dataclass
class EpochSchedule(LearningRateSchedule):
    """Piecewise-constant lr by epoch (reference SGD.EpochSchedule): the
    last regime holding ``epoch`` wins, base_lr where none does."""

    regimes: Sequence[Regime]

    def __call__(self, base_lr, step, epoch):
        lr = base_lr
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                lr = r.lr
        return lr
