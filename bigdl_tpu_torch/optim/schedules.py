"""Learning-rate schedules (counterpart of ``bigdl_tpu/optim/schedules.py``;
reference optim/SGD.scala:103-186): lr(base_lr, step, epoch) -> the
effective rate. Only ``Default`` is ported so far."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LearningRateSchedule", "Default"]


class LearningRateSchedule:
    def __call__(self, base_lr: float, step: int, epoch: int) -> float:
        raise NotImplementedError


@dataclass
class Default(LearningRateSchedule):
    """base_lr / (1 + step * decay) (reference SGD.Default)."""

    decay: float = 0.0

    def __call__(self, base_lr, step, epoch):
        return base_lr / (1.0 + step * self.decay)
