"""Learning-rate schedules (counterpart of ``bigdl_tpu/optim/schedules.py``;
reference optim/SGD.scala:103-186).

A schedule is a function ``lr(base_lr, step, epoch)`` of the optimizer
state's counters, 0-d f32 tensors on the parameters' device, that returns
a 0-d f32 tensor computed with torch ops and no host sync, as the JAX
ones are computed with jnp inside the jitted step. So a step captured in
a CUDA graph sees the rate change on every replay. Python numbers are
taken too (they become CPU tensors). Constants enter as Python numbers
or ``full_like`` the counters: a CPU tensor copied to the card would be
a host-to-device copy, which a CUDA graph capture refuses."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

__all__ = ["LearningRateSchedule", "Default", "Poly", "Step", "EpochDecay",
           "EpochStep", "Regime", "EpochSchedule", "CosineAnnealing",
           "Warmup"]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


class LearningRateSchedule:
    """lr(base_lr, step, epoch) -> the effective rate, a 0-d f32 tensor."""

    def __call__(self, base_lr, step, epoch) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class Default(LearningRateSchedule):
    """base_lr / (1 + step * decay) (reference SGD.Default)."""

    decay: float = 0.0

    def __call__(self, base_lr, step, epoch):
        return base_lr / (1.0 + _f32(step) * self.decay)


@dataclass
class Poly(LearningRateSchedule):
    """base_lr * (1 - step/max_iteration)^power, 0 after max_iteration
    (reference SGD.Poly)."""

    power: float
    max_iteration: int

    def __call__(self, base_lr, step, epoch):
        frac = torch.clamp(_f32(step) / self.max_iteration, 0.0, 1.0)
        return base_lr * torch.pow(1.0 - frac, self.power)


@dataclass
class Step(LearningRateSchedule):
    """base_lr * gamma^(step // step_size) (reference SGD.Step)."""

    step_size: int
    gamma: float

    def __call__(self, base_lr, step, epoch):
        return base_lr * torch.pow(
            float(self.gamma), torch.floor(_f32(step) / self.step_size))


@dataclass
class EpochDecay(LearningRateSchedule):
    """base_lr * decay_fn(epoch) (reference SGD.EpochDecay). ``decay_fn``
    takes the epoch as a 0-d f32 tensor and must compute with torch ops:
    a host branch on it would freeze in a captured step."""

    decay_fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, base_lr, step, epoch):
        epoch = _f32(epoch)
        d = self.decay_fn(epoch)
        if not isinstance(d, torch.Tensor):
            d = torch.full_like(epoch, d)
        return base_lr * d.float()


@dataclass
class EpochStep(LearningRateSchedule):
    """base_lr * gamma^(epoch // step_size) (reference SGD.EpochStep)."""

    step_size: int
    gamma: float

    def __call__(self, base_lr, step, epoch):
        return base_lr * torch.pow(
            float(self.gamma), torch.floor(_f32(epoch) / self.step_size))


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
        epoch = _f32(epoch)
        lr = torch.full_like(epoch, base_lr)
        for r in self.regimes:
            hit = (epoch >= r.start_epoch) & (epoch <= r.end_epoch)
            lr = torch.where(hit, torch.full_like(lr, r.lr), lr)
        return lr


@dataclass
class CosineAnnealing(LearningRateSchedule):
    """base_lr * (min_frac + (1 - min_frac) * (1 + cos(pi*step/total))/2)
    (the JAX package's, beyond the reference)."""

    total_steps: int
    min_frac: float = 0.0

    def __call__(self, base_lr, step, epoch):
        frac = torch.clamp(_f32(step) / self.total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (self.min_frac + (1.0 - self.min_frac) * cos)


@dataclass
class Warmup(LearningRateSchedule):
    """Linear warmup over ``warmup_steps``, then ``after`` counted from
    the end of warmup (a constant base_lr when None)."""

    warmup_steps: int
    after: Optional[LearningRateSchedule] = None

    def __call__(self, base_lr, step, epoch):
        step = _f32(step)
        warm = base_lr * torch.clamp(
            (step + 1.0) / max(1.0, float(self.warmup_steps)), max=1.0)
        if self.after is None:
            rest = torch.full_like(step, base_lr)
        else:
            rest = _f32(self.after(base_lr, torch.clamp(
                step - self.warmup_steps, min=0.0), epoch))
        return torch.where(step < self.warmup_steps, warm, rest)
