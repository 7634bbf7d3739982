"""Losses (counterpart of ``bigdl_tpu/nn/criterion.py``); so far the two
the LM trains with. Class labels are 0-based integers."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.core.criterion import Criterion

__all__ = ["ClassNLLCriterion", "TimeDistributedCriterion"]


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of (B, C) log-probabilities at (B,) integer
    labels (reference nn/ClassNLLCriterion.scala), with optional per-class
    ``weights`` (then the mean is weighted: sum(w * nll) / sum(w))."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        t = target.long()
        ll = torch.gather(input, 1, t[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=input.device, dtype=input.dtype)[t]
            loss = -(w * ll)
            if self.size_average:
                return loss.sum() / w.sum().clamp_min(1e-12)
            return loss.sum()
        return self._reduce(-ll)


class TimeDistributedCriterion(Criterion):
    """A per-sample criterion over a time dimension: (B, T, ...) input and
    target flatten to (B*T, ...) and go to ``base``."""

    def __init__(self, base: Criterion):
        super().__init__()
        self.base = base

    def forward(self, input, target):
        b, t = input.shape[0], input.shape[1]
        return self.base.forward(input.reshape((b * t,) + input.shape[2:]),
                                 target.reshape((b * t,) + target.shape[2:]))
