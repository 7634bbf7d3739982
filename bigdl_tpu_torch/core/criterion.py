"""Criterion (loss) base class (counterpart of
``bigdl_tpu/core/criterion.py``): ``forward(input, target) -> scalar``,
a mean over the batch unless ``size_average=False``. Gradients come from
autograd on the composed loss; there is no ``updateGradInput``."""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["Criterion"]


class Criterion:
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input: Any, target: Any) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__}.forward")

    def __call__(self, input: Any, target: Any = None) -> torch.Tensor:
        return self.forward(input, target)

    def _reduce(self, per_elem: torch.Tensor) -> torch.Tensor:
        return per_elem.mean() if self.size_average else per_elem.sum()

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"
