"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``); so far the
two the ResNets use."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["ReLU", "LogSoftMax"]


class ReLU(nn.Module):
    """max(x, 0) (reference nn/ReLU.scala); its gradient at 0 is 0, as
    ``jax.nn.relu``'s."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__

    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(nn.Module):
    """Log-softmax over ``axis`` (reference nn/LogSoftMax.scala), in the
    input's dtype."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__()
        self.axis = axis
        self.name = name if name is not None else type(self).__name__

    def forward(self, x):
        return torch.log_softmax(x, dim=self.axis)
