"""Fully-connected autoencoder on MNIST (counterpart of
``bigdl_tpu/models/autoencoder.py``; reference
models/autoencoder/Autoencoder.scala): 784 -> ``class_num`` ReLU -> 784
Sigmoid, trained with MSE."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["autoencoder"]


def autoencoder(class_num: int = 32,
                generator: Optional[torch.Generator] = None) -> Sequential:
    """``class_num`` is the bottleneck's width (the reference's classNum)."""
    return Sequential(
        nn.Reshape([28 * 28]),
        nn.Linear(28 * 28, class_num, generator=generator),
        nn.ReLU(),
        nn.Linear(class_num, 28 * 28, generator=generator),
        nn.Sigmoid(),
        name="Autoencoder",
    )
