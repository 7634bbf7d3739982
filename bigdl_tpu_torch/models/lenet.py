"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``; reference
models/lenet/Model.scala): conv(1->6, 5x5), Tanh, 2x2 max pool, Tanh,
conv(6->12, 5x5), 2x2 max pool, fc(192->100), Tanh, fc(100->classes),
LogSoftMax, over (B, 28, 28, 1) inputs; the JAX topology exactly (its
Tanh after the first pool, none after the second convolution), so a JAX
param tree loads by name. BASELINE config 1, LeNet-5 on MNIST."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["lenet5"]


def lenet5(class_num: int = 10,
           generator: Optional[torch.Generator] = None) -> Sequential:
    return Sequential(
        nn.SpatialConvolution(1, 6, 5, 5, generator=generator),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Tanh(),
        nn.SpatialConvolution(6, 12, 5, 5, generator=generator),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Reshape([12 * 4 * 4]),
        nn.Linear(12 * 4 * 4, 100, generator=generator),
        nn.Tanh(),
        nn.Linear(100, class_num, generator=generator),
        nn.LogSoftMax(),
        name="LeNet5",
    )
