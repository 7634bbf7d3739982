"""Linear layers (counterpart of ``Linear`` and ``LookupTable`` in
``bigdl_tpu/nn/linear.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.module import uniform_fan_in, xavier_uniform

__all__ = ["Linear", "LookupTable"]


class Linear(nn.Module):
    """y = x @ W + b (reference nn/Linear.scala) with ``weight`` kept
    (in_features, out_features) as in the JAX package, so its leaves load
    as they are. Init "default" is U(+-1/sqrt(in)), "xavier" Xavier
    uniform for the weight (the bias keeps the default). The weight and
    bias are cast to the input's dtype."""

    def __init__(self, in_features: int, out_features: int,
                 with_bias: bool = True, init: str = "default",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__()
        if init not in ("default", "xavier"):
            raise ValueError(f"init {init!r} not in ('default', 'xavier')")
        self.name = name if name is not None else type(self).__name__
        self.in_features, self.out_features = in_features, out_features
        self.with_bias = with_bias
        shape = (in_features, out_features)
        self.weight = nn.Parameter(
            xavier_uniform(shape, in_features, out_features, generator)
            if init == "xavier" else uniform_fan_in(shape, in_features,
                                                    generator))
        if with_bias:
            self.bias = nn.Parameter(uniform_fan_in((out_features,),
                                                    in_features, generator))

    def forward(self, x):
        y = x @ self.weight.to(x.dtype)
        if self.with_bias:
            y = y + self.bias.to(x.dtype)
        return y


class LookupTable(nn.Module):
    """Embedding lookup: ``weight`` (n_index, n_output), init N(0, 1),
    0-based indices. ``max_norm`` is not ported (the LM does not use it)."""

    def __init__(self, n_index: int, n_output: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.weight = nn.Parameter(torch.empty(n_index, n_output).normal_(
            generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight[x.long()]
