"""What the port's modules share: parameter init, the device rule, and
the containers every model is built from.

Counterpart of ``bigdl_tpu/core/module.py``. The JAX package keeps
parameters in pytrees beside immutable module descriptions; here they live
in ``torch.nn.Module`` parameters, initialised from an explicit
``torch.Generator``. Containers name their children ``"0"``, ``"1"``, ...
as the JAX package keys its param trees, so a converted tree loads by
name.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["xavier_uniform", "uniform_fan_in", "resolve_device", "Sequential",
           "Identity"]


def uniform_fan_in(shape: Sequence[int], fan_in: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Torch-style default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    stdv = 1.0 / math.sqrt(max(1, fan_in))
    return torch.empty(tuple(shape)).uniform_(-stdv, stdv,
                                              generator=generator)


def xavier_uniform(shape: Sequence[int], fan_in: int, fan_out: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Xavier/Glorot uniform: U(+-sqrt(6/(fan_in+fan_out))), the same
    distribution as the JAX package's ``xavier_uniform`` (not the same
    numbers: torch's generator is not jax's threefry)."""
    a = math.sqrt(6.0 / max(1, fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(
        -a, a, generator=generator)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA on a machine without it raises instead of
    running on the CPU in silence."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--platform cpu on the command line) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


class Sequential(nn.Sequential):
    """Feed-forward chain (reference nn/Sequential.scala); children are
    ``"0"``, ``"1"``, ... as in the JAX package's param tree. ``name`` is
    the JAX module's display name."""

    def __init__(self, *modules: nn.Module, name: Optional[str] = None):
        super().__init__(*modules)
        self.name = name if name is not None else type(self).__name__

    def add(self, module: nn.Module) -> "Sequential":
        """Append a child (Container.add); returns the container."""
        self.append(module)
        return self


class Identity(nn.Module):
    """Pass-through (reference nn/Identity.scala)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__

    def forward(self, x):
        return x
