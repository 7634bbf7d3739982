"""Structural layers (counterpart of ``bigdl_tpu/nn/structural.py``); so
far the one the LM trains with: Dropout."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout", "fold_seed"]

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, i: int) -> int:
    """A seed for stream ``i`` derived from ``seed`` (the role of
    ``jax.random.fold_in``): the splitmix64 finaliser of the pair, cut to
    63 bits so ``torch.Generator.manual_seed`` takes it."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xBF58476D1CE4E5B9
         ) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Dropout(nn.Module):
    """Inverted dropout (reference nn/Dropout.scala): at train time each
    element is kept with probability 1 - p and scaled by 1/(1 - p);
    identity at eval. The noise comes from an explicit
    ``torch.Generator``: the same generator state draws the same mask,
    which is what lets a recomputed (remat) layer repeat its dropout.
    Not jax's bits: threefry and Philox differ."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout needs a generator in training mode")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"
