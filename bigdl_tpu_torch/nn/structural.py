"""Structural layers (counterpart of ``bigdl_tpu/nn/structural.py``): the
ones the LM and the ResNets use (Dropout, ConcatTable, CAddTable, Reshape,
Padding) and the BN+ReLU rewrite of the fused BN block. Tables are
tuples; dimensions are 0-based, batch first."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Identity, Sequential

__all__ = ["Dropout", "fold_seed", "ConcatTable", "CAddTable", "Reshape",
           "Padding", "absorb_bn_relu"]

def _s64(c: int) -> int:
    """A 64-bit constant as the int64 that has its bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN, _MIX1, _MIX2 = (_s64(0x9E3779B97F4A7C15), _s64(0xBF58476D1CE4E5B9),
                         _s64(0x94D049BB133111EB))


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser on int64 tensors (products wrap)."""
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


_MASK64 = (1 << 64) - 1


def fold_seed(seed, i: int) -> torch.Tensor:
    """A seed for stream ``i`` derived from ``seed`` (the role of
    ``jax.random.fold_in``): the splitmix64 finaliser of the pair, as a 0-d
    int64 tensor on ``seed``'s device. ``seed`` is an int or an int64
    tensor; folding runs on the device, so a step captured in a CUDA graph
    folds the seed written before each replay."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return _mix(seed * _GOLDEN
                + _s64((int(i) + 1) * 0xBF58476D1CE4E5B9 & _MASK64))


class Dropout(nn.Module):
    """Inverted dropout (reference nn/Dropout.scala): at train time each
    element is kept with probability 1 - p and scaled by 1/(1 - p);
    identity at eval. The noise is a counter-based hash of (``seed``,
    element index) computed on the device, so the same seed draws the same
    mask eagerly, in a recomputed (remat) layer and in a CUDA-graph
    replay, and no generator state is read. Not jax's bits: threefry
    differs, so the two packages agree in distribution only."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x, seed=None):
        if not self.training or self.p == 0.0:
            return x
        if seed is None:
            raise ValueError("Dropout needs a seed in training mode")
        keep = 1.0 - self.p
        seed = torch.as_tensor(seed, dtype=torch.int64).to(x.device)
        idx = torch.arange(x.numel(), device=x.device).reshape(x.shape)
        bits = _srl(_mix(idx * _MIX2 + seed * _GOLDEN), 40)  # 24 bits
        mask = bits < int(keep * (1 << 24))
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def absorb_bn_relu(module: nn.Module) -> int:
    """In every :class:`~bigdl_tpu_torch.core.module.Sequential` under
    ``module``, a ReLU (exactly ``ReLU``, not a subclass) directly after a
    BatchNormalization is absorbed into it (``bn.fuse_relu = True``) and
    replaced by an :class:`~bigdl_tpu_torch.core.module.Identity`; both own
    no parameters, so the names of every other parameter stay. Only
    Sequential adjacency is data flow: siblings of a ConcatTable share an
    input. Returns the number absorbed; a second pass absorbs none."""
    from bigdl_tpu_torch.nn.activation import ReLU
    from bigdl_tpu_torch.nn.norm import BatchNormalization

    count = 0
    for m in list(module.modules()):
        if not isinstance(m, Sequential):
            continue
        for i in range(len(m) - 1):
            if isinstance(m[i], BatchNormalization) and type(m[i + 1]) is ReLU:
                m[i].fuse_relu = True
                m[i + 1] = Identity(name=f"{m[i + 1].name}(absorbed)")
                count += 1
    return count


class ConcatTable(nn.Module):
    """Run every child on the same input; output the tuple of results
    (reference nn/ConcatTable.scala). Children are ``"0"``, ``"1"``, ..."""

    def __init__(self, *modules: nn.Module, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def forward(self, x):
        return tuple(m(x) for m in self.children())


class CAddTable(nn.Module):
    """Sum of a table's tensors, left to right (reference
    nn/CAddTable.scala)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = out + t
        return out


class Reshape(nn.Module):
    """Reshape the non-batch dims to ``size`` (reference nn/Reshape.scala;
    axis 0 is always the batch)."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__
        self.size = tuple(size)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.size)


class Padding(nn.Module):
    """Pad ``|pad|`` entries of ``value`` along ``axis``, before it when
    ``pad`` < 0, after it otherwise (reference nn/Padding.scala)."""

    def __init__(self, axis: int, pad: int, value: float = 0.0,
                 name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__
        self.axis, self.pad, self.value = axis, pad, value

    def forward(self, x):
        ax = self.axis % x.dim()
        widths = [0, 0] * (x.dim() - ax)  # F.pad lists the last dim first
        widths[-2:] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, widths, value=self.value)
