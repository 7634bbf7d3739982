"""What the port's modules share: parameter init, the device rule, the
seeded noise of training-mode layers, and the module bases and containers
every model is built from.

Counterpart of ``bigdl_tpu/core/module.py``. The JAX package keeps
parameters in pytrees beside immutable module descriptions; here they live
in ``torch.nn.Module`` parameters, initialised from an explicit
``torch.Generator``. Containers name their children ``"0"``, ``"1"``, ...
as the JAX package keys its param trees, so a converted tree loads by
name.

Randomness in a forward (Dropout, RReLU) comes from a ``seed`` argument,
the role of the JAX ``rng``: a container hands child ``i`` the seed
``fold_seed(seed, i)``, as the JAX containers hand it ``fold_in(rng, i)``,
and calls a child with no noise under it without one.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
from contextvars import ContextVar
from typing import Callable, Optional, Sequence

import torch
from torch import nn

__all__ = ["xavier_uniform", "uniform_fan_in", "resolve_device",
           "fold_seed", "hash_bits24", "noise_shard", "takes_seed", "Module",
           "SimpleModule", "ElementwiseModule", "Lambda", "Container",
           "Sequential", "Identity"]


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


# ------------------------------------------------------------ seeded noise
def _s64(c: int) -> int:
    """A 64-bit constant as the int64 that has its bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN, _MIX1, _MIX2 = (_s64(0x9E3779B97F4A7C15), _s64(0xBF58476D1CE4E5B9),
                         _s64(0x94D049BB133111EB))
_MASK64 = (1 << 64) - 1


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser on int64 tensors (products wrap)."""
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def fold_seed(seed, i: int) -> torch.Tensor:
    """A seed for stream ``i`` derived from ``seed`` (the role of
    ``jax.random.fold_in``): the splitmix64 finaliser of the pair, as a 0-d
    int64 tensor on ``seed``'s device. ``seed`` is an int or an int64
    tensor; folding runs on the device, so a step captured in a CUDA graph
    folds the seed written before each replay."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return _mix(seed * _GOLDEN
                + _s64((int(i) + 1) * 0xBF58476D1CE4E5B9 & _MASK64))


# the data-axis rank a training step runs under, set by
# DataParallel.compile_step: a rank's tensors are its part of the batch
_NOISE_SHARD: ContextVar = ContextVar("bigdl_tpu_torch_noise_shard",
                                      default=0)


@contextlib.contextmanager
def noise_shard(rank: int):
    """Within this context :func:`hash_bits24` counts the elements of a
    tensor from ``rank`` times its size: the index the element has in the
    global batch when every rank holds an equal contiguous part of dim 0,
    so a data-parallel step draws the single process's noise."""
    token = _NOISE_SHARD.set(int(rank))
    try:
        yield
    finally:
        _NOISE_SHARD.reset(token)


def hash_bits24(seed, like: torch.Tensor) -> torch.Tensor:
    """24 random bits per element of ``like`` (int64 in [0, 2^24)): a
    counter-based hash of (``seed``, element index) computed on ``like``'s
    device, so the same seed draws the same bits eagerly, in a recomputed
    layer and in a CUDA-graph replay, and no generator state is read.
    Under :func:`noise_shard` the index is the element's in the global
    batch."""
    seed = torch.as_tensor(seed, dtype=torch.int64).to(like.device)
    rank = _NOISE_SHARD.get()
    idx = torch.arange(rank * like.numel(), (rank + 1) * like.numel(),
                       device=like.device).reshape(like.shape)
    return _srl(_mix(idx * _MIX2 + seed * _GOLDEN), 40)


@functools.lru_cache(maxsize=None)
def _has_seed(forward) -> bool:
    """Whether a class's ``forward`` function has a ``seed`` parameter."""
    return "seed" in inspect.signature(forward).parameters


def takes_seed(module: nn.Module) -> bool:
    """Whether a training-mode call of ``module`` takes ``seed=``: its
    forward has a ``seed`` parameter and, for the port's containers, a
    module under it draws noise (``draws_noise``). A container of none is
    called without a seed, so its step folds none."""
    if not _has_seed(type(module).forward):
        return False
    if isinstance(module, (Sequential, Container)):
        return any(getattr(m, "draws_noise", False)
                   for m in module.modules())
    return True


def _call(module: nn.Module, x, seed, i: int):
    """``module(x)``, with ``fold_seed(seed, i)`` when a seed is given and
    the module takes one (child ``i`` of a container)."""
    if seed is not None and takes_seed(module):
        return module(x, seed=fold_seed(seed, i))
    return module(x)


# ------------------------------------------------------------------ bases
class Module(nn.Module):
    """Base of the port's layers: a ``torch.nn.Module`` with the JAX
    module's display ``name`` (its class name unless given). Parameters are
    ``nn.Parameter`` attributes named as the JAX param tree's keys;
    running statistics are buffers named as its state tree's keys."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__


class SimpleModule(Module):
    """A module whose forward updates no state (the JAX ``SimpleModule``:
    ``apply`` returns the state it was given). Subclasses define
    ``forward``."""


class ElementwiseModule(SimpleModule):
    """A parameterless op given by one function ``_fn`` of the input."""

    def _fn(self, x):
        raise NotImplementedError(f"{type(self).__name__}._fn")

    def forward(self, x):
        return self._fn(x)


class Identity(ElementwiseModule):
    """Pass-through (reference nn/Identity.scala)."""

    def _fn(self, x):
        return x


class Lambda(SimpleModule):
    """An arbitrary function of the input as a parameterless module; its
    name is the function's unless given."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__(name or getattr(fn, "__name__", "Lambda"))
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class Container(Module):
    """An ordered list of children named ``"0"``, ``"1"``, ... (reference
    nn/Container.scala), the keys of the JAX container's param tree.
    Subclasses define ``forward``."""

    def __init__(self, *modules: nn.Module, name: Optional[str] = None):
        super().__init__(name)
        for m in modules:
            self.add(m)

    def add(self, module: nn.Module) -> "Container":
        """Append a child (Container.add); returns the container."""
        self.add_module(str(len(self._modules)), module)
        return self

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]


class Sequential(nn.Sequential):
    """Feed-forward chain (reference nn/Sequential.scala); children are
    ``"0"``, ``"1"``, ... as in the JAX package's param tree. ``name`` is
    the JAX module's display name. A training call with ``seed`` hands
    child ``i`` ``fold_seed(seed, i)`` where it draws noise."""

    def __init__(self, *modules: nn.Module, name: Optional[str] = None):
        super().__init__(*modules)
        self.name = name if name is not None else type(self).__name__

    def add(self, module: nn.Module) -> "Sequential":
        """Append a child (Container.add); returns the container."""
        self.append(module)
        return self

    def forward(self, x, seed=None):
        for i, m in enumerate(self):
            x = _call(m, x, seed, i)
        return x
