"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``; reference
nn/{ReLU,Tanh,...}.scala): each the JAX layer's function of the input,
in the input's dtype. Two differ from an elementwise function:

* ``PReLU`` learns its slope (``weight``, one per channel or one shared);
* ``RReLU`` draws a slope per element in training. The JAX layer draws
  it with ``jax.random.uniform``; the port draws it from the splitmix64
  hash of (``seed``, element) that ``Dropout`` uses, so the two agree in
  distribution (each slope in [lower, upper)), not in bits. At eval both
  use the mean slope, exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import (ElementwiseModule, SimpleModule,
                                         hash_bits24)

__all__ = [
    "ReLU", "ReLU6", "PReLU", "RReLU", "LeakyReLU", "ELU", "Threshold",
    "Tanh", "TanhShrink", "Sigmoid", "LogSigmoid", "HardTanh", "HardShrink",
    "SoftShrink", "SoftPlus", "SoftSign", "SoftMax", "SoftMin", "LogSoftMax",
    "Power", "Square", "Sqrt", "Abs", "Exp", "Log", "Clamp",
    "GradientReversal",
]


class ReLU(ElementwiseModule):
    """max(x, 0) (reference nn/ReLU.scala); its gradient at 0 is 0, as
    ``jax.nn.relu``'s."""

    def _fn(self, x):
        return torch.relu(x)


class ReLU6(ElementwiseModule):
    """min(max(x, 0), 6) (reference nn/ReLU6.scala)."""

    def _fn(self, x):
        return F.relu6(x)


class Threshold(ElementwiseModule):
    """x where x > th, else v (reference nn/Threshold.scala)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.th, self.v = th, v

    def _fn(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class PReLU(SimpleModule):
    """Parametric ReLU (reference nn/PReLU.scala): slope ``weight``
    initialised to 0.25, one per channel (the last axis) or, with
    ``n_output_plane=0``, one shared (a (1,) weight, as in the JAX
    tree)."""

    def __init__(self, n_output_plane: int = 0, name: Optional[str] = None):
        super().__init__(name)
        self.n_output_plane = n_output_plane
        self.weight = nn.Parameter(torch.full((max(1, n_output_plane),),
                                              0.25))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.n_output_plane == 0:
            w = w[0]
        return torch.where(x >= 0, x, w * x)


class RReLU(SimpleModule):
    """Randomised leaky ReLU (reference nn/RReLU.scala): in training each
    negative element's slope is drawn from U(lower, upper) by
    ``hash_bits24(seed, x)`` (a seed is required, as the JAX layer
    requires an rng); at eval the slope is (lower + upper) / 2."""

    draws_noise = True

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name: Optional[str] = None):
        super().__init__(name)
        self.lower, self.upper = lower, upper

    def forward(self, x, seed=None):
        if self.training:
            if seed is None:
                raise ValueError("RReLU needs a seed in training mode")
            u = hash_bits24(seed, x).to(x.dtype) * (1.0 / (1 << 24))
            a = self.lower + (self.upper - self.lower) * u
        else:
            a = torch.tensor((self.lower + self.upper) / 2, dtype=x.dtype,
                             device=x.device)
        return torch.where(x >= 0, x, a * x)


class LeakyReLU(ElementwiseModule):
    """x where x >= 0, else negval * x (reference nn/LeakyReLU.scala)."""

    def __init__(self, negval: float = 0.01, name: Optional[str] = None):
        super().__init__(name)
        self.negval = negval

    def _fn(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class ELU(ElementwiseModule):
    """x where x > 0, else alpha * (exp(x) - 1) (reference nn/ELU.scala);
    the exponential sees only the non-positive side."""

    def __init__(self, alpha: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.alpha = alpha

    def _fn(self, x):
        safe = torch.where(x > 0, torch.zeros_like(x), x)
        return torch.where(x > 0, x, self.alpha * torch.expm1(safe))


class Tanh(ElementwiseModule):
    """(reference nn/Tanh.scala)"""

    def _fn(self, x):
        return torch.tanh(x)


class TanhShrink(ElementwiseModule):
    """x - tanh(x) (reference nn/TanhShrink.scala)."""

    def _fn(self, x):
        return x - torch.tanh(x)


class Sigmoid(ElementwiseModule):
    """(reference nn/Sigmoid.scala)"""

    def _fn(self, x):
        return torch.sigmoid(x)


class LogSigmoid(ElementwiseModule):
    """(reference nn/LogSigmoid.scala)"""

    def _fn(self, x):
        return F.logsigmoid(x)


class HardTanh(ElementwiseModule):
    """clip(x, min_value, max_value) (reference nn/HardTanh.scala)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 name: Optional[str] = None):
        super().__init__(name)
        if not max_value > min_value:
            raise ValueError(f"max_value {max_value} must exceed min_value "
                             f"{min_value}")
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    """HardTanh with integer bounds (reference nn/Clamp.scala)."""

    def __init__(self, min_value: int, max_value: int,
                 name: Optional[str] = None):
        super().__init__(float(min_value), float(max_value), name)


class HardShrink(ElementwiseModule):
    """x where |x| > lam, else 0 (reference nn/HardShrink.scala)."""

    def __init__(self, lam: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.lam = lam

    def _fn(self, x):
        return torch.where(x.abs() > self.lam, x, torch.zeros_like(x))


class SoftShrink(ElementwiseModule):
    """sign(x) * max(|x| - lam, 0) (reference nn/SoftShrink.scala)."""

    def __init__(self, lam: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.lam = lam

    def _fn(self, x):
        return torch.sign(x) * torch.clamp_min(x.abs() - self.lam, 0.0)


class SoftPlus(ElementwiseModule):
    """log(1 + exp(beta * x)) / beta (reference nn/SoftPlus.scala), as the
    JAX layer computes it (``jax.nn.softplus``, a log-add-exp with 0): no
    linear threshold."""

    def __init__(self, beta: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.beta = beta

    def _fn(self, x):
        z = self.beta * x
        return torch.logaddexp(z, torch.zeros_like(z)) / self.beta


class SoftSign(ElementwiseModule):
    """x / (1 + |x|) (reference nn/SoftSign.scala)."""

    def _fn(self, x):
        return x / (1 + x.abs())


class SoftMax(ElementwiseModule):
    """Softmax over ``axis`` (default the last, the features)
    (reference nn/SoftMax.scala)."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def _fn(self, x):
        return torch.softmax(x, dim=self.axis)


class SoftMin(ElementwiseModule):
    """softmax(-x) over ``axis`` (reference nn/SoftMin.scala)."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def _fn(self, x):
        return torch.softmax(-x, dim=self.axis)


class LogSoftMax(ElementwiseModule):
    """Log-softmax over ``axis`` (reference nn/LogSoftMax.scala), in the
    input's dtype."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def _fn(self, x):
        return torch.log_softmax(x, dim=self.axis)


class Power(ElementwiseModule):
    """(shift + scale * x) ^ power (reference nn/Power.scala)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(ElementwiseModule):
    """(reference nn/Square.scala)"""

    def _fn(self, x):
        return torch.square(x)


class Sqrt(ElementwiseModule):
    """(reference nn/Sqrt.scala)"""

    def _fn(self, x):
        return torch.sqrt(x)


class Abs(ElementwiseModule):
    """(reference nn/Abs.scala)"""

    def _fn(self, x):
        return torch.abs(x)


class Exp(ElementwiseModule):
    """(reference nn/Exp.scala)"""

    def _fn(self, x):
        return torch.exp(x)


class Log(ElementwiseModule):
    """(reference nn/Log.scala)"""

    def _fn(self, x):
        return torch.log(x)


class _Reverse(torch.autograd.Function):
    """Identity forward, -lam * grad backward (the JAX layer's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, lam: float):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(SimpleModule):
    """Identity forward, -lam times the gradient backward (reference
    nn/GradientReversal.scala)."""

    def __init__(self, lam: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.lam = lam

    def forward(self, x):
        return _Reverse.apply(x, self.lam)
