"""Linear-algebra layers (counterpart of ``bigdl_tpu/nn/linear.py``;
reference nn/{Linear,Bilinear,CMul,...}.scala). Every weight keeps the
JAX package's shape and orientation (``Linear``'s is (in, out)), so the
JAX leaves load as they are. The table layers (``Bilinear``, ``MM``,
``MV``, ``DotProduct``, ``CosineDistance``, ``PairwiseDistance``) take a
tuple, as the JAX ones do."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from bigdl_tpu_torch.core.module import (SimpleModule, uniform_fan_in,
                                         xavier_uniform)

__all__ = [
    "Linear", "Bilinear", "CMul", "CAdd", "Mul", "Add", "MulConstant",
    "AddConstant", "MM", "MV", "Cosine", "Euclidean", "DotProduct",
    "CosineDistance", "PairwiseDistance", "LookupTable",
]


class Linear(SimpleModule):
    """y = x @ W + b (reference nn/Linear.scala) with ``weight`` kept
    (in_features, out_features) as in the JAX package, so its leaves load
    as they are. Init "default" is U(+-1/sqrt(in)), "xavier" Xavier
    uniform for the weight (the bias keeps the default). The weight and
    bias are cast to the input's dtype. Under tensor parallelism
    (``parallel.TensorParallel``) ``_tp`` is its split: a column-split
    Linear copies its input to the model axis, a row-split one reduces
    its product over it and adds the whole bias after the reduce."""

    _tp = None

    def __init__(self, in_features: int, out_features: int,
                 with_bias: bool = True, init: str = "default",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if init not in ("default", "xavier"):
            raise ValueError(f"init {init!r} not in ('default', 'xavier')")
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
        tp = self._tp
        if tp is not None and tp.mode == "col":
            x = tp.copy(x)
        y = x @ self.weight.to(x.dtype)
        if tp is not None and tp.mode == "row":
            y = tp.reduce(y)
        if self.with_bias:
            y = y + self.bias.to(x.dtype)
        return y


class Bilinear(SimpleModule):
    """y_k = x1 @ W_k @ x2 + b_k over a table (x1, x2) (reference
    nn/Bilinear.scala): ``weight`` (out, in1, in2), init
    U(+-1/sqrt(in1*in2)) as the bias."""

    def __init__(self, in1: int, in2: int, out: int, with_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.in1, self.in2, self.out = in1, in2, out
        self.with_bias = with_bias
        fan_in = in1 * in2
        self.weight = nn.Parameter(uniform_fan_in((out, in1, in2), fan_in,
                                                  generator))
        if with_bias:
            self.bias = nn.Parameter(uniform_fan_in((out,), fan_in,
                                                    generator))

    def forward(self, x):
        x1, x2 = x
        y = torch.einsum("bi,oij,bj->bo", x1, self.weight.to(x1.dtype), x2)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y


class CMul(SimpleModule):
    """A learned componentwise scale ``weight`` of shape ``size``,
    broadcast over the input from its last axes (reference nn/CMul.scala);
    init U(+-1/sqrt(prod(size)))."""

    def __init__(self, size: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.weight = nn.Parameter(uniform_fan_in(
            self.size, math.prod(self.size), generator))

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class CAdd(SimpleModule):
    """A learned componentwise ``bias`` of shape ``size`` (reference
    nn/CAdd.scala); init as CMul's."""

    def __init__(self, size: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.bias = nn.Parameter(uniform_fan_in(
            self.size, math.prod(self.size), generator))

    def forward(self, x):
        return x + self.bias.to(x.dtype)


class Mul(SimpleModule):
    """One learned scalar gain, a 0-d ``weight`` from U(-1, 1) (reference
    nn/Mul.scala)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.weight = nn.Parameter(torch.empty(()).uniform_(
            -1.0, 1.0, generator=generator))

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class Add(SimpleModule):
    """A learned ``bias`` over the feature axis (reference nn/Add.scala);
    init U(+-1/sqrt(input_size))."""

    def __init__(self, input_size: int,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.bias = nn.Parameter(uniform_fan_in((input_size,), input_size,
                                                generator))

    def forward(self, x):
        return x + self.bias.to(x.dtype)


class MulConstant(SimpleModule):
    """x * constant (reference nn/MulConstant.scala)."""

    def __init__(self, constant: float, name: Optional[str] = None):
        super().__init__(name)
        self.constant = constant

    def forward(self, x):
        return x * self.constant


class AddConstant(SimpleModule):
    """x + constant (reference nn/AddConstant.scala)."""

    def __init__(self, constant: float, name: Optional[str] = None):
        super().__init__(name)
        self.constant = constant

    def forward(self, x):
        return x + self.constant


class MM(SimpleModule):
    """Batched matrix product of a table (A, B), either transposed first
    (reference nn/MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, x):
        a, b = x
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return a @ b


class MV(SimpleModule):
    """Batched matrix-vector product of a table (M, v), M transposed first
    with ``trans`` (reference nn/MV.scala)."""

    def __init__(self, trans: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.trans = trans

    def forward(self, x):
        m, v = x
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


def _unit(t: torch.Tensor, eps: float) -> torch.Tensor:
    """Rows of ``t`` over max(their L2 norm, eps)."""
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True
                                        ).clamp_min(eps)


class Cosine(SimpleModule):
    """y_j = cos(x, w_j) against a learned bank ``weight`` (output_size,
    input_size) (reference nn/Cosine.scala); each norm floored at
    ``eps``."""

    def __init__(self, input_size: int, output_size: int, eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.output_size, self.eps = (input_size,
                                                       output_size, eps)
        self.weight = nn.Parameter(uniform_fan_in(
            (output_size, input_size), input_size, generator))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        return _unit(x, self.eps) @ _unit(w, self.eps).T


class Euclidean(SimpleModule):
    """y_j = ||x - w_j|| to learned centres ``weight`` (output_size,
    input_size) (reference nn/Euclidean.scala), sqrt(sum + 1e-12) as in
    the JAX layer."""

    def __init__(self, input_size: int, output_size: int,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.weight = nn.Parameter(uniform_fan_in(
            (output_size, input_size), input_size, generator))

    def forward(self, x):
        d = x[..., None, :] - self.weight.to(x.dtype)
        return torch.sqrt(d.square().sum(-1) + 1e-12)


class DotProduct(SimpleModule):
    """Row-wise dot product of a table (a, b) (reference
    nn/DotProduct.scala)."""

    def forward(self, x):
        a, b = x
        return (a * b).sum(-1)


class CosineDistance(SimpleModule):
    """Row-wise cosine similarity of a table (a, b), each norm floored at
    ``eps`` (reference nn/CosineDistance.scala)."""

    def __init__(self, eps: float = 1e-12, name: Optional[str] = None):
        super().__init__(name)
        self.eps = eps

    def forward(self, x):
        a, b = x
        na = torch.linalg.vector_norm(a, dim=-1).clamp_min(self.eps)
        nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(self.eps)
        return (a * b).sum(-1) / (na * nb)


class PairwiseDistance(SimpleModule):
    """Row-wise Lp distance of a table (a, b) (reference
    nn/PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.norm = norm

    def forward(self, x):
        a, b = x
        d = (a - b).abs()
        if self.norm == 1:
            return d.sum(-1)
        return d.pow(self.norm).sum(-1).pow(1.0 / self.norm)


class LookupTable(nn.Module):
    """Embedding lookup: ``weight`` (n_index, n_output), init N(0, 1),
    0-based indices. ``max_norm`` renormalises the gathered rows at lookup
    time, as the JAX package does (the weight itself is not changed): a
    row whose ``norm_type``-norm exceeds it is scaled down to it. A
    quantized weight (``serving.quant``) gathers its 8-bit rows, then
    scales them. Under tensor parallelism ``_tp`` splits the features:
    each rank gathers its columns and the rows are gathered whole."""

    _tp = None

    def __init__(self, n_index: int, n_output: int,
                 max_norm: Optional[float] = None, norm_type: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.max_norm, self.norm_type = max_norm, norm_type
        self.weight = nn.Parameter(torch.empty(n_index, n_output).normal_(
            generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        take_rows = getattr(self.weight, "take_rows", None)
        rows = take_rows(x) if take_rows is not None else \
            self.weight[x.long()]
        if self._tp is not None:
            rows = self._tp.gather(rows, -1)
        if self.max_norm is not None:
            n = torch.linalg.vector_norm(rows, ord=self.norm_type, dim=-1,
                                         keepdim=True)
            rows = rows * torch.clamp_max(
                self.max_norm / torch.clamp_min(n, 1e-7), 1.0)
        return rows
