"""Structural, shape and table layers (counterpart of
``bigdl_tpu/nn/structural.py``; reference nn/{Concat,Reshape,...}.scala),
and the BN+ReLU rewrite of the fused BN block.

Tables are tuples; dimensions are 0-based, batch first, negative axes
count from the end, and the channel axis of an image is the last (NHWC),
as in the JAX package. Containers name their children ``"0"``, ``"1"``,
... and hand child ``i`` ``fold_seed(seed, i)`` where it draws noise.

Stated differences: ``SpatialZeroPadding`` crops where a pad is negative
(the reference's rule), where the JAX layer's ``jnp.pad`` raises;
``MaskedSelect``'s output shape depends on the mask's values, so it reads
the mask on the host and cannot run inside a CUDA graph (the JAX layer
cannot run under ``jit`` either); ``Echo`` prints its line and the
input's max and mean at every call.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import (Container, ElementwiseModule,
                                         Identity, Sequential, SimpleModule,
                                         _call, fold_seed, hash_bits24,
                                         takes_seed)

__all__ = [
    "absorb_bn_relu", "fold_seed",
    "Concat", "ConcatTable", "ParallelTable", "MapTable", "NarrowTable",
    "FlattenTable", "JoinTable", "MixtureTable", "CriterionTable", "Bottle",
    "Reshape", "View", "Transpose", "Squeeze", "Unsqueeze", "Select",
    "SelectTable", "Narrow", "Index", "MaskedSelect", "MaskedFill",
    "Replicate", "Padding", "SpatialZeroPadding", "Copy", "Contiguous",
    "Echo", "Max", "Min", "Mean", "Sum", "Dropout",
    "CAddTable", "CSubTable", "CMulTable", "CDivTable", "CMaxTable",
    "CMinTable",
]


class Dropout(SimpleModule):
    """Inverted dropout (reference nn/Dropout.scala): at train time each
    element is kept with probability 1 - p and scaled by 1/(1 - p);
    identity at eval. The noise is a counter-based hash of (``seed``,
    element index) (:func:`~bigdl_tpu_torch.core.module.hash_bits24`), so
    the same seed draws the same mask eagerly, in a recomputed (remat)
    layer and in a CUDA-graph replay. Not jax's bits: threefry differs, so
    the two packages agree in distribution only."""

    draws_noise = True

    def __init__(self, p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x, seed=None):
        if not self.training or self.p == 0.0:
            return x
        if seed is None:
            raise ValueError("Dropout needs a seed in training mode")
        keep = 1.0 - self.p
        mask = hash_bits24(seed, x) < int(keep * (1 << 24))
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


# ------------------------------------------------------------ containers
class Concat(Container):
    """Every child on the same input, outputs concatenated along ``axis``
    (default the last, the NHWC channels) (reference nn/Concat.scala)."""

    def __init__(self, *modules: nn.Module, axis: int = -1,
                 name: Optional[str] = None):
        super().__init__(*modules, name=name)
        self.axis = axis

    def forward(self, x, seed=None):
        return torch.cat([_call(m, x, seed, i) for i, m in enumerate(self)],
                         dim=self.axis)


class ConcatTable(Container):
    """Every child on the same input; the tuple of their outputs
    (reference nn/ConcatTable.scala)."""

    def forward(self, x, seed=None):
        return tuple(_call(m, x, seed, i) for i, m in enumerate(self))


class ParallelTable(Container):
    """Child i on table element i (reference nn/ParallelTable.scala)."""

    def forward(self, x, seed=None):
        return tuple(_call(m, x[i], seed, i) for i, m in enumerate(self))


class MapTable(Container):
    """One child applied to every table element with the same parameters
    (reference nn/MapTable.scala, where the clones share weights); element
    i's seed is ``fold_seed(seed, i)``."""

    def __init__(self, module: nn.Module, name: Optional[str] = None):
        super().__init__(module, name=name)

    def forward(self, x, seed=None):
        return tuple(_call(self[0], xi, seed, i) for i, xi in enumerate(x))


class Bottle(Container):
    """The leading axes collapsed into one batch axis, the child applied,
    and the leading axes restored; ``n_input_dims`` counts the non-batch
    axes the child expects (reference nn/Bottle.scala). The child gets the
    seed itself."""

    def __init__(self, module: nn.Module, n_input_dims: int = 2,
                 name: Optional[str] = None):
        super().__init__(module, name=name)
        self.n_input_dims = n_input_dims

    def forward(self, x, seed=None):
        cut = x.dim() - self.n_input_dims + 1
        flat = x.reshape((-1,) + tuple(x.shape[cut:]))
        m = self[0]
        y = (m(flat, seed=seed) if seed is not None and takes_seed(m)
             else m(flat))
        return y.reshape(tuple(x.shape[:cut]) + tuple(y.shape[1:]))


# ---------------------------------------------------------- table layers
class NarrowTable(SimpleModule):
    """``length`` table elements from ``offset`` (reference
    nn/NarrowTable.scala)."""

    def __init__(self, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.offset, self.length = offset, length

    def forward(self, x):
        return tuple(x[self.offset:self.offset + self.length])


class FlattenTable(SimpleModule):
    """Nested tables flattened into one, depth first (reference
    nn/FlattenTable.scala)."""

    def forward(self, x):
        out = []

        def rec(t):
            if isinstance(t, (tuple, list)):
                for e in t:
                    rec(e)
            else:
                out.append(t)

        rec(x)
        return tuple(out)


class JoinTable(SimpleModule):
    """Table elements concatenated along ``axis`` (reference
    nn/JoinTable.scala)."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.cat(list(x), dim=self.axis)


class MixtureTable(SimpleModule):
    """sum_e g_e * x_e of a table (gates (B, E), experts), the experts a
    table of E (B, ...) tensors or one (B, E, ...) tensor (reference
    nn/MixtureTable.scala)."""

    def forward(self, x):
        gates, experts = x
        if isinstance(experts, (tuple, list)):
            experts = torch.stack(list(experts), dim=1)
        g = gates.reshape(tuple(gates.shape)
                          + (1,) * (experts.dim() - gates.dim()))
        return (g * experts).sum(1)


class CriterionTable(SimpleModule):
    """A criterion as a module over a table (input, target) (reference
    nn/CriterionTable.scala)."""

    def __init__(self, criterion, name: Optional[str] = None):
        super().__init__(name)
        self.criterion = criterion

    def forward(self, x):
        inp, tgt = x
        return self.criterion.forward(inp, tgt)


class SelectTable(SimpleModule):
    """Table element ``index`` (reference nn/SelectTable.scala)."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.index = index

    def forward(self, x):
        return x[self.index]


class _CTable(SimpleModule):
    """A table's tensors combined left to right by ``_op``."""

    _op = None

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = self._op(out, t)
        return out


class CAddTable(_CTable):
    """(reference nn/CAddTable.scala)"""
    _op = staticmethod(torch.add)


class CSubTable(_CTable):
    """(reference nn/CSubTable.scala)"""
    _op = staticmethod(torch.sub)


class CMulTable(_CTable):
    """(reference nn/CMulTable.scala)"""
    _op = staticmethod(torch.mul)


class CDivTable(_CTable):
    """(reference nn/CDivTable.scala)"""
    _op = staticmethod(torch.div)


class CMaxTable(_CTable):
    """(reference nn/CMaxTable.scala)"""
    _op = staticmethod(torch.maximum)


class CMinTable(_CTable):
    """(reference nn/CMinTable.scala)"""
    _op = staticmethod(torch.minimum)


# -------------------------------------------------------------- shape ops
class Reshape(SimpleModule):
    """Reshape the non-batch dims to ``size`` (reference nn/Reshape.scala;
    axis 0 is always the batch)."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.size)


class View(Reshape):
    """Reshape under its reference name (nn/View.scala)."""


class Transpose(SimpleModule):
    """The listed axis pairs swapped in order (reference
    nn/Transpose.scala)."""

    def __init__(self, *pairs: tuple, name: Optional[str] = None):
        super().__init__(name)
        self.pairs = pairs

    def forward(self, x):
        for a, b in self.pairs:
            x = x.transpose(a, b)
        return x


class Squeeze(SimpleModule):
    """Size-1 axes removed: ``axis``, or every one (reference
    nn/Squeeze.scala)."""

    def __init__(self, axis: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return x.squeeze() if self.axis is None else x.squeeze(self.axis)


class Unsqueeze(SimpleModule):
    """A size-1 axis inserted at ``axis`` (reference nn/Unsqueeze.scala)."""

    def __init__(self, axis: int, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return x.unsqueeze(self.axis)


class Select(SimpleModule):
    """Index ``index`` of ``axis``, the axis removed (reference
    nn/Select.scala)."""

    def __init__(self, axis: int, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.axis, self.index = axis, index

    def forward(self, x):
        return x.select(self.axis, self.index)


class Narrow(SimpleModule):
    """``length`` entries of ``axis`` from ``offset`` (reference
    nn/Narrow.scala)."""

    def __init__(self, axis: int, offset: int, length: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.axis, self.offset, self.length = axis, offset, length

    def forward(self, x):
        return x.narrow(self.axis, self.offset, self.length)


class Index(SimpleModule):
    """Entries of ``axis`` gathered by an index tensor, over a table (src,
    idx) (reference nn/Index.scala)."""

    def __init__(self, axis: int = 0, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        src, idx = x
        return src.index_select(self.axis, idx.long().reshape(-1)).reshape(
            src.shape[:self.axis % src.dim()] + idx.shape
            + src.shape[self.axis % src.dim() + 1:])


class MaskedSelect(SimpleModule):
    """The 1-D entries of src where mask is true, over a table (src, mask)
    (reference nn/MaskedSelect.scala). Its length depends on the mask:
    keep it off a captured graph (MaskedFill keeps the shape)."""

    def forward(self, x):
        src, mask = x
        return src[mask.bool()]


class MaskedFill(SimpleModule):
    """src where mask is true, ``value`` elsewhere, over a table (src,
    mask)."""

    def __init__(self, value: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def forward(self, x):
        src, mask = x
        return torch.where(mask.bool(), src, torch.full_like(src,
                                                             self.value))


class Replicate(SimpleModule):
    """A new axis at ``axis`` holding ``n_features`` copies (reference
    nn/Replicate.scala)."""

    def __init__(self, n_features: int, axis: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_features, self.axis = n_features, axis

    def forward(self, x):
        return torch.repeat_interleave(x.unsqueeze(self.axis),
                                       self.n_features, dim=self.axis)


class Padding(SimpleModule):
    """Pad ``|pad|`` entries of ``value`` along ``axis``, before it when
    ``pad`` < 0, after it otherwise (reference nn/Padding.scala)."""

    def __init__(self, axis: int, pad: int, value: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.axis, self.pad, self.value = axis, pad, value

    def forward(self, x):
        ax = self.axis % x.dim()
        widths = [0, 0] * (x.dim() - ax)  # F.pad lists the last dim first
        widths[-2:] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, widths, value=self.value)


class SpatialZeroPadding(SimpleModule):
    """Zeros around H and W of (B, H, W, C), in the reference's argument
    order (nn/SpatialZeroPadding.scala); a negative pad crops."""

    def __init__(self, pad_left: int, pad_right: int, pad_top: int,
                 pad_bottom: int, name: Optional[str] = None):
        super().__init__(name)
        self.pads = (pad_left, pad_right, pad_top, pad_bottom)

    def forward(self, x):
        left, right, top, bottom = self.pads
        return F.pad(x, (0, 0, left, right, top, bottom))


class Copy(ElementwiseModule):
    """The input (reference nn/Copy.scala: a copy of its storage)."""

    def _fn(self, x):
        return x


class Contiguous(Copy):
    """The input, contiguous in memory (reference nn/Contiguous.scala)."""

    def _fn(self, x):
        return x.contiguous()


class Echo(SimpleModule):
    """The input, with a line printed at every call: its shape and dtype,
    then its max and mean (reference nn/Echo.scala)."""

    def forward(self, x):
        print(f"[Echo:{self.name}] shape={tuple(x.shape)} dtype={x.dtype}")
        v = x.detach()
        print(f"[Echo:{self.name}] max={float(v.max()):.4g} "
              f"mean={float(v.float().mean()):.4g}")
        return x


class _Reduce(SimpleModule):
    """``_op`` over ``axis`` (default 1), keeping it with ``keepdims``."""

    _op = None

    def __init__(self, axis: int = 1, keepdims: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.axis, self.keepdims = axis, keepdims

    def forward(self, x):
        return self._op(x, dim=self.axis, keepdim=self.keepdims)


class Max(_Reduce):
    """(reference nn/Max.scala)"""
    _op = staticmethod(torch.amax)


class Min(_Reduce):
    """(reference nn/Min.scala)"""
    _op = staticmethod(torch.amin)


class Mean(_Reduce):
    """(reference nn/Mean.scala)"""
    _op = staticmethod(torch.mean)


class Sum(_Reduce):
    """(reference nn/Sum.scala)"""
    _op = staticmethod(torch.sum)
