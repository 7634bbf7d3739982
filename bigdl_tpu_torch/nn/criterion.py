"""Losses (counterpart of ``bigdl_tpu/nn/criterion.py``; reference
nn/*Criterion*.scala). Class labels are 0-based integers; a mean is over
the batch unless ``size_average=False``; every clamp and ``eps`` is the
JAX criterion's. ``MultiLabelMarginCriterion`` follows the JAX rule: every
-1 in a target row is padding, wherever it stands (``F.
multilabel_margin_loss`` stops at the first one)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.criterion import Criterion

__all__ = [
    "ClassNLLCriterion", "LabelSmoothingNLLCriterion",
    "MSECriterion", "AbsCriterion", "BCECriterion",
    "CrossEntropyCriterion", "ClassSimplexCriterion", "DistKLDivCriterion",
    "CosineEmbeddingCriterion", "HingeEmbeddingCriterion",
    "L1HingeEmbeddingCriterion", "MarginCriterion", "MarginRankingCriterion",
    "MultiCriterion", "ParallelCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
    "SmoothL1Criterion", "SoftMarginCriterion", "L1Cost", "L1Penalty",
    "TimeDistributedCriterion",
]


def _vec(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-class weights on ``like``'s device and dtype."""
    return torch.as_tensor(w).to(device=like.device, dtype=like.dtype)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of (B, C) log-probabilities at (B,) integer
    labels (reference nn/ClassNLLCriterion.scala), with optional per-class
    ``weights`` (then the mean is weighted: sum(w * nll) / sum(w))."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        t = target.long()
        ll = torch.gather(input, 1, t[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=input.device, dtype=input.dtype)[t]
            loss = -(w * ll)
            if self.size_average:
                return loss.sum() / w.sum().clamp_min(1e-12)
            return loss.sum()
        return self._reduce(-ll)


class LabelSmoothingNLLCriterion(Criterion):
    """NLL of (B, C) log-probabilities against a target of 1 - eps on the
    label and eps spread uniformly over the classes."""

    def __init__(self, smoothing: float = 0.1, size_average: bool = True):
        super().__init__(size_average)
        if not 0.0 <= smoothing < 1.0:
            raise ValueError(f"smoothing {smoothing} not in [0, 1)")
        self.smoothing = smoothing

    def forward(self, input, target):
        ll_true = torch.gather(input, 1, target.long()[:, None])[:, 0]
        eps = self.smoothing
        return self._reduce(-((1.0 - eps) * ll_true
                              + eps * input.mean(-1)))


class MSECriterion(Criterion):
    """(reference nn/MSECriterion.scala)"""

    def forward(self, input, target):
        return self._reduce(torch.square(input - target))


class AbsCriterion(Criterion):
    """(reference nn/AbsCriterion.scala)"""

    def forward(self, input, target):
        return self._reduce(torch.abs(input - target))


class BCECriterion(Criterion):
    """Binary cross entropy of probabilities clamped to [eps, 1 - eps]
    (reference nn/BCECriterion.scala), with optional per-element
    ``weights``."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, eps: float = 1e-12):
        super().__init__(size_average)
        self.weights = weights
        self.eps = eps

    def forward(self, input, target):
        p = torch.clamp(input, self.eps, 1.0 - self.eps)
        per = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
        if self.weights is not None:
            per = per * _vec(self.weights, per)
        return self._reduce(per)


class CrossEntropyCriterion(Criterion):
    """LogSoftMax then ClassNLL over (B, C) logits (reference
    nn/CrossEntropyCriterion.scala)."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        return ClassNLLCriterion(self.weights, self.size_average).forward(
            torch.log_softmax(input, dim=-1), target)


class ClassSimplexCriterion(Criterion):
    """MSE against the label's vertex of a regular simplex of
    ``n_classes`` unit vertices in R^n (reference
    nn/ClassSimplexCriterion.scala; the JAX package's centred basis)."""

    def __init__(self, n_classes: int, size_average: bool = True):
        super().__init__(size_average)
        self.n_classes = n_classes
        v = np.eye(n_classes) - 1.0 / n_classes
        v /= np.linalg.norm(v[0])
        self._simplex = torch.from_numpy(v.astype(np.float32))

    def forward(self, input, target):
        goal = _vec(self._simplex, input)[target.long()]
        return self._reduce(torch.square(input - goal))


class DistKLDivCriterion(Criterion):
    """KL(target || input) with input log-probabilities (reference
    nn/DistKLDivCriterion.scala); the mean is over every element."""

    def forward(self, input, target):
        per = torch.where(target > 0, target * (
            torch.log(target.clamp_min(1e-12)) - input),
            torch.zeros_like(input))
        if self.size_average:
            return per.sum() / input.numel()
        return per.sum()


def _cos_rows(x1, x2):
    return (x1 * x2).sum(-1) / (
        torch.linalg.vector_norm(x1, dim=-1)
        * torch.linalg.vector_norm(x2, dim=-1)).clamp_min(1e-12)


class CosineEmbeddingCriterion(Criterion):
    """1 - cos(x1, x2) where y > 0, else max(0, cos - margin), over a
    table ((x1, x2), y) (reference nn/CosineEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        cos = _cos_rows(*input)
        return self._reduce(torch.where(target > 0, 1.0 - cos,
                                        torch.clamp_min(cos - self.margin,
                                                        0.0)))


class HingeEmbeddingCriterion(Criterion):
    """x where y > 0, else max(0, margin - x) (reference
    nn/HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        return self._reduce(torch.where(
            target > 0, input, torch.clamp_min(self.margin - input, 0.0)))


class L1HingeEmbeddingCriterion(Criterion):
    """Hinge embedding of the L1 distance of a table (x1, x2) (reference
    nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = input
        d = (x1 - x2).abs().sum(-1)
        return self._reduce(torch.where(target > 0, d, torch.clamp_min(
            self.margin - d, 0.0)))


class MarginCriterion(Criterion):
    """max(0, margin - y * x) (reference nn/MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        return self._reduce(torch.clamp_min(self.margin - target * input,
                                            0.0))


class MarginRankingCriterion(Criterion):
    """max(0, -y * (x1 - x2) + margin) over a table (x1, x2) (reference
    nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = input
        return self._reduce(torch.clamp_min(-target * (x1 - x2)
                                            + self.margin, 0.0))


class MultiCriterion(Criterion):
    """The weighted sum of criteria of the same (input, target)
    (reference nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__()
        self._items: list = []

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "MultiCriterion":
        self._items.append((criterion, weight))
        return self

    def forward(self, input, target):
        return sum(w * c.forward(input, target) for c, w in self._items)


class ParallelCriterion(Criterion):
    """The weighted sum of criterion i of (input[i], target[i]), or of
    (input[i], target) with ``repeat_target`` (reference
    nn/ParallelCriterion.scala)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target
        self._items: list = []

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "ParallelCriterion":
        self._items.append((criterion, weight))
        return self

    def forward(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(self._items):
            t = target if self.repeat_target else target[i]
            total = total + w * c.forward(input[i], t)
        return total


class MultiLabelMarginCriterion(Criterion):
    """Multi-label margin loss (reference
    nn/MultiLabelMarginCriterion.scala): each target row lists 0-based
    labels, and every -1 in it is padding; per row, the sum over labels y
    and non-label classes i of max(0, 1 - (x[y] - x[i])), over C."""

    def forward(self, input, target):
        b, c = input.shape
        t = target.long()
        is_label = t >= 0
        t_safe = t.clamp_min(0)
        tgt_scores = torch.gather(input, 1, t_safe)  # (B, L)
        tgt_mask = torch.zeros(b, c, dtype=torch.int64, device=input.device
                               ).scatter_add_(1, t_safe, is_label.long()) > 0
        margins = 1.0 - (tgt_scores[:, :, None] - input[:, None, :])
        valid = is_label[:, :, None] & ~tgt_mask[:, None, :]
        per = torch.where(valid, margins.clamp_min(0.0),
                          torch.zeros_like(margins)).sum((1, 2)) / c
        return self._reduce(per)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid then BCE per class, the mean over classes (reference
    nn/MultiLabelSoftMarginCriterion.scala), with optional per-class
    ``weights``."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        per = -(target * F.logsigmoid(input)
                + (1.0 - target) * F.logsigmoid(-input))
        if self.weights is not None:
            per = per * _vec(self.weights, per)
        return self._reduce(per.mean(-1))


class MultiMarginCriterion(Criterion):
    """Multi-class margin loss, p = 1 or 2, with optional per-class
    ``weights`` (reference nn/MultiMarginCriterion.scala)."""

    def __init__(self, p: int = 1, weights: Optional[torch.Tensor] = None,
                 margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        if p not in (1, 2):
            raise ValueError(f"p must be 1 or 2, got {p}")
        self.p, self.weights, self.margin = p, weights, margin

    def forward(self, input, target):
        b, c = input.shape
        t = target.long()
        x_y = torch.gather(input, 1, t[:, None])
        h = torch.clamp_min(self.margin - (x_y - input), 0.0)
        if self.p == 2:
            h = torch.square(h)
        if self.weights is not None:
            h = h * _vec(self.weights, h)[t][:, None]
        not_y = torch.arange(c, device=input.device)[None, :] != t[:, None]
        per = torch.where(not_y, h, torch.zeros_like(h)).sum(1) / c
        return self._reduce(per)


class SmoothL1Criterion(Criterion):
    """0.5 d^2 where |d| < 1, else |d| - 0.5 (reference
    nn/SmoothL1Criterion.scala)."""

    def forward(self, input, target):
        d = (input - target).abs()
        return self._reduce(torch.where(d < 1.0, 0.5 * torch.square(d),
                                        d - 0.5))


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y * x)) (reference nn/SoftMarginCriterion.scala), as
    a log-add-exp with 0."""

    def forward(self, input, target):
        z = -target * input
        return self._reduce(torch.logaddexp(z, torch.zeros_like(z)))


class L1Cost(Criterion):
    """sum |x| of the input; the target is ignored (reference
    nn/L1Cost.scala)."""

    def forward(self, input, target=None):
        return input.abs().sum()


class L1Penalty(Criterion):
    """l1weight * sum |x|, a term to add through MultiCriterion (reference
    nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float = 1.0):
        super().__init__()
        self.l1weight = l1weight

    def forward(self, input, target=None):
        return self.l1weight * input.abs().sum()


class TimeDistributedCriterion(Criterion):
    """A per-sample criterion over a time dimension: (B, T, ...) input and
    target flatten to (B*T, ...) and go to ``base``."""

    def __init__(self, base: Criterion):
        super().__init__()
        self.base = base

    def forward(self, input, target):
        b, t = input.shape[0], input.shape[1]
        return self.base.forward(input.reshape((b * t,) + input.shape[2:]),
                                 target.reshape((b * t,) + target.shape[2:]))
