"""Validation methods and their result monoids (counterpart of
``bigdl_tpu/optim/validation.py``; reference optim/ValidationMethod.scala).
``stats(output, target)`` gives a (value, count) pair for one batch on the
device; results add up across batches on the host."""

from __future__ import annotations

import math

import torch

__all__ = ["ValidationResult", "AccuracyResult", "LossResult",
           "PerplexityResult", "ValidationMethod", "Top1Accuracy",
           "Top5Accuracy", "Loss", "Perplexity"]


class ValidationResult:
    def __add__(self, other):
        raise NotImplementedError

    def result(self) -> tuple:
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    """correct / count, merged by ``+`` (reference AccuracyResult)."""

    def __init__(self, correct: int, count: int):
        self.correct, self.count = int(correct), int(count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def result(self):
        return (self.correct / self.count if self.count else 0.0,
                self.count)

    def __repr__(self):
        return (f"AccuracyResult({self.result()[0]:.4f}, "
                f"{self.correct}/{self.count})")

    def __eq__(self, other):
        return (self.correct, self.count) == (other.correct, other.count)


class LossResult(ValidationResult):
    """Mean loss over the records, merged by ``+``."""

    def __init__(self, loss_sum: float, count: int):
        self.loss_sum, self.count = float(loss_sum), int(count)

    def __add__(self, other):
        return LossResult(self.loss_sum + other.loss_sum,
                          self.count + other.count)

    def result(self):
        return (self.loss_sum / self.count if self.count else 0.0,
                self.count)

    def __repr__(self):
        return f"LossResult({self.result()[0]:.4f}, n={self.count})"


class PerplexityResult(ValidationResult):
    """exp(mean token NLL), merged by ``+``."""

    def __init__(self, nll_sum: float, count: int):
        self.nll_sum, self.count = float(nll_sum), int(count)

    def __add__(self, other):
        return PerplexityResult(self.nll_sum + other.nll_sum,
                                self.count + other.count)

    def result(self):
        ppl = math.exp(self.nll_sum / self.count) if self.count else 0.0
        return ppl, self.count

    def __repr__(self):
        return f"PerplexityResult({self.result()[0]:.3f}, n={self.count})"


class ValidationMethod:
    name = "validation"

    def stats(self, output, target):
        """(value, count) of one batch."""
        raise NotImplementedError

    def to_result(self, value, count) -> ValidationResult:
        raise NotImplementedError


def _total_order(scores):
    """Integers that order floating scores in the IEEE total order (-NaN <
    -inf < ... < -0.0 < +0.0 < ... < +inf < NaN): the bits of each value,
    with the magnitude bits of the negative ones flipped."""
    if not scores.is_floating_point():
        return scores.long()
    if scores.dtype == torch.float64:
        bits, flip = scores.view(torch.int64), 0x7FFFFFFFFFFFFFFF
    else:  # f32, and f16/bf16 widened to f32 exactly
        bits, flip = scores.float().view(torch.int32), 0x7FFFFFFF
    return torch.where(bits < 0, bits ^ flip, bits)


class _TopK(ValidationMethod):
    k = 1

    def stats(self, output, target):
        """Records whose label is among the k highest scores of (B, C)
        ``output``; k = 1 takes the argmax (the first of equal maxima).
        For k > 1, ties are broken as ``jax.lax.top_k`` breaks them: the
        label's score s_t is in the top k iff #(s > s_t) + #(s == s_t at
        a lower index) < k, in the IEEE total order (-0.0 below +0.0,
        NaN above +inf)."""
        t = target.long()
        if self.k == 1:
            correct = (output.argmax(dim=-1) == t).sum()
        else:
            key = _total_order(output)
            c = key.shape[-1]
            valid = (t >= 0) & (t < c)
            ti = t.clamp(0, c - 1)[:, None]
            kt = key.gather(-1, ti)
            lower = torch.arange(c, device=key.device) < ti
            rank = ((key > kt) | ((key == kt) & lower)).sum(-1)
            correct = (valid & (rank < self.k)).sum()
        return correct, output.shape[0]

    def to_result(self, value, count):
        return AccuracyResult(int(value), int(count))


class Top1Accuracy(_TopK):
    """(reference ValidationMethod.Top1Accuracy)"""
    name = "top1 accuracy"
    k = 1


class Top5Accuracy(_TopK):
    """(reference ValidationMethod.Top5Accuracy)"""
    name = "top5 accuracy"
    k = 5


class Loss(ValidationMethod):
    """Mean criterion value over the records (reference
    ValidationMethod.Loss)."""

    name = "loss"

    def __init__(self, criterion):
        self.criterion = criterion

    def stats(self, output, target):
        n = output.shape[0]
        return self.criterion(output, target) * n, n

    def to_result(self, value, count):
        return LossResult(float(value), int(count))


class Perplexity(ValidationMethod):
    """Token perplexity of (B, S, V) log-probs at (B, S) integer targets,
    or at ``(targets, weights)`` from ``models.packed_lm_targets``: tokens
    of weight 0 leave both the sum and the count."""

    name = "perplexity"

    def stats(self, output, target):
        if isinstance(target, (tuple, list)):
            target, weights = target
        else:
            weights = torch.ones(target.shape, dtype=output.dtype,
                                 device=output.device)
        nll = -torch.gather(output, -1, target.long()[..., None])[..., 0]
        w = weights.to(nll.dtype)
        return (nll * w).sum(), w.sum()

    def to_result(self, value, count):
        return PerplexityResult(float(value), int(count))
