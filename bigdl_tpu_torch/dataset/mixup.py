"""Mixup and CutMix batch augmentation (counterpart of
``bigdl_tpu/dataset/mixup.py``; Zhang et al., Yun et al.): each batch is
combined with a shuffled copy of itself, and the loss becomes the same
convex combination of the two labels' losses. Ships as Transformer stages
(composing with ``>>`` like every other stage) plus the paired criterion
wrapper. The draws come from a ``RandomState`` in the JAX package's order,
so both packages mix the same batches the same way.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from bigdl_tpu_torch.core.criterion import Criterion
from bigdl_tpu_torch.dataset.dataset import MiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["Mixup", "CutMix", "MixupCriterion"]


class Mixup(Transformer):
    """MiniBatch -> MiniBatch with ``target = (y_a, y_b, lam)``.

    ``lam ~ Beta(alpha, alpha)`` per batch (one scalar — the standard
    formulation keeps shapes static). Train-time only; feed the
    resulting batches with :class:`MixupCriterion` wrapping the usual
    loss.
    """

    skippable = True

    def __init__(self, alpha: float = 0.2, seed: int = 0):
        if alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {alpha}")
        self.alpha = alpha
        self._rng = np.random.RandomState(seed)

    def skip(self, n_batches: int, batch_shape: tuple) -> None:
        """One ``beta`` and one ``permutation`` of the records a batch."""
        for _ in range(n_batches):
            self._rng.beta(self.alpha, self.alpha)
            self._rng.permutation(batch_shape[0])

    def __call__(self, it: Iterator) -> Iterator:
        for mb in it:
            x, y = np.asarray(mb.input), np.asarray(mb.target)
            lam = float(self._rng.beta(self.alpha, self.alpha))
            perm = self._rng.permutation(len(x))
            x_mixed = (lam * x + (1.0 - lam) * x[perm]).astype(x.dtype)
            yield MiniBatch(x_mixed,
                            (y, y[perm], np.float32(lam)))


class CutMix(Transformer):
    """CutMix (Yun et al.): paste a random rectangle from the permuted
    batch instead of blending — x keeps natural local statistics. Same
    ``(y_a, y_b, lam)`` target convention as :class:`Mixup` (lam = kept
    area fraction), so :class:`MixupCriterion` serves both. Expects NHWC
    image batches."""

    skippable = True

    def __init__(self, alpha: float = 1.0, seed: int = 0):
        if alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {alpha}")
        self.alpha = alpha
        self._rng = np.random.RandomState(seed)

    def skip(self, n_batches: int, batch_shape: tuple) -> None:
        """Mixup's two draws a batch, then the box centre's two
        ``randint`` within the images' height and width (NHWC)."""
        n, h, w = batch_shape[:3]
        for _ in range(n_batches):
            self._rng.beta(self.alpha, self.alpha)
            self._rng.permutation(n)
            self._rng.randint(0, h)
            self._rng.randint(0, w)

    def __call__(self, it: Iterator) -> Iterator:
        for mb in it:
            x, y = np.asarray(mb.input), np.asarray(mb.target)
            n, h, w = x.shape[0], x.shape[1], x.shape[2]
            lam = float(self._rng.beta(self.alpha, self.alpha))
            perm = self._rng.permutation(n)
            # box with area (1-lam), clipped at the borders
            rh = int(round(h * np.sqrt(1.0 - lam)))
            rw = int(round(w * np.sqrt(1.0 - lam)))
            cy = int(self._rng.randint(0, h))
            cx = int(self._rng.randint(0, w))
            y0, y1 = max(0, cy - rh // 2), min(h, cy + rh // 2)
            x0, x1 = max(0, cx - rw // 2), min(w, cx + rw // 2)
            out = x.copy()
            out[:, y0:y1, x0:x1] = x[perm][:, y0:y1, x0:x1]
            # true kept fraction after clipping (the paper's adjustment)
            lam_eff = 1.0 - ((y1 - y0) * (x1 - x0)) / float(h * w)
            yield MiniBatch(out, (y, y[perm], np.float32(lam_eff)))


class MixupCriterion(Criterion):
    """loss = lam * inner(out, y_a) + (1-lam) * inner(out, y_b)."""

    def __init__(self, inner: Criterion):
        super().__init__(size_average=getattr(inner, "size_average", True))
        self.inner = inner

    def forward(self, input, target):
        y_a, y_b, lam = target
        return (lam * self.inner(input, y_a)
                + (1.0 - lam) * self.inner(input, y_b))
