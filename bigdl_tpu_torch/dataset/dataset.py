"""Host-side batch sources (counterpart of ``bigdl_tpu/dataset/dataset.py``;
reference dataset/DataSet.scala). Batches are numpy arrays; the
Optimizer moves each to its device. ``BatchDataSet`` shuffles with numpy's
``RandomState`` exactly as the JAX package does, so the two packages see
the same batch order for the same seed."""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

__all__ = ["DataSet", "BatchDataSet", "MiniBatch"]


class MiniBatch:
    """(input, target) batch pair (reference dataset/Types.scala)."""

    __slots__ = ("input", "target")

    def __init__(self, input: Any, target: Any):
        self.input = input
        self.target = target

    def __iter__(self):  # tuple-unpacking convenience
        yield self.input
        yield self.target

    @property
    def size(self) -> int:
        return len(self.input)


class DataSet:
    """Base: iterate one epoch of elements; ``size`` = element count."""

    def __iter__(self) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Reshuffle the epoch order (a no-op unless a subclass has one)."""


class BatchDataSet(DataSet):
    """(features, labels) numpy arrays in MiniBatches of ``batch_size``;
    with ``shuffle`` each epoch draws a fresh order from a RandomState
    seeded once with ``seed``. ``drop_remainder`` drops the short tail."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = True):
        if len(features) != len(labels):
            raise ValueError(f"{len(features)} features but {len(labels)} "
                             f"labels")
        self.features, self.labels = features, labels
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder

    def __iter__(self):
        n = len(self.features)
        order = np.arange(n)
        if self._shuffle:
            self._rng.shuffle(order)
        end = (n - self.batch_size + 1) if self.drop_remainder else n
        for i in range(0, max(end, 0), self.batch_size):
            idx = order[i:i + self.batch_size]
            yield MiniBatch(self.features[idx], self.labels[idx])

    def size(self):
        return len(self.features)
