"""Host-side batch sources (counterpart of ``bigdl_tpu/dataset/dataset.py``;
reference dataset/DataSet.scala). Batches are numpy arrays; the
Optimizer moves each to its device. ``BatchDataSet`` shuffles with numpy's
``RandomState`` exactly as the JAX package does, so the two packages see
the same batch order for the same seed."""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["DataSet", "TransformedDataSet", "LocalArrayDataSet",
           "BatchDataSet", "MiniBatch"]


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

    def skip_epoch(self) -> None:
        """Replay a finished epoch's effect on the order, as a resumed
        training loop does for each epoch the stopped run finished: the
        start of an iteration (where the order is drawn), then
        ``shuffle()``. Datasets whose order is a pure function of the
        epoch count advance it without iterating."""
        next(iter(self), None)
        self.shuffle()

    def transform(self, t: Transformer) -> "TransformedDataSet":
        """This dataset's elements through ``t`` (reference
        AbstractDataSet.transform)."""
        return TransformedDataSet(self, t)

    def __rshift__(self, t: Transformer) -> "TransformedDataSet":
        return self.transform(t)


class TransformedDataSet(DataSet):
    def __init__(self, base: DataSet, t: Transformer):
        self.base, self.t = base, t

    def __iter__(self):
        return self.t(iter(self.base))

    def size(self):
        return self.base.size()

    def shuffle(self, seed=None):
        self.base.shuffle(seed)

    def skip_epoch(self) -> None:
        """Replay a finished epoch: the base's order, and the draws its
        stages made once a batch (Mixup, CutMix), so a resumed run mixes
        the batches the stopped run would have. Without the data where the
        base knows its batches' shapes and every stage can replay its
        draws (:meth:`Transformer.skip`); otherwise by running the epoch's
        host side once, then ``shuffle()``."""
        shapes = getattr(self.base, "epoch_batch_shapes", None)
        if shapes is None or not self.t.skippable:
            for _ in self:
                pass
            self.shuffle()
            return
        self.base.skip_epoch()
        for shape in shapes():
            self.t.skip(1, shape)


class LocalArrayDataSet(DataSet):
    """In-memory samples; with ``shuffle`` each iteration draws a fresh
    order from a RandomState seeded once with ``seed`` (reference
    DataSet.scala:111-157)."""

    def __init__(self, data: Sequence, shuffle: bool = False, seed: int = 0):
        self.data = list(data)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(self.data))

    def __iter__(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        return (self.data[i] for i in self._order)

    def size(self):
        return len(self.data)

    def shuffle(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._rng.shuffle(self._order)


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

    def epoch_batch_shapes(self) -> list:
        """The input shapes of an epoch's batches, in order."""
        n, bs = len(self.features), self.batch_size
        end = (n - bs + 1) if self.drop_remainder else n
        return [(min(bs, n - i),) + self.features.shape[1:]
                for i in range(0, max(end, 0), bs)]
