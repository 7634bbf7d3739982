"""Multi-process data sharding (counterpart of
``bigdl_tpu/dataset/distributed.py``; replaces the reference's
DistributedDataSet / CachedDistriDataSet, dataset/DataSet.scala:164-260).

Each process owns 1/P of every global batch. Where the JAX package asks
``jax.process_index()/process_count()``, the port asks
``torch.distributed`` for its rank and world size when a process group is
initialised, and takes 0 and 1 otherwise; a single process is "shard 0
of 1".
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.dataset.pipeline.plan import process_rank

__all__ = ["ShardedDataSet", "host_shard"]


def host_shard(n: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """This host's contiguous slice of an n-element dataset (equal shards,
    remainder dropped so every host steps the same number of batches —
    collectives need lockstep iteration counts). Feed the slice to a
    per-host pipeline (e.g. ``LocalArrayDataSet``) — not to
    :class:`ShardedDataSet`, which expects the full global arrays."""
    rank, world = process_rank()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    per = n // pc
    return slice(pi * per, (pi + 1) * per)


class ShardedDataSet(DataSet):
    """Every host holds the **full global arrays**; each yields its own
    host-local part of every global batch.

    ``global_batch_size`` is the logical batch across all hosts; each host
    yields ``global_batch_size // process_count`` samples per step, selected
    from a *shared* epoch-advanced permutation of the global index space so
    shards stay disjoint and exhaustive (the analog of the reference's
    driver-computed shuffled-index RDD, DataSet.scala:252-257).

    Do NOT pass a :func:`host_shard` slice here — indexing is global. When a
    host can only hold 1/P of the data (ImageNet-scale), use
    :func:`host_shard` to select files and feed a per-host pipeline
    (``ImageFolderDataSet``/``LocalArrayDataSet``) instead.
    """

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 global_batch_size: int, shuffle: bool = False, seed: int = 0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        rank, world = process_rank()
        self.features, self.labels = features, labels
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        if global_batch_size % self.pc:
            raise ValueError(f"global batch {global_batch_size} not "
                             f"divisible by {self.pc} processes")
        self.global_batch_size = global_batch_size
        self.local_batch = global_batch_size // self.pc
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[MiniBatch]:
        n = len(self.features)
        if self._shuffle:
            # same permutation on every host: seed is shared, epoch-advanced
            order = np.random.RandomState(
                self._seed + self._epoch).permutation(n)
        else:
            order = np.arange(n)
        steps = n // self.global_batch_size
        for s in range(steps):
            base = s * self.global_batch_size + self.pi * self.local_batch
            idx = order[base:base + self.local_batch]
            yield MiniBatch(self.features[idx], self.labels[idx])

    def size(self) -> int:
        return len(self.features)

    def shuffle(self, seed=None):
        if seed is not None:
            self._seed = seed
        self._epoch += 1
