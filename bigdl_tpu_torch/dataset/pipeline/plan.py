"""Deterministic per-process epoch plans (counterpart of
``bigdl_tpu/dataset/pipeline/plan.py``).

One object answers "which sample indices does THIS process load for step
s of epoch e" for both sharding families:

* ``mode="global"``: every process draws from ONE shared epoch-advanced
  permutation of the global index space and takes its interleaved
  per-step slice (``ShardedDataSet`` semantics: shards stay disjoint and
  exhaustive, the analog of the reference's driver-computed shuffled-index
  RDD, DataSet.scala:252-257);
* ``mode="shard"``: each process owns the contiguous ``host_shard`` slice
  (file-level sharding for data too big to replicate) and permutes within
  it.

The plan is a pure function of ``(seed, epoch)``: the executor's worker
threads can race over its tickets in any order and the assembled batch
stream is still bit-identical, and the Optimizer's resume replay (one
``shuffle()`` per finished epoch) lands back on the same schedule.
``signature()`` is the compact provenance dict that rides in checkpoint
driver blobs. The permutations are the JAX package's, so both packages
see the same batches for the same seed.

Where the JAX package asks ``jax.process_index()/process_count()``, the
port asks ``torch.distributed`` for its rank and world size when a
process group is initialised, and takes 0 and 1 otherwise.

Remainder samples are always dropped: static shapes need full batches,
and equal per-process step counts keep collectives in lockstep.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["EpochPlan", "sample_rng", "process_rank"]

PLAN_MODES = ("global", "shard")


def process_rank() -> tuple:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """Per-(epoch, sample) RNG, independent of which worker thread runs
    the sample — the ticket-seeding idea of the reference's C++ pipeline
    applied per sample (same mix as ``_StreamingImageBase._load_sample``,
    so record streams keep their bit-identity contract)."""
    mix = (seed * 0x9E3779B9 + epoch * 0x85EBCA6B + index) & 0xFFFFFFFF
    return np.random.RandomState(mix)


class EpochPlan:
    """``batch_size`` is the LOCAL (per-host) batch; the logical global
    batch is ``batch_size * process_count``. ``epoch`` advances via
    :meth:`advance` (the DataSet ``shuffle()`` contract — iteration does
    NOT advance it), so kill+resume replays land on the same schedule."""

    def __init__(self, n_samples: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True, mode: str = "global",
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, epoch: int = 0):
        if mode not in PLAN_MODES:
            raise ValueError(f"mode must be one of {PLAN_MODES}, got {mode!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if process_index is None or process_count is None:
            rank, world = process_rank()
            process_index = rank if process_index is None else process_index
            process_count = world if process_count is None else process_count
        self.n = int(n_samples)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.mode = mode
        self.pi = int(process_index)
        self.pc = int(process_count)
        self.epoch = int(epoch)
        self.global_batch = self.batch_size * self.pc

    # ----------------------------------------------------------- schedule
    @property
    def steps(self) -> int:
        """Batches per epoch on THIS host (identical on every host)."""
        if self.mode == "global":
            return self.n // self.global_batch
        return (self.n // self.pc) // self.batch_size

    def order(self, epoch: Optional[int] = None) -> np.ndarray:
        """This host's full sample order for ``epoch`` (before batching).
        ``mode="global"``: the shared permutation — same array on every
        host. ``mode="shard"``: the host_shard slice, locally permuted."""
        e = self.epoch if epoch is None else int(epoch)
        if self.mode == "global":
            if not self.shuffle:
                return np.arange(self.n)
            return np.random.RandomState(
                (self.seed + e) & 0xFFFFFFFF).permutation(self.n)
        per = self.n // self.pc
        base = self.pi * per
        if not self.shuffle:
            return base + np.arange(per)
        return base + np.random.RandomState(
            (self.seed + e) & 0xFFFFFFFF).permutation(per)

    def batch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """``(steps, batch_size)`` int array: row s = the samples this
        host loads for step s. mode="global" takes the per-host
        interleaved slice of each global batch (ShardedDataSet's
        ``order[s*gb + pi*lb : +lb]``); mode="shard" batches the local
        order directly."""
        order = self.order(epoch)
        steps = self.steps
        if steps == 0:
            return np.empty((0, self.batch_size), dtype=order.dtype)
        if self.mode == "global":
            rows = [order[s * self.global_batch + self.pi * self.batch_size:
                          s * self.global_batch
                          + (self.pi + 1) * self.batch_size]
                    for s in range(steps)]
            return np.stack(rows)
        return order[:steps * self.batch_size].reshape(steps,
                                                       self.batch_size)

    # ------------------------------------------------------------ mutation
    def advance(self, seed: Optional[int] = None) -> None:
        """The DataSet ``shuffle()`` contract (ShardedDataSet semantics):
        advance to the next epoch's permutation; an explicit seed also
        rebases the schedule."""
        if seed is not None:
            self.seed = int(seed)
        self.epoch += 1

    # ---------------------------------------------------------- provenance
    def signature(self) -> dict:
        """Compact provenance, stamped into the checkpoint driver blob so
        a resumed run can verify it is replaying the same schedule."""
        return {"n": self.n, "batch": self.batch_size,
                "global_batch": self.global_batch, "seed": self.seed,
                "shuffle": self.shuffle, "mode": self.mode,
                "host": self.pi, "hosts": self.pc, "epoch": self.epoch}
