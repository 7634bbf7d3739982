"""Batch-sharding hints (counterpart of ``bigdl_tpu/parallel/hints.py``).

In the JAX package a strategy sets a hint around the trace of its train
step, and shape-changing modules pin dim 0 of an activation to the data
axis with ``with_sharding_constraint``, so GSPMD keeps the batch layout
through a reshape's backward. The port has no partitioner: each rank
holds its own part of the batch as a plain tensor, and no layout can be
chosen for it. Stated difference: both names are kept and do nothing.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["batch_sharding_hint", "constrain_batch"]


@contextmanager
def batch_sharding_hint(mesh, axis: str):
    """A context in which nothing changes (the JAX one sets the hint)."""
    yield


def constrain_batch(x):
    """``x`` itself: a rank's tensor already is its part of the batch."""
    return x
