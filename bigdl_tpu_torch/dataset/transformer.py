"""Composable data-pipeline stages (counterpart of
``bigdl_tpu/dataset/transformer.py``; reference
dataset/Transformer.scala:39-61).

A Transformer maps an iterator to an iterator; stages compose with ``>>``
(the reference's ``->`` combinator, :44). There is no
cloneTransformer/broadcast machinery: pipelines run per host process.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

__all__ = ["Transformer", "ChainedTransformer", "FnTransformer"]


class Transformer:
    """Iterator -> Iterator stage. Subclasses implement __call__.

    A stage whose random draws depend only on how many batches it sees and
    their shapes sets ``skippable`` and implements :meth:`skip`, so a
    resumed run can replay a finished epoch's draws without its data."""

    skippable = False

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def skip(self, n_batches: int, batch_shape: tuple) -> None:
        """Make the draws ``__call__`` makes over ``n_batches`` batches
        whose inputs have ``batch_shape`` (records first), without the
        data."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot replay its draws without the "
            f"data")

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """Compose: (a >> b)(it) == b(a(it)) (reference Transformer.-> :44)."""
        return ChainedTransformer(self, other)

    def apply(self, data: Iterable) -> Iterator:
        return self(iter(data))


class ChainedTransformer(Transformer):
    """(reference ChainedTransformer :56)"""

    def __init__(self, first: Transformer, last: Transformer):
        self.first, self.last = first, last

    def __call__(self, it: Iterator) -> Iterator:
        return self.last(self.first(it))

    @property
    def skippable(self) -> bool:
        return self.first.skippable and self.last.skippable

    def skip(self, n_batches: int, batch_shape: tuple) -> None:
        self.first.skip(n_batches, batch_shape)
        self.last.skip(n_batches, batch_shape)


class FnTransformer(Transformer):
    """Lift a per-element function into a stage."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, it: Iterator) -> Iterator:
        return (self.fn(x) for x in it)
