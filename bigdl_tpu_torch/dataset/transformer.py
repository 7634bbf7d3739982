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
    """Iterator -> Iterator stage. Subclasses implement __call__."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

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


class FnTransformer(Transformer):
    """Lift a per-element function into a stage."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, it: Iterator) -> Iterator:
        return (self.fn(x) for x in it)
