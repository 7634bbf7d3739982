"""Lua-style Table and the plain-text table formatter (counterpart of
``bigdl_tpu/utils/table.py``; reference utils/Table.scala:31-137 and the
``T(...)`` constructor).

:func:`format_table` renders the aligned rows of ``obs.attrib.render``,
``obs.memory.render`` and ``cli.explain``. :class:`Table` is kept for API
parity: code moving over from the reference can write
``T(learningRate=0.1)`` or ``T(tensor_a, tensor_b)`` unchanged."""

from __future__ import annotations

from typing import Any, Iterator, Sequence

__all__ = ["Table", "T", "format_table"]


def format_table(headers: Sequence[str], rows: Sequence[Sequence[Any]],
                 max_col: int = 72) -> str:
    """Plain-text column-aligned table. Cells are str()'d and clipped at
    ``max_col`` characters with an ellipsis, so one long kernel name
    cannot wrap the whole report."""
    def clip(s: Any) -> str:
        s = str(s)
        return s if len(s) <= max_col else s[:max_col - 1] + "…"

    srows = [[clip(c) for c in r] for r in rows]
    heads = [clip(h) for h in headers]
    widths = [max(len(heads[i]), *(len(r[i]) for r in srows))
              if srows else len(heads[i]) for i in range(len(heads))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*heads), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*r) for r in srows]
    return "\n".join(line.rstrip() for line in lines)


class Table:
    """Int- and string-keyed map; integer keys start at 1 (the Lua
    convention of the reference's array part)."""

    def __init__(self, *args: Any, **kwargs: Any):
        self._data: dict[Any, Any] = {}
        for i, v in enumerate(args):
            self._data[i + 1] = v
        self._data.update(kwargs)

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        self._data[k] = v

    def __contains__(self, k):
        return k in self._data

    def __len__(self):
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def get(self, k, default=None):
        return self._data.get(k, default)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def update(self, other) -> "Table":
        self._data.update(dict(other.items()) if isinstance(other, Table)
                          else other)
        return self

    def insert(self, v) -> "Table":
        """Append to the integer array part (reference Table.insert)."""
        self._data[self._array_len() + 1] = v
        return self

    def remove(self) -> Any:
        """Pop the last array element."""
        n = self._array_len()
        if n == 0:
            return None
        return self._data.pop(n)

    def _array_len(self) -> int:
        n = 0
        while (n + 1) in self._data:
            n += 1
        return n

    def to_list(self) -> list:
        return [self._data[i + 1] for i in range(self._array_len())]

    def __eq__(self, other):
        return isinstance(other, Table) and self._data == other._data

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self._data.items())
        return f"T({{{inner}}})"


def T(*args: Any, **kwargs: Any) -> Table:
    """Constructor shorthand (reference ``T(...)``)."""
    return Table(*args, **kwargs)
