"""Model summary: the layer tree with parameter counts and sizes
(counterpart of ``bigdl_tpu/utils/summary.py``; the reference prints
module graphs through Module.toString trees, nn/Container.scala).

The port's modules hold their parameters, so :func:`summary` takes the
module alone; the JAX call's ``params`` argument is accepted and ignored.
The printed tree is the JAX one, line for line, for the same model. The
module imports no torch itself (``utils`` imports it eagerly, and the
fleet router reaches ``utils.table``)."""

from __future__ import annotations

__all__ = ["param_count", "param_bytes", "summary"]


def _tensors(params) -> list:
    if hasattr(params, "named_parameters"):  # a torch.nn.Module
        return list(params.parameters())
    if isinstance(params, dict):
        out = []
        for v in params.values():
            out += _tensors(v) if isinstance(v, dict) else [v]
        return out
    return list(params)


def param_count(params) -> int:
    """Elements of a module's parameters (or of a dict or iterable of
    tensors)."""
    return sum(int(t.numel()) for t in _tensors(params))


def param_bytes(params) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tensors(params))


def _fmt(n: float) -> str:
    for unit in ("", "K", "M", "B"):
        if abs(n) < 1000 or unit == "B":
            return f"{n:.1f}{unit}" if unit else f"{int(n)}"
        n /= 1000.0
    return f"{n:.1f}B"


def summary(module, params=None) -> str:
    """Render an indented layer tree with per-subtree parameter counts
    (each module's own parameters and its children's), and the total
    line. ``params`` is ignored (the JAX call shape)."""
    lines = []

    def walk(mod, indent):
        kind = type(mod).__name__
        lines.append(f"{'  ' * indent}{getattr(mod, 'name', kind)} "
                     f"[{kind}] params={_fmt(param_count(mod))}")
        for c in mod.children():
            walk(c, indent + 1)

    walk(module, 0)
    mb = param_bytes(module) / 1e6
    lines.append(f"total params: {_fmt(param_count(module))} ({mb:.1f} MB)")
    return "\n".join(lines)
