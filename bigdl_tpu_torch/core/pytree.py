"""Parameter-tree utilities (counterpart of ``bigdl_tpu/core/pytree.py``).

The reference compacts every parameter into one storage
(nn/Module.scala:42-91, ``Module.flatten``); the JAX package views the
model as one flat vector with ``ravel_pytree``. Here a tree is a tensor,
a dict of trees (``{name: tensor}``, as ``dict(model.named_parameters())``
gives, or nested dicts as a JAX param tree carried across), a list or
tuple of trees, or None. Leaves are taken in ``jax.tree_util``'s order:
dict keys sorted, sequences in order, so a tree carried from the JAX
package flattens to the JAX vector element for element.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

__all__ = [
    "flatten_params",
    "tree_leaves",
    "tree_map",
    "tree_zeros_like",
    "tree_add",
    "tree_scale",
    "tree_size",
    "tree_global_norm",
    "tree_cast",
]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util`` order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure (dicts in their own key order) over the next
    tensors of the iterator ``leaves``, taken in tree_leaves order."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    return type(tree)(_rebuild(t, leaves) for t in tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [tree_leaves(r) for r in rest]
    mapped = [fn(*ls) for ls in zip(tree_leaves(tree), *others)]
    return _rebuild(tree, iter(mapped))


def flatten_params(params: Any):
    """``(flat, unflatten)``: the leaves raveled into one 1-D tensor of
    their promoted dtype, and the function that maps such a vector back to
    a tree of ``params``' structure, shapes and dtypes (its leaves are
    views of the vector where the dtype is kept, so gradients flow back to
    it). The analog of ``Module.getParameters`` (AbstractModule.scala:
    199-202)."""
    leaves = tree_leaves(params)
    if not leaves:
        flat = torch.zeros(0)
    else:
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        flat = torch.cat([leaf.detach().reshape(-1).to(dtype)
                          for leaf in leaves])
    specs = [(leaf.shape, leaf.dtype, leaf.numel()) for leaf in leaves]

    def unflatten(vec: torch.Tensor) -> Any:
        out, off = [], 0
        for shape, dtype, n in specs:
            out.append(vec[off:off + n].view(shape).to(dtype))
            off += n
        return _rebuild(params, iter(out))

    return flat, unflatten


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_size(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def tree_cast(tree: Any, dtype) -> Any:
    return tree_map(lambda x: x.to(dtype), tree)
