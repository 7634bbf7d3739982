"""Carry weights and module state from the JAX package to the port.

A JAX param tree is nested dicts of arrays (``{"encoder": {"0": {"mha":
{"wq": ...}}}}``); the port names each parameter and buffer by the dotted
path (``encoder.0.mha.wq``). Linear and attention weights keep JAX's (in,
out) orientation. A module whose leaves are laid out otherwise converts
its own through a ``from_jax_leaf(key, tensor)`` static method (the
convolution's HWIO kernel becomes torch's (out, in, kh, kw)). Under a
module marked ``jax_stacked`` (an MoE's experts, stacked on a leading
[E, ...] axis; a ``parallel.PipelineStack``'s blocks, [L, ...]) the method
converts each expert's slice. A stacked module placed over a mesh axis
(``MoE.place_expert_parallel``, ``parallel.place_pipeline_params``) holds
the slices ``stage`` = (lo, hi) of each stacked leaf: a whole JAX leaf
is cut to them."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensors_from_jax", "load_jax"]


def params_from_jax(tree, prefix: str = "") -> dict:
    """Flatten a nested dict of arrays (numpy or anything ``np.asarray``
    takes) to ``{dotted.path: torch.Tensor}`` on the CPU. Empty leaves (a
    stateless module's ``()`` in a JAX state tree, or the whole state tree
    of a stateless module) are dropped."""
    out = {}
    if isinstance(tree, tuple) and not tree:
        return out
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(params_from_jax(val, name + "."))
        elif not (isinstance(val, tuple) and not val):
            out[name] = torch.from_numpy(np.array(val))
    return out


def tensors_from_jax(model: torch.nn.Module, params, state=None) -> dict:
    """``{name: tensor}`` of a JAX param tree, and of its module state tree
    (BN running statistics) when given, in ``model``'s names and layouts:
    each module converts its own leaves."""
    tensors = params_from_jax(params)
    if state is not None:
        tensors.update(params_from_jax(state))
    owners = dict(model.named_modules())
    stacked = [n for n, m in owners.items() if getattr(m, "jax_stacked",
                                                      False)]
    for name, t in tensors.items():
        owner, _, key = name.rpartition(".")
        root = next((n for n in stacked if not n or owner == n
                     or owner.startswith(n + ".")), None)
        if root is not None:
            lo, hi = getattr(owners[root], "stage", (0, len(t)))
            if len(t) != hi - lo:  # a whole leaf of a placed stack
                t = tensors[name] = t[lo:hi]
        convert = getattr(owners.get(owner), "from_jax_leaf", None)
        if convert is None:
            continue
        if root is not None:
            tensors[name] = torch.stack([convert(key, x) for x in t])
        else:
            tensors[name] = convert(key, t)
    return tensors


def load_jax(model: torch.nn.Module, params, state=None) -> torch.nn.Module:
    """Load :func:`tensors_from_jax` into ``model`` strictly: every
    parameter and buffer of the model must be in the trees and nothing
    else. Returns the model."""
    model.load_state_dict(tensors_from_jax(model, params, state), strict=True)
    return model
