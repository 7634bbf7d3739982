"""Carry weights and module state from the JAX package to the port.

A JAX param tree is nested dicts of arrays (``{"encoder": {"0": {"mha":
{"wq": ...}}}}``); the port names each parameter and buffer by the dotted
path (``encoder.0.mha.wq``). Linear and attention weights keep JAX's (in,
out) orientation. A module whose leaves are laid out otherwise converts
its own through a ``from_jax_leaf(key, tensor)`` static method (the
convolution's HWIO kernel becomes torch's (out, in, kh, kw))."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensors_from_jax", "load_jax"]


def params_from_jax(tree, prefix: str = "") -> dict:
    """Flatten a nested dict of arrays (numpy or anything ``np.asarray``
    takes) to ``{dotted.path: torch.Tensor}`` on the CPU. Empty leaves (a
    stateless module's ``()`` in a JAX state tree) are dropped."""
    out = {}
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
    for name, t in tensors.items():
        owner, _, key = name.rpartition(".")
        convert = getattr(owners.get(owner), "from_jax_leaf", None)
        if convert is not None:
            tensors[name] = convert(key, t)
    return tensors


def load_jax(model: torch.nn.Module, params, state=None) -> torch.nn.Module:
    """Load :func:`tensors_from_jax` into ``model`` strictly: every
    parameter and buffer of the model must be in the trees and nothing
    else. Returns the model."""
    model.load_state_dict(tensors_from_jax(model, params, state), strict=True)
    return model
