"""Finite-difference gradient checking (counterpart of
``bigdl_tpu/utils/gradcheck.py``; reference GradientChecker.scala and
GradientCheckerRNN, at 1e-4 perturbation and 1e-2 tolerance).

Autograd's gradient of a loss over a parameter tree against central
differences of the same loss, on the tree's device: a check that catches a
custom ``torch.autograd.Function`` whose backward is wrong, or a BPTT path
that cuts or leaks gradient where it should not.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bigdl_tpu_torch.core.pytree import flatten_params

__all__ = ["check_gradients", "numerical_grad"]


def numerical_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                   flat: torch.Tensor, eps: float = 1e-4,
                   max_entries: int = 200):
    """Central differences of ``loss_fn`` over a flat vector, perturbed in
    f64 on the host and evaluated in f32 on ``flat``'s device. A vector of
    more than ``max_entries`` coordinates is checked at a deterministic
    subsample of them. Returns (indices, derivatives)."""
    base = flat.detach().double().cpu().numpy()
    n = base.size
    idx = (np.arange(n) if n <= max_entries
           else np.linspace(0, n - 1, max_entries).astype(np.int64))
    out = np.zeros(idx.size)
    for j, i in enumerate(idx):
        d = np.zeros_like(base)
        d[i] = eps
        lo = float(loss_fn(torch.as_tensor(base - d, dtype=torch.float32,
                                           device=flat.device)))
        hi = float(loss_fn(torch.as_tensor(base + d, dtype=torch.float32,
                                           device=flat.device)))
        out[j] = (hi - lo) / (2 * eps)
    return idx, out


def check_gradients(loss_fn: Callable, params, eps: float = 1e-3,
                    rtol: float = 2e-2, atol: float = 5e-3,
                    max_entries: int = 200) -> None:
    """Assert that autograd's gradient of ``loss_fn(params)`` (a scalar
    tensor of a tree of ``params``' structure) matches central
    differences; raises AssertionError where it does not."""
    flat, unflatten = flatten_params(params)

    def flat_loss(v):
        return loss_fn(unflatten(v))

    v = flat.detach().float().requires_grad_(True)
    (g,) = torch.autograd.grad(flat_loss(v), v)
    auto = g.detach().double().cpu().numpy()
    idx, num = numerical_grad(flat_loss, flat, eps, max_entries)
    np.testing.assert_allclose(auto[idx], num, rtol=rtol, atol=atol)
