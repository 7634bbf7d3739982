"""Mixture of Experts (counterpart of ``bigdl_tpu/nn/moe.py``).

``dense=True`` is the reference's ``MixtureTable`` blend: a softmax gate
over every expert, every expert on every token. Sparse mode routes each
token to its top-k experts under a capacity (arrival order by cumsum,
overflow dropped), with one-hot dispatch and combine products: static
shapes, no gather, nothing read back to the host, so a step with an MoE
captures into a CUDA graph.

The experts' parameters are stacked on a leading ``[E, ...]`` axis and
named as the JAX tree (``experts.<child path>``, beside ``gate``); the
experts run as one batched call, ``torch.func.functional_call`` of the
expert under ``torch.vmap``. Each forward's Switch load-balancing loss
(``E * sum_e f_e * P_e``) is a tensor in the forward's autograd graph,
handed to the :func:`collect_aux_losses` context that is open around the
forward (the ``Optimizer`` opens one a step and adds ``aux_loss_weight``
times their sum to the loss), the role of the JAX ``aux_loss`` state
leaf."""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, Optional, Union

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Module, fold_seed, takes_seed

__all__ = ["MoE", "collect_aux_losses"]

_local = threading.local()


@contextlib.contextmanager
def collect_aux_losses():
    """Within this context every :class:`MoE` forward appends its
    auxiliary loss (a 0-d f32 tensor, in the autograd graph) to the
    yielded list."""
    stack = _local.__dict__.setdefault("stack", [])
    bucket: list = []
    stack.append(bucket)
    try:
        yield bucket
    finally:
        stack.pop()


def _emit(aux: torch.Tensor) -> None:
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].append(aux)


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (and no
    host check, unlike ``F.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _stack_experts(experts: list) -> nn.Module:
    """A copy of the expert's module tree whose every parameter is the
    experts' stacked on a leading [E, ...] axis: the parameter names are
    the expert's (the JAX tree's ``experts`` subtree), and a JAX leaf
    converts slice by slice (``jax_stacked``, read by
    ``interop.from_jax``). It is never called itself: the forward calls
    it functionally, one slice an expert."""
    body = copy.deepcopy(experts[0])
    per = [dict(e.named_parameters()) for e in experts]
    for name, _ in experts[0].named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = body.get_submodule(owner) if owner else body
        setattr(mod, leaf, nn.Parameter(
            torch.stack([p[name].detach() for p in per])))
    body.jax_stacked = True
    return body


class MoE(Module):
    """``MoE(expert, num_experts, d_model, top_k)``: route (batch, seq, d)
    or (tokens, d) inputs through ``num_experts`` experts shaped like
    ``expert`` (a stateless module, or a callable returning a fresh one:
    then each expert is its own draw, as each JAX expert gets its own
    key; a module is copied into every expert).

    ``dense=True`` blends every expert's output by the softmax gate.
    Sparse mode keeps each token's ``top_k`` experts, weighted by the raw
    gate probability at top-1 and by the renormalised top-k
    probabilities otherwise; each expert takes at most ``capacity =
    max(1, int(capacity_factor * tokens * top_k / num_experts))`` token
    choices in arrival order, and a dropped choice contributes 0 (the
    enclosing residual passes the token through)."""

    def __init__(self, expert: Union[nn.Module, Callable[[], nn.Module]],
                 num_experts: int, d_model: int, top_k: int = 1,
                 capacity_factor: float = 1.25, dense: bool = False,
                 name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        make = expert if not isinstance(expert, nn.Module) else (
            lambda: copy.deepcopy(expert))
        experts = [make() for _ in range(num_experts)]
        params = {n for n, _ in experts[0].named_parameters()}
        if set(experts[0].state_dict()) - params:
            raise ValueError("MoE experts must be stateless")
        self.num_experts, self.d_model = num_experts, d_model
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.dense = dense
        self.gate = nn.Parameter(torch.randn(d_model, num_experts,
                                             generator=generator) * 0.02)
        self.experts = _stack_experts(experts)
        self._noisy = takes_seed(experts[0])

    def _run_experts(self, xs, seed):
        """The expert on each [E, C, d] slice with its own stacked
        parameters -> [E, C, d']; expert e's noise draws from
        ``fold_seed(seed, e)``."""
        stacked = dict(self.experts.named_parameters())

        def one(p, x, *s):
            return torch.func.functional_call(
                self.experts, p, (x,), {"seed": s[0]} if s else {})

        if self._noisy and seed is not None and self.training:
            seeds = torch.stack([fold_seed(seed, e)
                                 for e in range(self.num_experts)])
            return torch.vmap(one, randomness="same")(stacked, xs, seeds)
        return torch.vmap(one)(stacked, xs)

    def forward(self, x, seed=None):
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])  # [T, d]
        t, e, k = tokens.shape[0], self.num_experts, self.top_k
        logits = tokens @ self.gate.to(tokens.dtype)
        probs = torch.softmax(logits.float(), dim=-1)  # [T, E]
        if self.dense:
            ys = self._run_experts(tokens.expand(e, *tokens.shape), seed)
            out = torch.einsum("te,etd->td", probs.to(ys.dtype), ys)
            _emit(torch.zeros((), device=x.device))
            return out.reshape(*shape[:-1], out.shape[-1])

        cap = max(1, int(self.capacity_factor * t * k / e))
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [T, k]
        if k > 1:
            gate_vals = gate_vals / gate_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)
        # top-1 keeps the raw probability: renormalised it would be 1,
        # and the router would get no gradient from the task loss
        flat = _one_hot(gate_idx, e, torch.int32).reshape(t * k, e)
        pos = torch.cumsum(flat, dim=0) - flat  # arrival order per expert
        pos = (pos * flat).sum(-1).reshape(t, k)
        keep = (pos < cap).to(tokens.dtype)
        # [T, k, E, C]: choice j of token i in slot (its expert, its pos)
        disp_k = (_one_hot(gate_idx, e, tokens.dtype)[..., None]
                  * _one_hot(pos, cap, tokens.dtype)[:, :, None, :]
                  * keep[..., None, None])
        disp = disp_k.sum(1)  # [T, E, C], 0/1
        xs = torch.einsum("tec,td->ecd", disp, tokens)
        ys = self._run_experts(xs, seed)
        combine = (disp_k * gate_vals[..., None, None]).sum(1).to(ys.dtype)
        out = torch.einsum("tec,ecd->td", combine, ys)
        frac_tokens = _one_hot(gate_idx[:, 0], e, torch.float32).mean(0)
        _emit(e * torch.sum(frac_tokens * probs.mean(0)))
        return out.reshape(*shape[:-1], out.shape[-1])

    def place_expert_parallel(self, *args, **kwargs):
        raise NotImplementedError(
            "expert parallelism (MoE.place_expert_parallel) is not in the "
            "PyTorch port yet (ROADMAP.md queue 1 entry 13(b), with "
            "sequence and pipeline parallelism)")
