"""Optimization methods (counterpart of ``bigdl_tpu/optim/method.py``).

The JAX package's functional ``init(params) -> state`` /
``update(grads, state, params) -> (params, state)`` is kept, over dicts
of tensors keyed by parameter name; the port updates the parameter
tensors in place (``torch.no_grad``) instead of returning new ones, which
saves a copy of the model per step. The step/epoch counters live in the
state as in the JAX package, as Python numbers."""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

__all__ = ["OptimMethod", "SGD", "Adam"]


class OptimMethod:
    """Base optimizer (reference optim/OptimMethod.scala)."""

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """Update ``params`` in place from ``grads``; returns the new
        state."""
        raise NotImplementedError

    def set_epoch(self, state: dict, epoch: int) -> dict:
        """Record the epoch (the training loop calls this at rollover)."""
        if "epoch" in state:
            state = dict(state, epoch=epoch)
        return state

    def learning_rate(self, state: dict) -> Optional[float]:
        return None


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov in the
    reference's order (optim/SGD.scala): g += wd*w; v = mu*v +
    (1 - damp)*g; step = g + mu*v (nesterov) or v; w -= lr*step.
    BigDL's ``dampening`` defaults to ``momentum`` (torch.optim.SGD's to
    0), and the first step starts from v = 0."""

    def __init__(self, learning_rate: float = 1e-3, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 schedule: Optional[LearningRateSchedule] = None):
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening = 0")
        self.schedule = schedule if schedule is not None else Default(0.0)

    def init(self, params):
        st = {"step": 0, "epoch": 0}
        if self.momentum > 0:
            st["velocity"] = {k: torch.zeros_like(p)
                              for k, p in params.items()}
        return st

    def learning_rate(self, state):
        return self.schedule(self.base_lr, state["step"], state["epoch"])

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.learning_rate(state)
        mu, damp, wd = self.momentum, self.dampening, self.weight_decay
        for name, w in params.items():
            g = grads[name]
            if wd:
                g = g + wd * w
            if mu > 0:
                v = state["velocity"][name]
                v.mul_(mu).add_(g, alpha=1.0 - damp)
                d = g + mu * v if self.nesterov else v
            else:
                d = g
            w.sub_(lr * d)
        return dict(state, step=state["step"] + 1)


class Adam(OptimMethod):
    """Adam with bias correction (the JAX package's ``Adam``): m = b1*m +
    (1 - b1)*g; v = b2*v + (1 - b2)*g^2; w -= lr * (m/bc1) /
    (sqrt(v/bc2) + eps), with ``weight_decay`` added to g first."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        self.base_lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.schedule = schedule if schedule is not None else Default(0.0)

    def init(self, params):
        return {"step": 0, "epoch": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def learning_rate(self, state):
        return self.schedule(self.base_lr, state["step"], state["epoch"])

    @torch.no_grad()
    def update(self, grads, state, params):
        t = state["step"] + 1
        lr = self.learning_rate(state)
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = 1.0 - math.pow(b1, t), 1.0 - math.pow(b2, t)
        for name, w in params.items():
            g = grads[name]
            if self.weight_decay:
                g = g + self.weight_decay * w
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).add_(g * g, alpha=1.0 - b2)
            w.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
        return dict(state, step=t)
