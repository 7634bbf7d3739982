"""Optimization methods (counterpart of ``bigdl_tpu/optim/method.py``).

The JAX package's functional ``init(params) -> state`` /
``update(grads, state, params)`` is kept, over dicts of tensors keyed by
parameter name. The port updates in place instead of returning new
trees (``torch.no_grad``): the parameters, every state tensor, and the
``step`` and ``epoch`` counters, which are 0-d f32 tensors on the
parameters' device as in the JAX state. Nothing in an update reads a
value back to the host, so a step captured in a CUDA graph updates the
same tensors on every replay, and a checkpoint writes those tensors.

The state's names and nesting follow the JAX state tree (``{"epoch",
"step", "velocity": {name: tensor}}`` and so on); a dict keyed by
parameter name stands where the JAX state nests the param tree."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

__all__ = ["OptimMethod", "SGD", "Adagrad", "Adam", "AdamW", "EMA", "LAMB",
           "LARS", "RMSprop", "clip_by_global_norm", "clip_by_value"]


def _counters(params: dict) -> dict:
    dev = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), device=dev),
            "epoch": torch.zeros((), device=dev)}


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _norm(t, name=None, sq_norm=None):
    """The L2 norm of ``t``; ``sq_norm(name, t)``, when given, is its square
    (a strategy's: a split leaf's whole square sum)."""
    return torch.sqrt(torch.sum(torch.square(t)) if sq_norm is None
                      else sq_norm(name, t))


class OptimMethod:
    """Base optimizer (reference optim/OptimMethod.scala).
    ``takes_sq_norm``: ``update`` takes per-tensor norms and accepts
    ``sq_norm=`` (the square sum of a parameter or of a tensor shaped like
    it, by name), which a strategy passes when a rank holds a slice."""

    takes_sq_norm = False

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """Update ``params`` and ``state`` in place from ``grads``;
        returns ``state``."""
        raise NotImplementedError

    @torch.no_grad()
    def set_epoch(self, state: dict, epoch: int) -> dict:
        """Write the epoch into ``state`` in place (the training loop calls
        this at rollover); a state without an epoch is left as it is."""
        if "epoch" in state:
            state["epoch"].fill_(float(epoch))
        return state

    def learning_rate(self, state: dict) -> Optional[torch.Tensor]:
        """The rate of the next update (for logging), or None."""
        return None


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov in the
    reference's order (optim/SGD.scala): g += wd*w; v = mu*v +
    (1 - damp)*g; d = g + mu*v (nesterov) or v; w -= lr*plr*d. BigDL's
    ``dampening`` defaults to ``momentum`` (torch.optim.SGD's to 0), and
    the first step starts from v = 0. ``learning_rates`` and
    ``weight_decays`` are per-parameter multipliers and decays,
    ``{name: float or tensor}`` (SGD.scala:43)."""

    def __init__(self, learning_rate: float = 1e-3, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 schedule: Optional[LearningRateSchedule] = None,
                 learning_rates: Optional[dict] = None,
                 weight_decays: Optional[dict] = None):
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening = 0")
        self.schedule = schedule if schedule is not None else Default(0.0)
        self.learning_rates = learning_rates
        self.weight_decays = weight_decays

    def init(self, params):
        st = _counters(params)
        if self.momentum > 0:
            st["velocity"] = _zeros(params)
        return st

    def learning_rate(self, state):
        return self.schedule(self.base_lr, state["step"], state["epoch"])

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.learning_rate(state)
        mu, damp = self.momentum, self.dampening
        for name, w in params.items():
            g = grads[name]
            wd = (self.weight_decays[name] if self.weight_decays is not None
                  else self.weight_decay)
            if isinstance(wd, torch.Tensor) or wd:
                g = g + wd * w
            if mu > 0:
                v = state["velocity"][name]
                v.mul_(mu).add_(g, alpha=1.0 - damp)
                d = g + mu * v if self.nesterov else v
            else:
                d = g
            step = lr if self.learning_rates is None else \
                lr * self.learning_rates[name]
            w.sub_(step * d)
        state["step"].add_(1.0)
        return state


class Adagrad(OptimMethod):
    """Adagrad (reference optim/Adagrad.scala): a += g^2, w -= lr * g /
    (sqrt(a) + eps), lr = base_lr / (1 + step * lr_decay), with
    ``weight_decay`` added to g first."""

    def __init__(self, learning_rate: float = 1e-2, lr_decay: float = 0.0,
                 weight_decay: float = 0.0, eps: float = 1e-10):
        self.base_lr = learning_rate
        self.lr_decay = lr_decay
        self.weight_decay = weight_decay
        self.eps = eps

    def init(self, params):
        return dict(_counters(params), accum=_zeros(params))

    def learning_rate(self, state):
        return self.base_lr / (1.0 + state["step"] * self.lr_decay)

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.learning_rate(state)
        for name, w in params.items():
            g = grads[name] + self.weight_decay * w
            a = state["accum"][name]
            a.add_(torch.square(g))
            w.sub_(lr * g / (torch.sqrt(a) + self.eps))
        state["step"].add_(1.0)
        return state


class Adam(OptimMethod):
    """Adam with bias correction (the JAX package's ``Adam``): m = b1*m +
    (1 - b1)*g; v = b2*v + (1 - b2)*g^2; w -= lr * (m/bc1) /
    (sqrt(v/bc2) + eps), with ``weight_decay`` added to g first. The bias
    corrections bc = 1 - b^t are computed on the device from ``step``."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        self.base_lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.schedule = schedule if schedule is not None else Default(0.0)

    def init(self, params):
        return dict(_counters(params), m=_zeros(params), v=_zeros(params))

    def learning_rate(self, state):
        return self.schedule(self.base_lr, state["step"], state["epoch"])

    def _begin(self, state):
        """(lr, bc1, bc2) of this update, from the state's counters."""
        t = state["step"] + 1.0
        return (self.learning_rate(state), 1.0 - torch.pow(self.beta1, t),
                1.0 - torch.pow(self.beta2, t))

    def _moments(self, g, m, v, bc1, bc2):
        """Advance m and v in place; the bias-corrected direction."""
        b1, b2 = self.beta1, self.beta2
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).add_(torch.square(g), alpha=1.0 - b2)
        return (m / bc1) / (torch.sqrt(v / bc2) + self.eps)

    @torch.no_grad()
    def update(self, grads, state, params):
        lr, *bc = self._begin(state)
        for name, w in params.items():
            g = grads[name]
            if self.weight_decay:
                g = g + self.weight_decay * w
            w.sub_(lr * self._moments(g, state["m"][name], state["v"][name],
                                      *bc))
        state["step"].add_(1.0)
        return state


class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter): w -= lr *
    (update + weight_decay * w), the decay kept out of the moments."""

    @torch.no_grad()
    def update(self, grads, state, params):
        lr, *bc = self._begin(state)
        for name, w in params.items():
            upd = self._moments(grads[name], state["m"][name],
                                state["v"][name], *bc)
            w.sub_(lr * (upd + self.weight_decay * w))
        state["step"].add_(1.0)
        return state


class LAMB(Adam):
    """Layer-wise adaptive large-batch Adam (You et al.): the AdamW
    direction of each parameter is scaled by ||w|| / ||update||; biases and
    norm weights (ndim <= 1) skip the trust ratio and the weight decay."""

    takes_sq_norm = True

    @torch.no_grad()
    def update(self, grads, state, params, sq_norm=None):
        lr, *bc = self._begin(state)
        for name, w in params.items():
            upd = self._moments(grads[name], state["m"][name],
                                state["v"][name], *bc)
            if w.dim() <= 1:
                w.sub_(lr * upd)
                continue
            upd = upd + self.weight_decay * w
            wn, un = _norm(w, name, sq_norm), _norm(upd, name, sq_norm)
            trust = torch.where((wn > 0) & (un > 0), wn / un,
                                torch.ones_like(wn))
            w.sub_(lr * trust * upd)
        state["step"].add_(1.0)
        return state


class RMSprop(OptimMethod):
    """RMSprop: s = d*s + (1 - d)*g^2; w -= base_lr * g / (sqrt(s) + eps)."""

    def __init__(self, learning_rate: float = 1e-2, decay_rate: float = 0.99,
                 eps: float = 1e-8):
        self.base_lr = learning_rate
        self.decay_rate = decay_rate
        self.eps = eps

    def init(self, params):
        return dict(_counters(params), sq=_zeros(params))

    @torch.no_grad()
    def update(self, grads, state, params):
        d = self.decay_rate
        for name, w in params.items():
            g = grads[name]
            s = state["sq"][name]
            s.mul_(d).add_(torch.square(g), alpha=1.0 - d)
            w.sub_(self.base_lr * g / (torch.sqrt(s) + self.eps))
        state["step"].add_(1.0)
        return state


class LARS(OptimMethod):
    """Layer-wise Adaptive Rate Scaling (You et al.): each parameter's step
    is scaled by trust * ||w|| / (||g|| + wd*||w|| + eps), then momentum
    SGD; biases and norm weights (ndim <= 1) take plain momentum SGD
    without decay or adaptation."""

    takes_sq_norm = True

    def __init__(self, learning_rate: float = 1.0, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust: float = 0.001,
                 eps: float = 1e-9,
                 schedule: Optional[LearningRateSchedule] = None):
        self.base_lr = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust = trust
        self.eps = eps
        self.schedule = schedule if schedule is not None else Default(0.0)

    def init(self, params):
        return dict(_counters(params), velocity=_zeros(params))

    def learning_rate(self, state):
        return self.schedule(self.base_lr, state["step"], state["epoch"])

    @torch.no_grad()
    def update(self, grads, state, params, sq_norm=None):
        lr = self.learning_rate(state)
        mu, wd = self.momentum, self.weight_decay
        for name, w in params.items():
            g, v = grads[name], state["velocity"][name]
            if w.dim() <= 1:
                v.mul_(mu).add_(g)
            else:
                wn, gn = _norm(w, name, sq_norm), _norm(g, name, sq_norm)
                local = torch.where(
                    (wn > 0) & (gn > 0),
                    self.trust * wn / (gn + wd * wn + self.eps),
                    torch.ones_like(wn))
                v.mul_(mu).add_(local * (g + wd * w))
            w.sub_(lr * v)
        state["step"].add_(1.0)
        return state


class EMA(OptimMethod):
    """An exponential moving average of the weights around any inner
    method: ema = decay*ema + (1 - decay)*w after each update, seeded from
    the initial weights. Evaluate with :meth:`ema_params`."""

    def __init__(self, inner: OptimMethod, decay: float = 0.999):
        self.inner = inner
        self.decay = decay
        self.schedule = getattr(inner, "schedule", None)
        self.takes_sq_norm = inner.takes_sq_norm

    def init(self, params):
        return {"inner": self.inner.init(params),
                "ema": {k: p.detach().clone() for k, p in params.items()}}

    def learning_rate(self, state):
        return self.inner.learning_rate(state["inner"])

    @torch.no_grad()
    def update(self, grads, state, params, **kw):
        self.inner.update(grads, state["inner"], params, **kw)
        d = self.decay
        for name, w in params.items():
            state["ema"][name].mul_(d).add_(w, alpha=1.0 - d)
        return state

    def ema_params(self, state) -> dict:
        return state["ema"]


def clip_by_global_norm(grads: dict, max_norm: float, sq_norm=None):
    """Scale every gradient so their global L2 norm is at most
    ``max_norm`` (reference Optimizer.setGradientClippingByl2Norm); returns
    (clipped grads, the norm before clipping). The norm is taken in f32;
    ``sq_norm``, when given, is its square (a strategy's, over gradients
    split across ranks)."""
    if sq_norm is None:
        sq_norm = sum(torch.sum(torch.square(g.float()))
                      for g in grads.values())
    norm = torch.sqrt(sq_norm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


def clip_by_value(grads: dict, lo: float, hi: float) -> dict:
    """Clip every gradient element to [lo, hi] (reference
    Optimizer.setConstantGradientClipping)."""
    return {k: torch.clamp(g, lo, hi) for k, g in grads.items()}
