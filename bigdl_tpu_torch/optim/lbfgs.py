"""L-BFGS with a strong-Wolfe line search (counterpart of
``bigdl_tpu/optim/lbfgs.py``; reference optim/LBFGS.scala:26-287,
optim/LineSearch.scala ``lswolfe``).

The optimiser takes a closure ``feval(params) -> (loss, grads)`` over the
full batch and iterates quasi-Newton steps. The two-loop recursion and the
line search are host code over flat f32 vectors that stay on the
parameters' device: the history (s, y) is device tensors, the step size
and the decisions of the search are Python floats, read back once a probe.
It is a library API; the training CLIs do not take it, as in the JAX
package.

API::

    opt = LBFGS(max_iter=100, line_search=True)
    params, losses = opt.optimize(feval, params)

where ``params`` is a tree of tensors (``core.pytree``: a tensor, or a
dict such as ``dict(model.named_parameters())``) and ``feval`` returns the
loss and the gradients as a tree of the same structure.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from bigdl_tpu_torch.core.pytree import flatten_params

__all__ = ["LBFGS", "line_search_wolfe"]


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimiser of the cubic through (x1, f1, g1) and (x2, f2, g2);
    bisection when the cubic has no minimum in the bracket (the fallback
    of the reference's lswolfe)."""
    if bounds is not None:
        lo, hi = bounds
    else:
        lo, hi = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_sq = d1 * d1 - g1 * g2
    if d2_sq >= 0:
        d2 = d2_sq ** 0.5
        if x1 <= x2:
            t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            t = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(t, lo), hi)
    return (lo + hi) / 2.0


def line_search_wolfe(feval_dir: Callable[[float], tuple],
                      t: float, f0: float, g0: float,
                      c1: float = 1e-4, c2: float = 0.9,
                      tol_change: float = 1e-9, max_ls: int = 25):
    """Strong-Wolfe line search along a fixed direction.

    ``feval_dir(t) -> (f(x + t*d), f'(x + t*d)·d)`` as floats. Returns
    ``(t, f_t, n_evals)`` meeting sufficient decrease (c1) and curvature
    (c2), the conditions of the reference's ``lswolfe``."""
    f_t, g_t = feval_dir(t)
    n_evals = 1

    # bracketing
    t_prev, f_prev, g_prev = 0.0, f0, g0
    bracket = None
    done = False
    while n_evals < max_ls:
        if f_t > f0 + c1 * t * g0 or (n_evals > 1 and f_t >= f_prev):
            bracket = (t_prev, f_prev, g_prev, t, f_t, g_t)
            break
        if abs(g_t) <= -c2 * g0:
            done = True
            break
        if g_t >= 0:
            bracket = (t, f_t, g_t, t_prev, f_prev, g_prev)
            break
        # expand
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, g_prev, t, f_t, g_t,
                               bounds=(min_step, max_step))
        t_prev, f_prev, g_prev = tmp, f_t, g_t
        f_t, g_t = feval_dir(t)
        n_evals += 1

    if done or bracket is None:
        return t, f_t, n_evals

    # zoom on the bracket
    t_lo, f_lo, g_lo, t_hi, f_hi, g_hi = bracket
    insuf_progress = False
    satisfied = False
    while n_evals < max_ls:
        if abs(t_hi - t_lo) * abs(g0) < tol_change:
            break
        t = _cubic_interpolate(t_lo, f_lo, g_lo, t_hi, f_hi, g_hi)
        # keep the zoom off the bracket's edges (a 0.1 nudge)
        eps = 0.1 * abs(t_hi - t_lo)
        lo_b, hi_b = min(t_lo, t_hi), max(t_lo, t_hi)
        if min(abs(t - lo_b), abs(hi_b - t)) < eps:
            if insuf_progress or t >= hi_b or t <= lo_b:
                t = hi_b - eps if abs(t - hi_b) < abs(t - lo_b) else lo_b + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False
        f_t, g_t = feval_dir(t)
        n_evals += 1
        if f_t > f0 + c1 * t * g0 or f_t >= f_lo:
            t_hi, f_hi, g_hi = t, f_t, g_t
        else:
            if abs(g_t) <= -c2 * g0:
                satisfied = True
                break
            if g_t * (t_hi - t_lo) >= 0:
                t_hi, f_hi, g_hi = t_lo, f_lo, g_lo
            t_lo, f_lo, g_lo = t, f_t, g_t
    if not satisfied:
        # the zoom ran out without meeting Wolfe: the low end of the
        # bracket, never the last rejected probe
        t, f_t = t_lo, f_lo
    return t, f_t, n_evals


class LBFGS:
    """Limited-memory BFGS (reference optim/LBFGS.scala:26-287).

    The reference's config: ``max_iter`` (maxIter), ``max_eval`` (maxEval,
    default max_iter * 1.25), ``tol_fun``/``tol_x``, ``n_correction`` (the
    history's length), ``learning_rate``, and ``line_search`` (True: strong
    Wolfe, the reference's lswolfe; False: a fixed step, the first
    iteration's scaled by 1/||g||_1)."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[int] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = True):
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else int(
            max_iter * 1.25)
        self.tol_fun = tol_fun
        self.tol_x = tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    def optimize(self, feval: Callable[[Any], tuple], params):
        """Up to ``max_iter`` iterations from ``params``. Returns (params,
        losses): the last iterate as a tree of ``params``' structure, and
        the loss at the start and after each iteration."""
        x, unflatten = flatten_params(params)
        x = x.float()

        def feval_flat(xf):
            loss, grads = feval(unflatten(xf))
            gf, _ = flatten_params(grads)
            return torch.as_tensor(loss).detach().float(), gf.float()

        f, g = feval_flat(x)
        losses = [float(f)]
        n_eval = 1
        if float(g.abs().max()) <= 1e-10:  # already at a critical point
            return unflatten(x), losses

        s_hist: list = []
        y_hist: list = []
        rho_hist: list = []
        g_prev = None
        t = self.learning_rate
        h_diag = 1.0

        for it in range(self.max_iter):
            # the direction, by the two-loop recursion
            if g_prev is None:
                d = -g
            else:
                y = g - g_prev
                s = t * d
                ys = float(torch.dot(y, s))
                if ys > 1e-10:  # the curvature condition (history gate)
                    if len(s_hist) == self.n_correction:
                        s_hist.pop(0), y_hist.pop(0), rho_hist.pop(0)
                    s_hist.append(s)
                    y_hist.append(y)
                    rho_hist.append(1.0 / ys)
                    h_diag = ys / float(torch.dot(y, y))
                # a_i and b_i stay 0-d device tensors: the direction is
                # computed without reading anything back
                q = -g
                alphas = []
                for s_i, y_i, rho_i in zip(reversed(s_hist), reversed(y_hist),
                                           reversed(rho_hist)):
                    a_i = rho_i * torch.dot(s_i, q)
                    alphas.append(a_i)
                    q = q - a_i * y_i
                r = q * h_diag
                for (s_i, y_i, rho_i), a_i in zip(
                        zip(s_hist, y_hist, rho_hist), reversed(alphas)):
                    b_i = rho_i * torch.dot(y_i, r)
                    r = r + (a_i - b_i) * s_i
                d = r
            g_prev = g

            gtd = float(torch.dot(g, d))
            if gtd > -self.tol_x:  # not a descent direction
                break

            # the step size
            if it == 0:
                t = min(1.0, 1.0 / float(g.abs().sum())) * self.learning_rate
            else:
                t = self.learning_rate

            if self.line_search:
                probe: dict = {}

                def feval_dir(tt):
                    f_n, g_n = feval_flat(x + tt * d)
                    probe["t"], probe["f"], probe["g"] = tt, f_n, g_n
                    return float(f_n), float(torch.dot(g_n, d))

                t, _, ls_evals = line_search_wolfe(
                    feval_dir, t, float(f), gtd)
                n_eval += ls_evals
                x = x + t * d
                if probe.get("t") == t:  # the accepted probe, reused
                    f_new, g_new = probe["f"], probe["g"]
                else:
                    f_new, g_new = feval_flat(x)
                    n_eval += 1
            else:
                x = x + t * d
                f_new, g_new = feval_flat(x)
                n_eval += 1

            # the stops (LBFGS.scala tolFun, tolX, maxEval)
            losses.append(float(f_new))
            d_f = abs(float(f_new) - float(f))
            f, g = f_new, g_new
            if float(g.abs().max()) <= 1e-10:
                break
            if d_f < self.tol_fun:
                break
            if float((t * d).abs().max()) <= self.tol_x:
                break
            if n_eval >= self.max_eval:
                break

        return unflatten(x), losses
