"""The training loop (counterpart of ``bigdl_tpu/optim/optimizer.py``;
reference optim/Optimizer.scala, LocalOptimizer.scala), single device.

``Optimizer(model, dataset, criterion)``, the setters, then
``optimize()``. Each step computes the loss and its gradients with
autograd (over ``accum_steps`` microbatches when > 1), clips them when
asked, and hands them to the ``OptimMethod``, which updates the
parameters in place. The reference's log lines are kept word for word:
``Train N in Xs. Throughput is R records/second. Loss is L``, the epoch
line, and ``Training finished after N iterations in Xs``.

Dropout noise comes from a generator seeded with ``seed``: each step
draws a step seed from it, and a model whose ``forward`` takes ``seed``
gets it (microbatch i of a step gets ``fold_seed(step seed, i)``).
"""

from __future__ import annotations

import inspect
import logging
import math
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device
from bigdl_tpu_torch.nn.structural import fold_seed
from bigdl_tpu_torch.optim.method import SGD, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.triggers import Trigger

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["Optimizer", "TrainedModel"]


def _later(what: str, where: str):
    return NotImplementedError(f"{what} is not in the PyTorch port yet: it "
                               f"comes with {where} (ROADMAP.md queue 1)")


class TrainedModel:
    """What ``optimize()`` returns: the trained module (its parameters
    are the trained ones)."""

    def __init__(self, module: torch.nn.Module):
        self.module = module

    @property
    def params(self) -> dict:
        return {k: v.detach() for k, v in self.module.state_dict().items()}


def _to_device(y, device):
    if isinstance(y, (tuple, list)):
        return type(y)(_to_device(t, device) for t in y)
    if isinstance(y, np.ndarray):
        y = torch.from_numpy(y)
    return y.to(device, non_blocking=True)


def _split(y, accum: int):
    """Microbatches along dim 0 of a tensor or a tuple of tensors."""
    if isinstance(y, (tuple, list)):
        parts = [_split(t, accum) for t in y]
        return [type(y)(p[i] for p in parts) for i in range(accum)]
    return list(torch.chunk(y, accum, dim=0))


class Optimizer:
    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 optim_method: Optional[OptimMethod] = None,
                 end_when: Optional[Trigger] = None, strategy=None,
                 seed: int = 42, log_every: int = 1, accum_steps: int = 1,
                 steps_per_dispatch: int = 1, device=None):
        if strategy is not None:
            raise _later("a distributed strategy", "data parallelism "
                         "(item 8)")
        if int(steps_per_dispatch) != 1:
            raise _later("steps_per_dispatch > 1", "CUDA graphs of the "
                         "train step (item 15)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method = optim_method or SGD(learning_rate=1e-2)
        self.end_when = end_when or Trigger.max_epoch(1)
        self.seed = seed
        self.accum_steps = accum_steps
        self.log_every = max(1, log_every)
        self.metrics = Metrics()
        self._clip_norm = None
        self._clip_const = None
        self._init_params = None
        self._phase_totals: dict = {}

    # ------------------------------------------------------------- setters
    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_validation(self, trigger, dataset, methods) -> "Optimizer":
        raise _later("set_validation", "validation (item 6)")

    def set_checkpoint(self, trigger, path, **kw) -> "Optimizer":
        raise _later("set_checkpoint", "checkpoints (item 6)")

    def resume(self, checkpoint_dir: str) -> "Optimizer":
        raise _later("resume", "checkpoints (item 6)")

    def set_gradient_clipping_by_l2_norm(self, max_norm: float
                                         ) -> "Optimizer":
        """Scale the gradients so their global L2 norm is <= max_norm."""
        self._clip_norm = float(max_norm)
        return self

    def set_constant_gradient_clipping(self, lo: float, hi: float
                                       ) -> "Optimizer":
        """Clip every gradient element to [lo, hi]."""
        self._clip_const = (float(lo), float(hi))
        return self

    def set_state(self, params=None) -> "Optimizer":
        """Warm-start: ``params`` is a ``{name: tensor or array}`` dict (a
        state dict, or a JAX param tree already flattened with
        ``interop.params_from_jax``), loaded strictly by name. Optimizer
        state comes with checkpoints (ROADMAP.md queue 1 item 6)."""
        self._init_params = params
        return self

    # ---------------------------------------------------------------- step
    def _loss(self, x, y, seed, takes_seed):
        out = self.model(x, seed=seed) if takes_seed else self.model(x)
        return self.criterion(out, y)

    def _step(self, params, opt_state, x, y, seed, takes_seed):
        accum = max(1, self.accum_steps)
        for p in params.values():
            p.grad = None
        if accum == 1:
            loss = self._loss(x, y, seed, takes_seed)
            loss.backward()
        else:
            if x.shape[0] % accum:
                raise ValueError(f"batch size {x.shape[0]} not divisible by "
                                 f"accum_steps={accum}")
            loss = torch.zeros((), device=self.device)
            for i, (xb, yb) in enumerate(zip(_split(x, accum),
                                             _split(y, accum))):
                mb = self._loss(xb, yb, fold_seed(seed, i), takes_seed)
                mb.backward()
                loss = loss + mb.detach()
            loss = loss / accum
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g / accum if accum > 1 else g
        if self._clip_const is not None:
            grads = {k: g.clamp(*self._clip_const) for k, g in grads.items()}
        if self._clip_norm is not None:
            norm = torch.sqrt(sum(g.float().square().sum()
                                  for g in grads.values()))
            scale = torch.clamp(self._clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            grads = {k: (g * scale).to(g.dtype) for k, g in grads.items()}
        opt_state = self.optim_method.update(grads, opt_state, params)
        for p in params.values():
            p.grad = None
        return opt_state, loss.detach()

    def _phase(self, name: str, dt: float):
        """Host seconds per phase: ``data_wait`` (fetching the batch) and
        ``dispatch`` (the step, up to the log point's sync)."""
        self._phase_totals[name] = self._phase_totals.get(name, 0.0) + dt

    # ------------------------------------------------------------ optimize
    def optimize(self) -> TrainedModel:
        model = self.model
        if self._init_params is not None:
            state = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v) for k, v in self._init_params.items()}
            model.load_state_dict(state, strict=True)
        params = dict(model.named_parameters())
        opt_state = self.optim_method.init(params)
        takes_seed = "seed" in inspect.signature(model.forward).parameters
        seeds = torch.Generator().manual_seed(self.seed)
        model.train()

        progress = {"epoch": 1, "iteration": 0, "prev_iteration": 0,
                  "epoch_finished": False, "loss": float("inf")}
        wall_start = time.time()
        last_log_t, fetch_accum = time.time(), 0.0
        while not self.end_when(progress):
            progress["epoch_finished"] = False
            epoch_start = time.time()
            snap = dict(self._phase_totals)
            records = 0
            opt_state = self.optim_method.set_epoch(opt_state,
                                                    progress["epoch"])
            data = iter(self.dataset)
            while True:
                t_fetch = time.time()
                batch = next(data, None)
                dt_fetch = time.time() - t_fetch
                fetch_accum += dt_fetch
                self._phase("data_wait", dt_fetch)
                if batch is None:
                    break
                x, y = batch
                t0 = time.time()
                x, y = _to_device(x, self.device), _to_device(y, self.device)
                step_seed = int(torch.randint(0, 2 ** 62, (1,),
                                              generator=seeds))
                opt_state, loss = self._step(params, opt_state, x, y,
                                             step_seed, takes_seed)
                prev = progress["iteration"]
                progress["prev_iteration"] = prev
                progress["iteration"] = prev + 1
                progress["loss"] = loss
                n_rec = len(x)
                records += n_rec
                if progress["iteration"] // self.log_every != \
                        prev // self.log_every:
                    loss_f = float(loss)  # syncs: the step has finished
                    progress["loss"] = loss_f
                    if not math.isfinite(loss_f):
                        raise FloatingPointError(
                            f"loss became {loss_f} at iteration "
                            f"{progress['iteration']} (epoch "
                            f"{progress['epoch']}) — NaN guard tripped")
                    now = time.time()
                    dt = now - t0
                    self._phase("dispatch", dt)
                    self.metrics.add("get batch time", fetch_accum)
                    self.metrics.add("computing time",
                                     (now - last_log_t) - fetch_accum)
                    last_log_t, fetch_accum = now, 0.0
                    logger.info(
                        "Train %d in %.4fs. Throughput is %.1f "
                        "records/second. Loss is %.4f",
                        n_rec, dt, n_rec / max(dt, 1e-9), loss_f)
                    if logger.isEnabledFor(logging.DEBUG):
                        logger.debug("%s", self.metrics.summary())
                else:
                    self._phase("dispatch", time.time() - t0)
                if self.end_when(progress):
                    break
            progress["epoch"] += 1
            progress["epoch_finished"] = True
            self.dataset.shuffle()
            dt_e = time.time() - epoch_start
            d_wait = (self._phase_totals.get("data_wait", 0.0)
                      - snap.get("data_wait", 0.0))
            d_disp = (self._phase_totals.get("dispatch", 0.0)
                      - snap.get("dispatch", 0.0))
            logger.info(
                "Epoch %d done: %d records in %.2fs (%.1f rec/s; "
                "data_wait %.2fs, dispatch %.2fs, feed stall %.1f%%)",
                progress["epoch"] - 1, records, dt_e,
                records / max(dt_e, 1e-9), d_wait, d_disp,
                100.0 * d_wait / max(dt_e, 1e-9))
        logger.info("Training finished after %d iterations in %.1fs",
                    progress["iteration"], time.time() - wall_start)
        model.eval()
        return TrainedModel(model)
