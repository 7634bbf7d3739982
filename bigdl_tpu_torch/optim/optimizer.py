"""The training loop (counterpart of ``bigdl_tpu/optim/optimizer.py``;
reference optim/Optimizer.scala, LocalOptimizer.scala), single device.

``Optimizer(model, dataset, criterion)``, the setters, then
``optimize()``. Each step computes the loss and its gradients with
autograd (over ``accum_steps`` microbatches when > 1), clips them when
asked, and hands them to the ``OptimMethod``, which updates the
parameters and its state in place. The reference's log lines are kept
word for word: ``Train N in Xs. Throughput is R records/second. Loss is
L``, the epoch line, ``<method> is <result>`` after each validation,
``Checkpoint written at iteration N`` and ``Training finished after N
iterations in Xs``.

Auxiliary losses: the loss of a step is the criterion's plus
``aux_loss_weight`` (0.01, Switch's) times the sum of the auxiliary
losses the forward's :class:`~bigdl_tpu_torch.nn.MoE` layers hand over
(``nn.moe.collect_aux_losses``), each a tensor of the forward's graph, so
a graphed step computes its own.

``steps_per_dispatch`` = K > 1 groups K same-shape batches into one
dispatch, as the JAX package scans K steps in one program. On CUDA the
first full group runs eagerly on a stream of its own (real steps, which
warm up everything the step touches), and every later one replays a
CUDA graph of the K steps (:class:`~bigdl_tpu_torch.optim.step_graph.
StepGraph`); on the CPU the K steps run eagerly. Either way the update
math and the step seeds are those of K single steps, the loss is the
last step's, the log, validation and checkpoint triggers fire at the
dispatch boundary (they are crossing-based), and a ragged or short tail
group runs as single eager steps.

Dropout noise: each step draws a step seed from a host generator seeded
with ``seed`` (one draw at the start, then one a step, counted for
resume), and a model that takes one (``core.module.takes_seed``: its
``forward`` has ``seed``, and a container holds a module that draws
noise) gets it as a 0-d int64 tensor on the device (microbatch i of a
step gets ``fold_seed(step seed, i)``).

``strategy``: a :class:`~bigdl_tpu_torch.parallel.DataParallel` over the
ranks of a ``torch.distributed`` job (one process a GPU). Each step then
takes this rank's part of the global batch (``strategy.shard_batch``,
unless the dataset already yields it: ``parallel.feeds_rank_part``),
normalises batch norm by the global batch's statistics, averages the
gradients and the loss over the ranks (``strategy.reduce_grads``),
clips, and updates the parameters this rank owns under ZeRO-1
(``strategy.update``). Validation sums its counts over the ranks. A
checkpoint gathers the ZeRO-1 state on every rank; rank 0 alone writes
it, in the single-process format with the strategy's
``layout_signature()`` in the manifests, and every rank meets at a
barrier after the write. ``steps_per_dispatch`` stays 1 under a strategy,
as in the JAX package.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.core.module import (resolve_device,
                                         takes_seed as _takes_seed)
from bigdl_tpu_torch.dataset.pipeline.staging import DeviceBatch
from bigdl_tpu_torch.nn.moe import collect_aux_losses
from bigdl_tpu_torch.nn.structural import fold_seed
from bigdl_tpu_torch.optim.method import (SGD, OptimMethod,
                                          clip_by_global_norm, clip_by_value)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.step_graph import StepGraph, batch_leaves
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validator import run_evaluation

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["Optimizer", "TrainedModel"]


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
    if isinstance(y, (np.ndarray, np.generic)):
        y = torch.from_numpy(np.asarray(y))
    return y.to(device, non_blocking=True)


def _batch_to_device(batch, device):
    """(x, y) of a batch on ``device``: a staged :class:`DeviceBatch` is
    claimed by the current stream (no copy), any other batch is copied
    (asynchronously from pinned memory)."""
    if isinstance(batch, DeviceBatch):
        on = batch.input.device
        if on.type != device.type or device.index not in (None, on.index):
            raise ValueError(f"a batch staged on {on} reached a loop on "
                             f"{device}")
        return batch.claim(torch.cuda.current_stream(device))
    x, y = batch
    return _to_device(x, device), _to_device(y, device)


def _split(y, accum: int):
    """Microbatches along dim 0 of a tensor or a tuple of tensors."""
    if isinstance(y, (tuple, list)):
        parts = [_split(t, accum) for t in y]
        return [type(y)(p[i] for p in parts) for i in range(accum)]
    return list(torch.chunk(y, accum, dim=0))


def _records(batch) -> int:
    x, _ = batch
    return len(x)


def _shape_sig(batch):
    return tuple((a.shape, a.dtype) for a in batch_leaves(batch))


def _canon(path: str) -> str:
    return os.path.abspath(os.path.normpath(str(path)))


@torch.no_grad()
def _copy_tree(dst: dict, src: dict, where: str) -> None:
    """Copy ``src`` into the tensors of ``dst`` in place, key by key."""
    if set(dst) != set(src):
        raise ValueError(f"{where}: keys {sorted(src)} do not match "
                         f"{sorted(dst)}")
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_tree(d, src[k], f"{where}.{k}")
        else:
            s = torch.as_tensor(np.asarray(src[k]) if not isinstance(
                src[k], torch.Tensor) else src[k])
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"{where}.{k}: shape {tuple(s.shape)}, "
                                 f"expected {tuple(d.shape)}")
            d.copy_(s)


class Optimizer:
    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 optim_method: Optional[OptimMethod] = None,
                 end_when: Optional[Trigger] = None, strategy=None,
                 seed: int = 42, log_every: int = 1, compute_dtype=None,
                 accum_steps: int = 1, nan_check: bool = True,
                 aux_loss_weight: float = 0.01, steps_per_dispatch: int = 1,
                 device=None):
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        if strategy is not None:
            from bigdl_tpu_torch.parallel import DataParallel
            if not isinstance(strategy, DataParallel):
                raise TypeError(
                    f"strategy must be a bigdl_tpu_torch.parallel."
                    f"DataParallel, got {type(strategy).__name__}")
            if self.steps_per_dispatch != 1:
                raise ValueError(
                    f"steps_per_dispatch={self.steps_per_dispatch} is a "
                    f"single-device dispatch amortization; it cannot be "
                    f"combined with a distributed strategy (whose runtime "
                    f"pipelines dispatch already)")
        self.strategy = strategy
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method = optim_method or SGD(learning_rate=1e-2)
        self.end_when = end_when or Trigger.max_epoch(1)
        self.seed = seed
        # bf16 activations with f32 parameters and loss (the JAX package's
        # compute_dtype): floating inputs are cast, the output is cast back
        self.compute_dtype = compute_dtype
        self.accum_steps = accum_steps
        # the NaN guard reads the loss at each log point (a sync the log
        # line pays for anyway), outside any captured graph
        self.nan_check = nan_check
        # each step adds this weight times the sum of the auxiliary losses
        # the forward's MoE layers hand over (Switch's 0.01); 0 disables
        self.aux_loss_weight = aux_loss_weight
        self.log_every = max(1, log_every)
        self.metrics = Metrics()
        self._clip_norm = None
        self._clip_const = None
        self._init = (None, None, None)
        self._phase_totals: dict = {}
        self._val_trigger = None
        self._val_dataset = None
        self._val_methods: list = []
        self._last_val_iter = -1
        self._ckpt_trigger = None
        self._ckpt_path = None
        self._last_ckpt_iter = -1
        self._ckpt_thread = None
        self._ckpt_error = None
        self._resume_paths = (None, None)
        self._resume_orphans: set = set()
        self._graph = None
        self._summary_dir = None
        self._wall_start = None

    # ------------------------------------------------------------- setters
    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods) -> "Optimizer":
        """Evaluate ``methods`` over ``dataset`` whenever ``trigger`` fires
        (checked after every dispatch and at every epoch's end; reference
        Optimizer.setValidation)."""
        self._val_trigger = trigger
        self._val_dataset = dataset
        self._val_methods = list(methods)
        return self

    def set_summary(self, directory: str) -> "Optimizer":
        """Append each log point's train scalars to ``<dir>/train.jsonl``
        and each validation's results to ``<dir>/val.jsonl``, one JSON row
        each, with ``wall_s``: seconds since ``optimize()`` started, taken
        on the host once the row's values are there (the
        accuracy-against-wall-clock curve)."""
        os.makedirs(directory, exist_ok=True)
        self._summary_dir = directory
        return self

    def _summary_write(self, which: str, row: dict) -> None:
        if self._summary_dir is None:
            return
        import json
        if self._wall_start is not None:
            row = {**row, "wall_s": round(time.time() - self._wall_start,
                                          3)}
        with open(os.path.join(self._summary_dir, f"{which}.jsonl"),
                  "a") as f:
            f.write(json.dumps(row) + "\n")

    def set_checkpoint(self, trigger: Trigger, path: str,
                       overwrite: bool = False, async_save: bool = False,
                       keep_last: Optional[int] = None) -> "Optimizer":
        """Write ``model.<n>`` (params, module state and the loop's
        counters) and ``state.<n>`` (the optimizer state) into ``path``
        whenever ``trigger`` fires, n the iteration (reference
        Optimizer.setCheckpoint). An existing snapshot raises
        ``FileExistsError`` unless ``overwrite``. ``async_save`` copies the
        tensors to the host on the loop and writes them on a thread, one
        write in flight (joined before the next one and at the end).
        ``keep_last=k`` deletes older snapshots after each write, never
        the newest valid pair. Local paths only."""
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if "://" in str(path):
            raise NotImplementedError(
                f"{path}: remote checkpoint paths are not in the PyTorch "
                f"port yet (ROADMAP.md queue 1 item 13)")
        self._ckpt_trigger = trigger
        self._ckpt_path = str(path)
        self._ckpt_overwrite = overwrite
        self._ckpt_async = async_save
        self._ckpt_keep_last = keep_last
        return self

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

    def set_state(self, params=None, mod_state=None,
                  opt_state=None) -> "Optimizer":
        """Warm-start (reference setState): ``params`` and ``mod_state``
        are ``{name: tensor or array}`` dicts in the model's names and
        layouts (a state dict, or JAX trees converted with
        ``interop.tensors_from_jax``), loaded strictly by name;
        ``opt_state`` a tree of the optimizer's ``init`` structure, copied
        into its state before the first step."""
        self._init = (params, mod_state, opt_state)
        return self

    def resume(self, checkpoint_dir: str) -> "Optimizer":
        """Load the newest valid ``model.<n>``/``state.<n>`` pair of a
        directory (written by the port or by the JAX package); without a
        valid pair, the newest ``model.<n>`` alone (params only, the
        optimizer state fresh). If that one snapshot fails its checksum,
        raise :class:`~bigdl_tpu_torch.utils.file.ChecksumError`.

        The run continues the epoch and iteration numbering, and is step
        for step the run that was stopped: the step-seed stream is
        fast-forwarded by the snapshot's draw count, each finished epoch's
        effect on the dataset is replayed (its ``skip_epoch()``; for a
        dataset without one, an iteration's start and one ``shuffle()``),
        and the open epoch's consumed records are skipped. A snapshot
        written through an executor feed carries its epoch plan, and a
        plan that differs from this run's is warned about. Newer
        snapshots left unmatched by the stop may be overwritten. A JAX snapshot carries params, module state,
        optimizer state and counters, not jax's PRNG stream: the seeds
        differ, which matters only with dropout."""
        from bigdl_tpu_torch.utils.file import (ChecksumError,
                                                latest_checkpoint,
                                                latest_valid_checkpoint_pair,
                                                orphaned_snapshots,
                                                verify_checkpoint)
        d = str(checkpoint_dir)
        m, s = latest_valid_checkpoint_pair(d)
        if m is None:
            m = latest_checkpoint(d, "model.")
            if m is not None and not verify_checkpoint(m):
                raise ChecksumError(
                    f"the only snapshot in {d} ({m}) fails checksum "
                    f"verification and there is no earlier one")
        self._resume_paths = (m, s)
        if m is None:
            return self
        it = int(m.rsplit(".", 1)[-1])
        self._resume_orphans = {_canon(o) for o in orphaned_snapshots(d, it)}
        if self._resume_orphans:
            logger.warning("resume: %d unmatched snapshot file(s) newer than "
                           "the loaded pair; the resumed run may overwrite "
                           "them: %s", len(self._resume_orphans),
                           sorted(self._resume_orphans))
        return self

    def _load_resume(self, params: dict, opt_state: dict) -> dict:
        """Load the snapshots ``resume`` chose into the model and the
        optimizer state (in place); returns the driver counters."""
        from bigdl_tpu_torch.interop.checkpoint import load_model, load_state
        m, s = self._resume_paths
        tensors, driver = load_model(m, self.model)
        self.model.load_state_dict(tensors, strict=True)
        if s is not None:
            _copy_tree(opt_state, load_state(s, opt_state, self.model), s)
        if driver is None:
            driver = {"iteration": int(m.rsplit(".", 1)[-1])}
        saved = driver.get("plan")
        plan = getattr(self.dataset, "plan", None)
        if saved and plan is not None and hasattr(plan, "signature"):
            # the epoch is the snapshot's cursor, not the plan's identity
            theirs = {k: v for k, v in saved.items() if k != "epoch"}
            mine = {k: v for k, v in plan.signature().items()
                    if k != "epoch"}
            if mine != theirs:
                logger.warning(
                    "resume: checkpoint epoch plan %s differs from this "
                    "run's %s: the replayed batch stream will NOT match the "
                    "stopped run's", theirs, mine)
        logger.info("Resumed from %s%s", m, f" and {s}" if s else "")
        return driver

    # ---------------------------------------------------------------- step
    def _loss(self, x, y, seed, takes_seed):
        dtype = self.compute_dtype
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        with collect_aux_losses() as aux:
            out = self.model(x, seed=seed) if takes_seed else self.model(x)
        if dtype is not None:
            out = out.float()
        loss = self.criterion(out, y)
        if self.aux_loss_weight and aux:
            loss = loss + self.aux_loss_weight * sum(a.float() for a in aux)
        return loss

    def _step(self, params: dict, opt_state: dict, x, y, seed,
              takes_seed: bool):
        """One training step on device tensors; updates the parameters,
        the optimizer state and the module state in place and returns the
        loss. Nothing here reads a value back to the host, so the same
        code runs eagerly and under a CUDA graph capture."""
        accum = max(1, self.accum_steps)
        names, plist = list(params), list(params.values())

        def grads_of(loss):
            gs = torch.autograd.grad(loss, plist, allow_unused=True)
            return [torch.zeros_like(p) if g is None else g
                    for p, g in zip(plist, gs)]

        if accum == 1:
            loss = self._loss(x, y, seed, takes_seed)
            gs = grads_of(loss)
        else:
            if x.shape[0] % accum:
                raise ValueError(f"batch size {x.shape[0]} not divisible by "
                                 f"accum_steps={accum}")
            loss, gs = torch.zeros((), device=x.device), None
            for i, (xb, yb) in enumerate(zip(_split(x, accum),
                                             _split(y, accum))):
                s = None if seed is None else fold_seed(seed, i)
                mb = self._loss(xb, yb, s, takes_seed)
                g = grads_of(mb)
                if gs is None:
                    gs = g
                else:
                    for acc, gi in zip(gs, g):
                        acc.add_(gi)
                loss = loss + mb.detach()
            loss = loss / accum
            gs = [g / accum for g in gs]
        grads = dict(zip(names, gs))
        if self.strategy is not None:
            grads, loss = self.strategy.reduce_grads(grads, loss)
        if self._clip_const is not None:
            grads = clip_by_value(grads, *self._clip_const)
        if self._clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, self._clip_norm)
        if self.strategy is not None:
            self.strategy.update(self.optim_method, grads, opt_state, params)
        else:
            self.optim_method.update(grads, opt_state, params)
        return loss.detach()

    # ----------------------------------------------------------- callbacks
    def _maybe_validate(self, progress: dict):
        if (self._val_trigger is None or not self._val_trigger(progress)
                or progress["iteration"] == self._last_val_iter):
            return
        self._last_val_iter = progress["iteration"]
        results = run_evaluation(self.model, self._val_dataset,
                                 self._val_methods, self.device,
                                 self.strategy)
        for m, r in zip(self._val_methods, results):
            logger.info("%s is %r", m.name, r)
        self._summary_write("val", {
            "iteration": progress["iteration"], "epoch": progress["epoch"],
            **{m.name.replace(" ", "_"): r.result()[0]
               for m, r in zip(self._val_methods, results)}})
        progress["val_results"] = results
        if results:
            progress["val_score"] = float(results[0].result()[0])

    def _maybe_checkpoint(self, opt_state: dict, progress: dict):
        if (self._ckpt_path is None or not self._ckpt_trigger(progress)
                or progress["iteration"] == self._last_ckpt_iter):
            return
        t0 = time.perf_counter()
        self._write_checkpoint(opt_state, progress)
        self._phase("ckpt", time.perf_counter() - t0)

    def _write_checkpoint(self, opt_state: dict, progress: dict):
        from bigdl_tpu_torch.interop.checkpoint import save_model, save_state
        n = progress["iteration"]
        self._last_ckpt_iter = n
        target = os.path.join(self._ckpt_path, f"model.{n}")
        state_target = os.path.join(self._ckpt_path, f"state.{n}")
        overwrite = (self._ckpt_overwrite
                     or _canon(target) in self._resume_orphans)
        if os.path.exists(target) and not overwrite:
            raise FileExistsError(
                f"{target} exists; pass overwrite=True to set_checkpoint "
                f"(--overWriteCheckpoint) to clobber it")
        driver = {"epoch": progress["epoch"], "iteration": n,
                  "rng_splits": self._draws,
                  "epoch_records": progress.get("epoch_records", 0)}
        plan = getattr(self.dataset, "plan", None)
        if plan is not None and hasattr(plan, "signature"):
            # the executor feed's schedule: resume checks it is replayed
            driver["plan"] = plan.signature()
        self._join_ckpt_writer()  # one write in flight
        layout, strat = None, self.strategy
        if strat is not None:
            _, _, opt_state = strat.gather(None, None, opt_state)  # all ranks
            layout = strat.layout_signature()
            if strat.rank != 0:
                strat.barrier()  # rank 0 writes
                return
        # host copies, taken now: the next step (or replay) updates the
        # tensors in place
        tensors = _host_tree(self.model.state_dict())
        state = _host_tree(opt_state)

        def write():
            save_model(target, self.model, driver, tensors, layout=layout)
            save_state(state_target, state, self.model, layout=layout)
            if self._ckpt_keep_last:
                from bigdl_tpu_torch.utils.file import gc_checkpoints
                gc_checkpoints(self._ckpt_path, self._ckpt_keep_last)
            logger.info("Checkpoint written at iteration %d to %s%s", n,
                        self._ckpt_path, " (async)" if self._ckpt_async
                        else "")

        if not self._ckpt_async:
            write()
            if strat is not None:
                strat.barrier()
            return

        def worker():
            try:
                write()
            except BaseException as e:  # raised at the next join
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=worker, daemon=True)
        self._ckpt_thread.start()
        if strat is not None:
            strat.barrier()

    def _join_ckpt_writer(self):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _phase(self, name: str, dt: float):
        """Host seconds per phase: ``data_wait`` (fetching batches),
        ``h2d`` (issuing the copies of the batches to the device on the
        loop's thread, and a graph's wait for its pinned area to be
        read), ``h2d_staged`` (issuing them on a staging thread,
        ``--stage device``: overlapped with the loop), ``dispatch`` (the
        steps, up to the log point's sync, ``h2d`` included) and ``ckpt``
        (what the loop pays for a snapshot)."""
        self._phase_totals[name] = self._phase_totals.get(name, 0.0) + dt

    # ------------------------------------------------------------ optimize
    def optimize(self) -> TrainedModel:
        try:
            return self._optimize()
        finally:
            self._join_ckpt_writer()

    def _optimize(self) -> TrainedModel:
        model = self.model
        init_params, init_mod_state, init_opt = self._init
        if init_params is not None or init_mod_state is not None:
            tensors = dict(model.state_dict())
            for src in (init_params or {}), (init_mod_state or {}):
                tensors.update({k: torch.as_tensor(
                    v if isinstance(v, torch.Tensor) else np.asarray(v))
                    for k, v in src.items()})
            model.load_state_dict(tensors, strict=True)
        params = dict(model.named_parameters())
        opt_state = self.optim_method.init(params)
        if init_opt is not None:
            _copy_tree(opt_state, init_opt, "opt_state")
        rd = (self._load_resume(params, opt_state)
              if self._resume_paths[0] else None)
        strat, rank_local, step_fn = self.strategy, False, self._step
        if strat is not None:
            from bigdl_tpu_torch.interop.checkpoint import model_tensors
            from bigdl_tpu_torch.parallel import feeds_rank_part
            params, _, opt_state = strat.place(
                params, model_tensors(model)[1], opt_state)
            strat.sync_batch_norm(model)
            rank_local = feeds_rank_part(self.dataset)
            step_fn = strat.compile_step(self._step)
        takes_seed = _takes_seed(model)
        gen = torch.Generator().manual_seed(self.seed)
        self._draws = 0

        def next_seed() -> int:
            self._draws += 1
            return int(torch.randint(0, 2 ** 62, (1,), generator=gen))

        next_seed()  # the JAX loop's init split: the counts stay aligned
        model.train()

        progress = {"epoch": 1, "iteration": 0, "prev_iteration": 0,
                    "epoch_finished": False, "loss": float("inf"),
                    "epoch_records": 0}
        skip = 0
        if rd:
            progress["iteration"] = progress["prev_iteration"] = \
                rd.get("iteration", 0)
            progress["epoch"] = rd.get("epoch", 1)
            while self._draws < rd.get("rng_splits", 0):
                next_seed()
            for _ in range(progress["epoch"] - 1):
                skip_epoch = getattr(self.dataset, "skip_epoch", None)
                if skip_epoch is not None:
                    skip_epoch()
                else:  # a finished epoch's draw, then its shuffle
                    next(iter(self.dataset), None)
                    self.dataset.shuffle()
            skip = rd.get("epoch_records", 0)
            logger.info("Resuming at epoch %d, iteration %d (seed stream at "
                        "%d draws, skipping %d consumed records)",
                        progress["epoch"], progress["iteration"],
                        self._draws, skip)

        K = self.steps_per_dispatch
        graphed = K > 1 and self.device.type == "cuda"
        self._graph = None
        clock = {"last_log": time.time(), "fetch": 0.0}

        def run_eager(batch, step_seed):
            t0 = time.perf_counter()
            if strat is not None and not isinstance(batch, DeviceBatch):
                batch = strat.shard_batch(*batch, rank_local=rank_local)
            x, y = _batch_to_device(batch, self.device)
            if strat is not None and isinstance(batch, DeviceBatch):
                x, y = strat.shard_batch(x, y, rank_local=rank_local)
            self._phase("h2d", time.perf_counter() - t0)
            s = (torch.tensor(step_seed, dtype=torch.int64,
                              device=self.device) if takes_seed else None)
            return step_fn(params, opt_state, x, y, s, takes_seed)

        def graph_step(x, y, s):
            return self._step(params, opt_state, x, y,
                              s if takes_seed else None, takes_seed)

        def after_dispatch(n_rec, n_iters, t0, loss):
            prev = progress["iteration"]
            progress["prev_iteration"] = prev
            progress["iteration"] = prev + n_iters
            progress["loss"] = loss
            progress["epoch_records"] += n_rec
            if progress["iteration"] // self.log_every == \
                    prev // self.log_every:
                self._phase("dispatch", time.time() - t0)
                return
            loss_f = float(loss)  # syncs: the dispatch has finished
            progress["loss"] = loss_f
            if self.nan_check and not math.isfinite(loss_f):
                raise FloatingPointError(
                    f"loss became {loss_f} at iteration "
                    f"{progress['iteration']} (epoch {progress['epoch']}) — "
                    f"NaN guard tripped; the last checkpoint is the "
                    f"recovery point")
            now = time.time()
            dt = now - t0
            self._phase("dispatch", dt)
            self.metrics.add("get batch time", clock["fetch"])
            self.metrics.add("computing time",
                             (now - clock["last_log"]) - clock["fetch"])
            clock["last_log"], clock["fetch"] = now, 0.0
            logger.info("Train %d in %.4fs. Throughput is %.1f "
                        "records/second. Loss is %.4f",
                        n_rec, dt, n_rec / max(dt, 1e-9), loss_f)
            self._summary_write("train", {
                "iteration": progress["iteration"],
                "epoch": progress["epoch"], "loss": loss_f,
                "records_per_second": n_rec / max(dt, 1e-9)})
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("%s", self.metrics.summary())

        def dispatch_group(buf):
            """K batches as one dispatch: eager on the CPU and for CUDA's
            first group (on the capture stream), a graph replay after."""
            t0 = time.time()
            seeds = [next_seed() for _ in buf]
            if not graphed:
                for b, s in zip(buf, seeds):
                    loss = run_eager(b, s)
            elif self._graph is None:
                stream = torch.cuda.Stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    for b, s in zip(buf, seeds):
                        loss = run_eager(b, s)
                torch.cuda.current_stream(self.device).wait_stream(stream)
                self._graph = StepGraph(graph_step, buf[0], K, self.device,
                                        stream)
            else:
                if not self._graph.captured:
                    self._join_ckpt_writer()
                    self._graph.capture()
                t1 = time.perf_counter()
                self._graph.put(buf, seeds)
                self._phase("h2d", time.perf_counter() - t1)
                loss = self._graph.replay()
            after_dispatch(sum(_records(b) for b in buf), K, t0, loss)

        wall_start = self._wall_start = time.time()
        while not self.end_when(progress):
            progress["epoch_finished"] = False
            epoch_start = time.time()
            snap = dict(self._phase_totals)
            progress["epoch_records"] = 0
            self.optim_method.set_epoch(opt_state, progress["epoch"])
            data = iter(self.dataset)
            while skip > 0:  # a resumed epoch: its consumed records
                b = next(data, None)
                if b is None:
                    break
                skip -= _records(b)
                progress["epoch_records"] += _records(b)
            skip = 0
            pending, epoch_done = None, False
            while not epoch_done:
                t_fetch = time.time()
                buf = []
                while len(buf) < K:
                    b, pending = (pending, None) if pending is not None \
                        else (next(data, None), None)
                    if b is None:
                        epoch_done = True
                        break
                    if buf and _shape_sig(b) != _shape_sig(buf[0]):
                        pending = b  # ragged: flush, then start a group
                        break
                    if isinstance(b, DeviceBatch):
                        self._phase("h2d_staged", b.h2d_s)
                    buf.append(b)
                dt_fetch = time.time() - t_fetch
                clock["fetch"] += dt_fetch
                self._phase("data_wait", dt_fetch)
                if not buf:
                    break
                if len(buf) == K and K > 1:
                    dispatch_group(buf)
                    done = self._after_step(opt_state, progress)
                else:
                    for b in buf:
                        t0 = time.time()
                        loss = run_eager(b, next_seed())
                        after_dispatch(_records(b), 1, t0, loss)
                        done = self._after_step(opt_state, progress)
                        if done:
                            break
                if done:
                    break
            records = progress["epoch_records"]
            progress["epoch"] += 1
            progress["epoch_finished"] = True
            progress["epoch_records"] = 0
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
            self._maybe_validate(progress)
            self._maybe_checkpoint(opt_state, progress)
        self._join_ckpt_writer()
        logger.info("Training finished after %d iterations in %.1fs",
                    progress["iteration"], time.time() - wall_start)
        model.eval()
        return TrainedModel(model)

    def _after_step(self, opt_state, progress) -> bool:
        """Validation and checkpoint triggers after a dispatch; True when
        training should end."""
        self._maybe_validate(progress)
        self._maybe_checkpoint(opt_state, progress)
        return self.end_when(progress)


def _host_tree(tree: dict) -> dict:
    """Host copies of a tree of tensors."""
    return {k: _host_tree(v) if isinstance(v, dict) else
            v.detach().to("cpu", copy=True) for k, v in tree.items()}

