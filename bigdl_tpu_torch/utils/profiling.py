"""Tracing and profiling (counterpart of ``bigdl_tpu/utils/profiling.py``;
SURVEY.md §5 "Tracing / profiling").

* :func:`time_modules`: per-module forward wall time (the reference's
  AbstractModule.getTimes, Container.scala:70-77): each child of a
  Sequential chain timed eagerly, recursively, warm-up first, then the
  best of ``iters`` calls, with ``torch.cuda.synchronize`` around each call
  on a card. Rows are ``(path, seconds)`` in execution order; a container
  row holds the sum of its children's.
* :func:`trace`: one ``torch.profiler`` session around a block, exported
  as a Kineto (Chrome trace) JSON file under ``logdir`` (the JAX
  version's ``jax.profiler.trace``). ``torch.profiler`` allows one
  session a process, so a block inside another session is refused, as
  ``obs.capture`` refuses a window.
* :func:`format_times`: the rows as the reference's getTimes log.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["time_modules", "trace", "format_times"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile a block into ``logdir/trace.json`` (open it in Perfetto or
    ``chrome://tracing``, or read it with ``utils.kineto``):

    >>> with trace("/tmp/tb"):
    ...     model(x)  # kernels on the device timeline

    ``device``: the card whose kernels to record (default: CUDA where
    torch sees one)."""
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        raise RuntimeError("another torch.profiler session is running in "
                           "this process")
    acts = [ProfilerActivity.CPU]
    dev = torch.device(device) if device is not None else None
    if (dev.type == "cuda" if dev is not None
            else torch.cuda.is_available()):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def time_modules(module, x, iters: int = 3, training: bool = False,
                 seed: Optional[int] = None):
    """Per-child forward wall time, eagerly, recursing into Sequential
    chains. Returns rows ``(path, seconds_per_call)`` in execution order
    (the root's path is its ``name``, a child's ``<parent>.<i>:<name>``);
    container rows hold the sum of their children. ``training`` runs the
    modules in training mode (``seed`` goes to a module whose forward takes
    one); the module's mode is restored after."""
    from bigdl_tpu_torch.core.module import Sequential, takes_seed

    rows: list = []
    was = module.training
    module.train(training)

    def run(mod, x, path):
        if isinstance(mod, Sequential):
            total = 0.0
            start_row = len(rows)
            rows.append((path, 0.0))  # placeholder, filled after children
            for i, child in enumerate(mod.children()):
                x, dt = run(child, x,
                            f"{path}.{i}:{getattr(child, 'name', '')}")
                total += dt
            rows[start_row] = (path, total)
            return x, total

        kw = ({"seed": seed} if training and seed is not None
              and takes_seed(mod) else {})

        def once():
            _sync(x)
            t0 = time.perf_counter()
            y = mod(x, **kw)
            _sync(y)
            return y, time.perf_counter() - t0

        y, _ = once()  # warm-up: kernel builds, library set-up
        best = min(once()[1] for _ in range(max(1, iters)))
        rows.append((path, best))
        return y, best

    try:
        with torch.set_grad_enabled(training):
            run(module, x, getattr(module, "name", type(module).__name__))
    finally:
        module.train(was)
    return rows


def format_times(rows) -> str:
    """Pretty table like the reference's getTimes log (module, time)."""
    width = max(len(p) for p, _ in rows)
    lines = [f"{p:<{width}}  {dt * 1e3:10.3f} ms" for p, dt in rows]
    return "\n".join(lines)
