"""K training steps as one CUDA graph (the counterpart of the JAX
package's ``steps_per_dispatch`` scan, ``bigdl_tpu/optim/optimizer.py``
``chunk_step``, and of ``cli.perf --innerSteps``).

:class:`StepGraph` captures ``step(x, y, seed)`` K times, step i reading
batch i and seed i from static device buffers, and replays the capture
once per dispatch. A dispatch stages its K batches and K seeds with one
H2D copy from pinned host memory into those buffers, then replays. The
step itself updates the parameters, the optimizer state and the BN
running statistics in place, so they are the graph's static tensors: a
checkpoint reads them between replays, and a resume loads into them
before the capture.

The caller warms the step up on the capture stream before the capture
(cuDNN and cuBLAS workspaces, the kernels' builds, their attributes and
occupancy queries, and the BN kernels' barrier counters, which are kept
per stream, all exist then), and runs no eager step on that stream once
the graph may replay. A capture or replay that fails raises: nothing runs
the step eagerly in its place."""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

__all__ = ["StepGraph", "batch_leaves"]

_ALIGN = 64


def batch_leaves(batch) -> List[torch.Tensor]:
    """The host tensors of an (x, y) batch of arrays or CPU tensors, y one
    or a tuple of them (numpy arrays are viewed, not copied)."""
    x, y = batch
    ys = list(y) if isinstance(y, (tuple, list)) else [y]
    return [a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.asarray(a)) for a in [x] + ys]


class StepGraph:
    """``steps`` calls of ``step(x, y, seed) -> loss`` captured as one CUDA
    graph over static buffers shaped like ``batch`` (``seed`` a 0-d int64
    tensor), on ``stream``. :meth:`put` stages a dispatch's batches and
    seeds, :meth:`replay` runs them and returns the last step's loss."""

    def __init__(self, step: Callable, batch, steps: int,
                 device: torch.device, stream: torch.cuda.Stream):
        self._step = step
        self.steps = steps
        self._stream = stream
        _, y = batch
        self._y_kind = type(y) if isinstance(y, (tuple, list)) else None
        specs = [(a.dtype, a.shape) for a in batch_leaves(batch)]
        specs.append((torch.int64, torch.Size()))  # the step seeds
        spans, total = [], 0
        for dt, shape in specs:
            n = steps * shape.numel() * dt.itemsize
            spans.append((total, n))
            total += -(-n // _ALIGN) * _ALIGN
        self._host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        self._dev = torch.empty(total, dtype=torch.uint8, device=device)
        self._host_views, self._views = [], []
        for (dt, shape), (off, n) in zip(specs, spans):
            full = (steps,) + tuple(shape)
            for buf, views in ((self._host, self._host_views),
                               (self._dev, self._views)):
                views.append(buf[off:off + n].view(dt).view(full))
        self._copied = torch.cuda.Event()
        self._graph = None
        self._loss = None
        self.launches: dict = {}

    def _batch(self, i: int):
        x, *ys = (v[i] for v in self._views[:-1])
        return x, (self._y_kind(ys) if self._y_kind else ys[0])

    def put(self, batches: Sequence, seeds: Sequence[int]) -> None:
        """Stage ``steps`` batches (each shaped like the capture's) and
        their seeds: one H2D copy on the current stream."""
        if len(batches) != self.steps or len(seeds) != self.steps:
            raise ValueError(f"a dispatch stages {self.steps} batches and "
                             f"seeds, got {len(batches)} and {len(seeds)}")
        self._copied.synchronize()  # the last copy has read the host buffer
        for i, b in enumerate(batches):
            for hv, a in zip(self._host_views, batch_leaves(b)):
                hv[i].copy_(a)
        self._host_views[-1].copy_(torch.as_tensor(seeds, dtype=torch.int64))
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self) -> None:
        """Capture the ``steps`` steps. The kernel wrappers count their
        launches while they are captured; the capture launches nothing, so
        those counts are taken back and credited at every replay."""
        from bigdl_tpu_torch import ops

        before = ops.kernel_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            for i in range(self.steps):
                x, y = self._batch(i)
                loss = self._step(x, y, self._views[-1][i])
        after = ops.kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        ops.add_kernel_launches(self.launches, -1)
        self._graph, self._loss = graph, loss

    def replay(self) -> torch.Tensor:
        """Run the staged steps on the current stream; the last step's
        loss (a copy: the graph's own is overwritten by the next
        replay)."""
        from bigdl_tpu_torch import ops

        self._graph.replay()
        ops.add_kernel_launches(self.launches)
        return self._loss.clone()
