"""CUDA graphs of the serving path (the counterpart of the JAX package's
per-shape jitted programs in ``bigdl_tpu/serving/decode.py`` and
``engine.py``), beside ``optim/step_graph.py`` for training.

A :class:`GraphPool` is what the serving stack's graphs share: one
memory pool, one stream and one lock. Every device operation of the
decode engine and the inference engine runs under :meth:`GraphPool.work`,
in order on that stream: staging a replay's inputs into static buffers,
the replay, and the small eager writes between replays (slot knobs, page
tables, page copies). Graphs of one pool never run concurrently, and each
keeps its long-lived results in buffers allocated outside the pool or
hands them to the caller before the lock is released, so captures may
reuse each other's temporaries.

A :class:`GraphSet` holds one engine's graphs by key. ``capture(key,
fn)`` runs ``fn`` once on the pool's stream, then captures it; that
warm-up is a real call (kernel builds, cuBLAS handles and workspaces,
allocator blocks all exist before capture). ``run(key, fn)`` replays the
key's graph; ``fn`` reads and writes only static buffers (a graph
freezes the addresses it was captured with: the flash kernels' TMA
descriptors are encoded from them). The engines capture every graph they
serve before any serving thread starts, so the set of graphs, and the
memory they hold, is fixed at start-up: ``run`` refuses a key that was
not captured. Captures are thread-local
(``capture_error_mode="thread_local"``), under the lock. A capture or
replay that fails raises: nothing runs eagerly in its place. Each replay
credits the kernel launches its capture recorded
(``ops.add_kernel_launches``).

On the CPU, or with graphs turned off, ``run`` calls ``fn``: the same code
runs eagerly over the same static buffers.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable

import torch

__all__ = ["GraphPool", "GraphSet"]


class GraphPool:
    """The memory pool, stream and lock the serving graphs on ``device``
    share. ``enabled`` is False on the CPU, and where the caller turns the
    graphs off."""

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = bool(enabled) and self.device.type == "cuda"
        self.lock = threading.RLock()
        if self.enabled:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        else:
            self.stream = self.pool = None

    @contextlib.contextmanager
    def work(self):
        """Hold the lock and, on the card, make the serving stream current,
        ordered after what the caller's stream has queued (the buffers it
        made) and before what the caller queues next (reads of results)."""
        with self.lock:
            if self.stream is None:
                yield
                return
            caller = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(caller)
            try:
                with torch.cuda.stream(self.stream):
                    yield
            finally:
                caller.wait_stream(self.stream)


class _Captured:
    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches


class GraphSet:
    """One engine's graphs in a shared :class:`GraphPool`, by key."""

    def __init__(self, pool: GraphPool):
        self.pool = pool
        self._graphs: dict = {}

    @property
    def enabled(self) -> bool:
        return self.pool.enabled

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def capture(self, key: Hashable, fn: Callable):
        """Run ``fn`` once on the pool's stream, then capture it as
        ``key``'s graph."""
        from bigdl_tpu_torch import ops

        p = self.pool
        with p.work():
            fn()
            before = ops.kernel_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=p.pool, stream=p.stream,
                                  capture_error_mode="thread_local"):
                captured = fn()
            after = ops.kernel_launches()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            ops.add_kernel_launches(launches, -1)
            self._graphs[key] = _Captured(graph, captured, launches)

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, fn: Callable):
        """``fn()`` through ``key``'s graph; ``fn()`` itself on the CPU or
        with graphs off. A key with no graph raises KeyError."""
        if not self.pool.enabled:
            return fn()
        from bigdl_tpu_torch import ops

        with self.pool.work():
            g = self._graphs.get(key)
            if g is None:
                raise KeyError(f"no CUDA graph was captured for {key!r}: "
                               f"graphs are captured at start-up only")
            g.graph.replay()
            ops.add_kernel_launches(g.launches)
            return g.out

    def clear(self) -> None:
        self._graphs.clear()
