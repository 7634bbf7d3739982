"""Dynamic micro-batching with backpressure admission, per-row deadlines
and dead-worker fast-fail (counterpart of ``bigdl_tpu/serving/batcher.py``,
host-side and unchanged in behaviour).

Requests queue one row at a time; a worker thread flushes a batch when
``max_batch`` rows wait (throughput trigger) or the oldest row has waited
``max_wait_ms`` (latency trigger), and the engine's bucket padding turns
the batch into a fixed shape. Past ``max_queue`` pending rows ``submit``
raises :class:`AdmissionError` at once (HTTP 429). Rows past their
deadline are dropped before compute (:class:`DeadlineExceeded`, HTTP
504). A dead worker fails every pending future with :class:`WorkerDied`
(HTTP 503) and later submits fast. The flush decision is a pure function
of the injected ``clock`` (``pump``), so tests need no threads.

Each row may carry its request id (``rid``): with ``--reqTrace`` on, the
request's lifecycle record notes its queueing, its dequeue and the
engine forward that computed it, and the span timeline gets a
``queue_wait`` span a row. A weight swap needs what is in flight:
:meth:`in_flight` counts the queued rows and the rows of the flush being
computed, and the flush runs under :attr:`exec_lock`, which the swap
holds across its copy.
"""

from __future__ import annotations

import collections
import inspect
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.obs.spans import get_tracer as _get_tracer
from bigdl_tpu_torch.obs.spans import span as _obs_span
from bigdl_tpu_torch.serving.reqtrace import get as _get_reqtracer

__all__ = ["AdmissionError", "DeadlineExceeded", "WorkerDied",
           "MicroBatcher"]


class AdmissionError(RuntimeError):
    """Queue at capacity — request rejected at admission (HTTP 429)."""


class DeadlineExceeded(RuntimeError):
    """Request deadline expired before compute (HTTP 504)."""


class WorkerDied(RuntimeError):
    """The serving worker thread is dead or wedged (HTTP 503)."""


class _Future:
    """Minimal thread-safe future resolved by a worker thread."""

    # ``decoder``: the engine a /generate future was submitted to (the
    # routed replica's under dp)
    __slots__ = ("_event", "_value", "_exc", "decoder")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None
        self.decoder = None

    def set_result(self, v) -> None:
        self._value = v
        self._event.set()

    def set_exception(self, e: BaseException) -> None:
        self._exc = e
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("batched request did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._value


class _Pending:
    __slots__ = ("row", "future", "t_enqueue", "deadline", "rid")

    def __init__(self, row, future, t, deadline=None, rid=None):
        self.row, self.future, self.t_enqueue = row, future, t
        self.deadline = deadline
        self.rid = rid


class MicroBatcher:
    """Gather single-row requests into engine batches.
    ``predict_fn(batch_rows) -> scores`` is typically
    ``engine.predict_scores``. With ``start=False`` no worker thread runs
    and the caller drives :meth:`pump`."""

    def __init__(self, predict_fn: Callable, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, max_queue: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, start: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.clock = clock
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        self._thread = None
        self._worker_error: Optional[BaseException] = None
        self._last_beat = clock()
        self._in_flush = False
        self._executing = 0  # rows drained and not yet resolved
        self.exec_lock = threading.Lock()  # held across each flush
        # an engine forward that takes ``rids`` attributes its compute
        # window to those requests; a plain fn gets the whole flush's
        try:
            self._fn_takes_rids = "rids" in inspect.signature(
                predict_fn).parameters
        except (TypeError, ValueError):
            self._fn_takes_rids = False

        if metrics is not None:
            self._m_submitted = metrics.counter(
                "batcher_rows_submitted_total", "rows accepted by submit")
            self._m_rejected = metrics.counter(
                "batcher_rows_rejected_total",
                "rows fast-rejected at admission (queue full)")
            self._m_expired = metrics.counter(
                "batcher_rows_expired_total",
                "rows dropped before compute (deadline exceeded)")
            self._m_dead = metrics.counter(
                "batcher_dead_submit_total",
                "submits fast-failed because the worker is dead")
            self._m_flushes = metrics.counter(
                "batcher_flushes_total", "micro-batches dispatched")
            self._m_wait = metrics.histogram(
                "batcher_queue_wait_ms", "enqueue -> flush wait per row")
            metrics.gauge("batcher_queue_depth", "rows currently queued",
                          fn=lambda: len(self._pending))
            metrics.gauge("batcher_worker_up",
                          "1 while the flush worker is healthy",
                          fn=lambda: 0.0 if self._worker_error else 1.0)
        else:
            self._m_submitted = self._m_rejected = self._m_flushes = None
            self._m_expired = self._m_dead = self._m_wait = None

        if start:
            self._thread = threading.Thread(target=self._worker,
                                            name="micro-batcher",
                                            daemon=True)
            self._thread.start()

    # --------------------------------------------------------------- submit
    def submit(self, row, deadline: Optional[float] = None,
               rid: Optional[str] = None) -> _Future:
        """Queue one input row; the future resolves to its score row.
        ``deadline`` is absolute, on the batcher's clock; ``rid`` tags the
        row with its request id."""
        return self.submit_many([row], deadline, rid)[0]

    def submit_many(self, rows: Sequence, deadline: Optional[float] = None,
                    rid: Optional[str] = None) -> list:
        """Queue the rows of one request under one hold of the queue's
        lock (one future a row), as one ``submit`` a row would, rejecting
        at the first row past ``max_queue``: a weight swap, which waits
        for :meth:`in_flight` to reach 0, then never sees part of a
        request computed and the rest still to come."""
        now = self.clock()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._worker_error is not None or (
                    self._thread is not None
                    and not self._thread.is_alive()):
                if self._m_dead is not None:
                    self._m_dead.inc()
                raise WorkerDied(
                    "micro-batcher worker is dead: "
                    f"{self._worker_error or 'thread exited'}")
            if deadline is not None and now >= deadline:
                if self._m_expired is not None:
                    self._m_expired.inc()
                raise DeadlineExceeded(
                    f"deadline expired {now - deadline:.3f}s before "
                    f"submit")
            futs = []
            for row in rows:
                if len(self._pending) >= self.max_queue:
                    if self._m_rejected is not None:
                        self._m_rejected.inc()
                    self._wakeup.notify()
                    raise AdmissionError(
                        f"queue at capacity ({self.max_queue} rows pending)")
                futs.append(_Future())
                self._pending.append(_Pending(row, futs[-1], now, deadline,
                                              rid))
                if self._m_submitted is not None:
                    self._m_submitted.inc()
            self._wakeup.notify()
        if rid is not None:
            rt = _get_reqtracer()
            if rt is not None:
                rt.note_queued(rid)
        return futs

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def in_flight(self) -> int:
        """Rows queued or being computed (the swap's drain count)."""
        with self._lock:
            return len(self._pending) + self._executing

    # ------------------------------------------------------ watchdog surface
    def alive(self) -> bool:
        """False once the worker died or was declared dead (threadless
        mode counts as alive: pump() is the worker)."""
        if self._worker_error is not None:
            return False
        return self._thread is None or self._thread.is_alive()

    def busy(self) -> bool:
        return bool(self._pending) or self._in_flush

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        return (self.clock() if now is None else now) - self._last_beat

    @property
    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error

    def declare_dead(self, exc: BaseException) -> None:
        """Fail every pending future with ``exc`` and make later submits
        raise :class:`WorkerDied`."""
        with self._lock:
            if self._worker_error is None:
                self._worker_error = exc
            dead = list(self._pending)
            self._pending.clear()
            self._wakeup.notify_all()
        for p in dead:
            p.future.set_exception(
                exc if isinstance(exc, WorkerDied)
                else WorkerDied(f"micro-batcher worker died: {exc}"))

    # ---------------------------------------------------------- flush logic
    def _flush_ready(self, now: float) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        head = self._pending[0]
        if head.deadline is not None and now >= head.deadline:
            return True
        return (now - head.t_enqueue) >= self.max_wait_s

    def _drain(self, now: float) -> list:
        """Pop up to max_batch live rows; expired rows resolve with
        :class:`DeadlineExceeded` before any compute."""
        batch = []
        while self._pending and len(batch) < self.max_batch:
            p = self._pending.popleft()
            if p.deadline is not None and now >= p.deadline:
                if self._m_expired is not None:
                    self._m_expired.inc()
                p.future.set_exception(DeadlineExceeded(
                    f"deadline expired {now - p.deadline:.3f}s before "
                    f"compute (queued {now - p.t_enqueue:.3f}s)"))
                continue
            batch.append(p)
        return batch

    def _flush(self, batch: list, now: float) -> None:
        try:
            with self.exec_lock:
                self._compute(batch, now)
        finally:
            with self._lock:
                self._executing -= len(batch)

    def _compute(self, batch: list, now: float) -> None:
        if not batch:
            return
        if self._m_wait is not None:
            for p in batch:
                self._m_wait.observe((now - p.t_enqueue) * 1000.0)
        tr = _get_tracer()
        if tr is not None:
            # queue wait is retrospective: one back-dated span a row
            t1 = tr.clock()
            for p in batch:
                args = {"rows": len(batch)}
                if p.rid is not None:
                    args["rid"] = p.rid
                tr.record("queue_wait", t1 - max(now - p.t_enqueue, 0.0),
                          t1, depth=0, args=args)
        rt = _get_reqtracer()
        if rt is not None:
            for p in batch:
                if p.rid is not None:
                    rt.note_dequeued(p.rid)
        rids = None
        if rt is not None and self._fn_takes_rids:
            rids = [p.rid for p in batch]
        try:
            with _obs_span("batch_assembly", rows=len(batch)):
                stacked = np.stack([np.asarray(p.row) for p in batch])
            with _obs_span("compute", rows=len(batch)):
                if rids is not None:
                    scores = self.predict_fn(stacked, rids=rids)
                else:
                    t0c = rt.clock() if rt is not None else 0.0
                    scores = self.predict_fn(stacked)
                    if rt is not None:
                        t1c = rt.clock()
                        for p in batch:
                            if p.rid is not None:
                                rt.note_compute(p.rid, t0c, t1c)
        except BaseException as e:  # resolve every waiter, never hang them
            for p in batch:
                p.future.set_exception(e)
            if getattr(e, "worker_fatal", False):
                raise  # fatal to the worker: die so submits fast-fail
            return
        if self._m_flushes is not None:
            self._m_flushes.inc()
        for p, s in zip(batch, np.asarray(scores)):
            p.future.set_result(s)

    def pump(self, now: Optional[float] = None) -> int:
        """Flush at most one micro-batch if a trigger fired; returns the
        rows settled (flushed or expired)."""
        now = self.clock() if now is None else now
        with self._lock:
            if not self._flush_ready(now):
                return 0
            depth0 = len(self._pending)
            batch = self._drain(now)
            settled = depth0 - len(self._pending)
            self._executing += len(batch)
        self._flush(batch, now)  # outside the lock: submits stay wait-free
        return settled

    # --------------------------------------------------------------- worker
    def _worker(self) -> None:
        try:
            while True:
                with self._lock:
                    self._last_beat = self.clock()
                    while not self._pending and not self._closed:
                        self._wakeup.wait()
                        self._last_beat = self.clock()
                    if self._closed and not self._pending:
                        return
                    now = self.clock()
                    if not self._flush_ready(now):
                        head = self._pending[0]
                        wake = head.t_enqueue + self.max_wait_s
                        if head.deadline is not None:
                            wake = min(wake, head.deadline)
                        self._wakeup.wait(timeout=max(wake - now, 0.0))
                        continue
                    batch = self._drain(now)
                    self._executing += len(batch)
                    self._in_flush = True
                try:
                    self._flush(batch, self.clock())
                finally:
                    self._in_flush = False
        except BaseException as e:
            # the worker is the only drain: fail every waiter, and let
            # submit() fast-fail from here on
            self.declare_dead(e)

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work and settle every pending row: flushed by a
        live worker (or here, without one), or failed with
        :class:`WorkerDied` when the worker is dead or wedged."""
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                self.declare_dead(WorkerDied(
                    f"worker did not drain within {timeout}s at close"))
                return
        if self._worker_error is not None:
            self.declare_dead(self._worker_error)
            return
        while self._pending:
            with self._lock:
                batch = self._drain(self.clock())
                self._executing += len(batch)
            self._flush(batch, self.clock())
