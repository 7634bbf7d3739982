"""Host and device staging on a thread of its own (counterpart of
``bigdl_tpu/dataset/pipeline/staging.py``).

While the card runs step N, a staging thread prepares batch N+1:

* ``stage="host"``: the thread copies each batch into pinned host memory
  (page-locked, so the loop's copy to the card is a plain DMA that does
  not block the thread that issues it). The pinned blocks come from
  PyTorch's pinned-memory cache: each is allocated once and handed out
  again only after every copy that read it has completed (the cache
  records an event for each asynchronous copy), so a block the card still
  reads is never overwritten. Without CUDA there is nothing to pin, and
  the thread only prepares batches ahead, as the JAX package's ``host``
  does.
* ``stage="device"``: the thread also issues the copy to the card on a
  side CUDA stream of its own and records an event after it. Batches
  arrive as :class:`DeviceBatch`; the consumer's stream waits on the
  event (:meth:`DeviceBatch.claim`) and the tensors are marked as used by
  that stream (``record_stream``), so their memory is not handed to the
  next batch before the consumer's work is done. The seconds the thread
  spends issuing a batch's copy ride on it (``DeviceBatch.h2d_s``: the
  JAX package's ``h2d`` span), and the Optimizer adds them to its
  ``h2d_staged`` phase. Without CUDA, ``device`` raises.

Backpressure is a bounded queue of ``depth`` batches; shutdown drains until
the producer THREAD exits (an empty-queue check alone races a producer
blocked in ``put()``), and an exception on the thread is raised in the
consumer.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import DataSet, MiniBatch

__all__ = ["DeviceBatch", "StagedDataSet", "staged_batches", "make_put_fn",
           "pin_batch", "STAGE_CHOICES"]

logger = logging.getLogger("bigdl_tpu_torch")

STAGE_CHOICES = ("off", "host", "device")

_DONE = object()


def _leaves_map(fn, y):
    if isinstance(y, (tuple, list)):
        return type(y)(_leaves_map(fn, t) for t in y)
    return fn(y)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


class DeviceBatch:
    """An (input, target) pair already on the card, its copy issued on a
    staging stream: ``ready`` is the event recorded after that copy,
    ``h2d_s`` the host seconds the staging thread spent issuing it. Use
    :meth:`claim` before reading the tensors on another stream. Iterates
    like a MiniBatch."""

    __slots__ = ("input", "target", "ready", "h2d_s")

    def __init__(self, input: Any, target: Any,
                 ready: Optional[torch.cuda.Event] = None,
                 h2d_s: float = 0.0):
        self.input = input
        self.target = target
        self.ready = ready
        self.h2d_s = h2d_s

    def __iter__(self):
        yield self.input
        yield self.target

    @property
    def size(self) -> int:
        return len(self.input)

    def claim(self, stream: Optional[torch.cuda.Stream] = None):
        """(x, y) for use on ``stream`` (the current stream by default):
        the stream waits for the staging copy, and the tensors' memory is
        kept until the work the stream has queued is done."""
        if stream is None:
            stream = torch.cuda.current_stream(self.input.device)
        if self.ready is not None:
            stream.wait_event(self.ready)

        def mark(t):
            t.record_stream(stream)
            return t

        _leaves_map(mark, self.input)
        _leaves_map(mark, self.target)
        return self.input, self.target


def pin_batch(x, y):
    """An (x, y) batch (arrays or CPU tensors, y one or a tuple) in pinned
    host memory: leaves already pinned as they are, the others copied into
    blocks of PyTorch's pinned-memory cache."""
    def pin(a):
        t = _as_tensor(a)
        if t.is_pinned():
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    return pin(x), _leaves_map(pin, y)


def make_put_fn(device=None) -> Callable:
    """The host-to-card commit of one (x, y) batch: pinned copies, then
    copies to ``device`` (default: the current CUDA device) issued on a
    side stream, returning a :class:`DeviceBatch`. Raises without CUDA."""
    from bigdl_tpu_torch.core.module import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"--stage device stages batches on a CUDA device, "
                         f"not {dev}")
    stream = torch.cuda.Stream(dev)

    def put(x, y):
        t0 = time.perf_counter()
        px, py = pin_batch(x, y)
        with torch.cuda.stream(stream):
            to = lambda t: t.to(dev, non_blocking=True)  # noqa: E731
            dx, dy = to(px), _leaves_map(to, py)
            ready = torch.cuda.Event()
            ready.record(stream)
        return DeviceBatch(dx, dy, ready, time.perf_counter() - t0)

    return put


def staged_batches(batches, put_fn: Optional[Callable] = None,
                   depth: int = 2, stage: str = "device",
                   join_timeout: float = 5.0) -> Iterator:
    """Drive ``batches`` (any (x, y) iterable) through a staging thread.

    ``stage="host"``: prepare ahead, into pinned memory where CUDA is
    available; ``stage="device"``: commit each batch with ``put_fn``
    (default :func:`make_put_fn`) on the staging thread, yielding
    :class:`DeviceBatch`; ``stage="off"``: passthrough, no thread."""
    if stage not in STAGE_CHOICES:
        raise ValueError(f"stage must be one of {STAGE_CHOICES}, "
                         f"got {stage!r}")
    if stage == "off":
        yield from batches
        return
    if stage == "device":
        put = put_fn if put_fn is not None else make_put_fn()
    elif torch.cuda.is_available():
        put = lambda x, y: MiniBatch(*pin_batch(x, y))  # noqa: E731
    else:
        put = None
    q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
    err: list = []
    stop = threading.Event()  # set when the consumer abandons the stream

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for mb in batches:
                if put is not None:
                    x, y = mb
                    mb = put(x, y)
                if not offer(mb):
                    return  # consumer gone: unwind, don't block forever
        except BaseException as e:  # raised on the consumer side
            err.append(e)
        finally:
            offer(_DONE)

    t = threading.Thread(target=produce, daemon=True, name="bigdl-stage")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            yield item
    finally:
        stop.set()
        # drain until the THREAD exits, not until the queue momentarily
        # looks empty: the producer can refill between an empty-check and
        # the join
        deadline = time.monotonic() + join_timeout
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        if t.is_alive():
            logger.warning(
                "staging: producer thread failed to exit within %.1fs (the "
                "wrapped feed or a copy is stuck)", join_timeout)
    if err:
        raise err[0]


class StagedDataSet(DataSet):
    """DataSet front over :func:`staged_batches`: what ``--stage`` wraps
    around the executor (or any feed). ``stage="device"`` resolves its
    device when built, so a machine without CUDA refuses it at once."""

    def __init__(self, inner: DataSet, stage: str = "device",
                 depth: int = 2, put_fn: Optional[Callable] = None,
                 device=None):
        if stage not in STAGE_CHOICES:
            raise ValueError(f"stage must be one of {STAGE_CHOICES}, "
                             f"got {stage!r}")
        self.inner = inner
        self.stage = stage
        self.depth = max(1, int(depth))
        if stage == "device" and put_fn is None:
            put_fn = make_put_fn(device)
        self._put_fn = put_fn

    @property
    def plan(self):
        """The wrapped executor's epoch plan (the checkpoint driver blob
        stamps its signature through this)."""
        return getattr(self.inner, "plan", None)

    def __iter__(self) -> Iterator:
        yield from staged_batches(iter(self.inner), put_fn=self._put_fn,
                                  depth=self.depth, stage=self.stage)

    def size(self) -> int:
        return self.inner.size()

    def shuffle(self, seed: Optional[int] = None) -> None:
        self.inner.shuffle(seed)

    def skip_epoch(self) -> None:
        self.inner.skip_epoch()

    def signature(self) -> dict:
        sig = {"stage": self.stage, "depth": self.depth}
        inner_sig = getattr(self.inner, "signature", None)
        if inner_sig is not None:
            sig.update(inner_sig())
        return sig
