"""Host-side prefetching (counterpart of ``bigdl_tpu/dataset/prefetch.py``):
overlap batch preparation with the card's compute.

The reference overlaps JPEG decode with training through
MTLabeledBGRImgToBatch (image/MTLabeledBGRImgToBatch.scala:48-133). The
port has two layers for it: the C++ prefetcher (``NativePrefetchDataSet``)
for in-memory raw images, and this :class:`PrefetchDataSet`, which wraps
ANY DataSet in a background thread and a bounded queue. While the card
runs step N, the host prepares batches N+1..N+depth. Python threads are
enough: the wrapped pipeline's hot work (native decode, numpy) releases
the GIL, and the training thread waits on the card most of the time.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, Optional

from bigdl_tpu_torch.dataset.dataset import DataSet

__all__ = ["PrefetchDataSet"]

logger = logging.getLogger("bigdl_tpu_torch")

_DONE = object()


class PrefetchDataSet(DataSet):
    """``PrefetchDataSet(inner, depth=2)`` — iterate ``inner`` on a daemon
    thread, handing batches over a bounded queue (depth = max batches
    prepared ahead). Exceptions in the producer re-raise in the consumer.
    """

    def __init__(self, inner: DataSet, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.inner = inner
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        stop = threading.Event()  # set when the consumer abandons the epoch

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self.inner:
                    if not put(item):
                        return  # consumer gone: unwind, don't block forever
            except BaseException as e:  # raised on the consumer side
                err.append(e)
            finally:
                put(_DONE)

        t = threading.Thread(target=produce, daemon=True,
                             name="bigdl-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                yield item
        finally:
            # normal exhaustion AND early exit (break / GeneratorExit):
            # release the producer if it is blocked on a full queue.
            # Drain until the THREAD exits — a single empty-queue sweep
            # races a producer blocked in put(), which can refill the
            # queue between the emptiness check and the join and leak
            # the daemon thread past the timeout.
            stop.set()
            deadline = time.monotonic() + 5.0
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
            if t.is_alive():
                logger.warning(
                    "prefetch: producer thread failed to exit within 5s "
                    "(the wrapped dataset is stuck mid-batch)")
        if err:
            raise err[0]

    def size(self) -> int:
        return self.inner.size()

    def shuffle(self, seed: Optional[int] = None) -> None:
        self.inner.shuffle(seed)

    def skip_epoch(self) -> None:
        self.inner.skip_epoch()
