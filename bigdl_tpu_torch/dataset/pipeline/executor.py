"""Parallel decode/augment executor (counterpart of
``bigdl_tpu/dataset/pipeline/executor.py``).

The reference's MTLabeledBGRImgToBatch (image/MTLabeledBGRImgToBatch.
scala:48-133) has coreNumber cloned transformer pipelines race on an
atomic batch counter and write into preallocated per-batch buffers. Here
a pool of N worker THREADS races an atomic sample-ticket counter over an
:class:`EpochPlan`'s schedule (threads suffice because the per-sample
work, libjpeg or PIL decode and the native augment, releases the GIL),
and the consumer hands batches out strictly in submission order.

Determinism contract:

* which sample lands in batch ``b`` slot ``i`` is fixed by the plan (pure
  in ``(seed, epoch)``), not by thread scheduling;
* any per-sample randomness derives from ``(seed, epoch, index)``
  (:func:`~bigdl_tpu_torch.dataset.pipeline.plan.sample_rng`), not from a
  shared generator;

so the assembled batch stream is bit-identical for any worker count and
under kill and resume (the Optimizer replays ``shuffle()`` once per
finished epoch and skips the consumed head of the open one).

Backpressure: a worker may not claim a ticket more than ``depth`` batches
past the last consumed batch, so at most ``depth`` batches of samples
exist at once (``stats["max_inflight"]`` shows the bound). A worker's
exception is raised in the consumer, and a consumer that stops early (or
raises) joins the pool before its generator closes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.dataset.pipeline.plan import EpochPlan

__all__ = ["SampleSource", "ArraySampleSource", "StreamingSampleSource",
           "ExecutorDataSet", "as_executor"]

logger = logging.getLogger("bigdl_tpu_torch")


class SampleSource:
    """What the executor's workers pull samples from. ``load`` MUST be
    pure in ``(index, epoch)`` and thread-safe (workers call it
    concurrently) — that purity is the whole determinism contract."""

    def __len__(self) -> int:
        raise NotImplementedError

    def load(self, index: int, epoch: int):
        """Return one sample ``(x, y)`` for dataset index ``index`` of
        epoch ``epoch`` (the epoch feeds per-sample augmentation seeds)."""
        raise NotImplementedError

    def collate(self, samples: list) -> MiniBatch:
        """Assemble one ordered slot list into a MiniBatch."""
        xs = [s[0] for s in samples]
        ys = [s[1] for s in samples]
        x = np.stack(xs)
        if isinstance(ys[0], (np.ndarray, np.generic)):
            y = np.stack(ys)
        else:
            y = np.asarray(ys, np.int32)
        return MiniBatch(x, y)

    def signature(self) -> dict:
        return {"source": type(self).__name__, "n": len(self)}


class ArraySampleSource(SampleSource):
    """In-memory (features, labels) arrays — the BatchDataSet /
    ShardedDataSet payload behind an executor front."""

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        assert len(features) == len(labels)
        self.features, self.labels = features, labels

    def __len__(self) -> int:
        return len(self.features)

    def load(self, index: int, epoch: int):
        return self.features[index], self.labels[index]


class StreamingSampleSource(SampleSource):
    """Adapter over a ``_StreamingImageBase`` (RecordImageDataSet /
    StreamingImageFolder): delegates the per-sample decode+augment path
    (``_load_sample``, which already derives its RNG from
    ``(seed, epoch, index)``), so an executor-fed record stream is
    bit-identical to the legacy window feed on the same schedule."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self) -> int:
        return self.ds._num_samples()

    def load(self, index: int, epoch: int):
        return self.ds._load_sample(int(index), int(epoch))

    def collate(self, samples: list) -> MiniBatch:
        # exactly _StreamingImageBase.__iter__'s assembly
        x = np.stack([s[0] for s in samples])
        y = np.asarray([s[1] for s in samples], np.int32)
        return MiniBatch(x, y)

    def signature(self) -> dict:
        sig = {"source": type(self.ds).__name__, "n": len(self)}
        crop = getattr(self.ds, "crop", None)
        if crop is not None:
            sig["crop"] = list(crop)
            sig["train"] = bool(getattr(self.ds, "train", False))
        return sig


class ExecutorDataSet(DataSet):
    """``ExecutorDataSet(source, batch_size, workers=4, depth=2)``: the
    multi-threaded feed in place of the single-threaded PrefetchDataSet.

    DataSet contract: ``__iter__`` yields one epoch at the plan's CURRENT
    epoch without advancing it; ``shuffle()`` advances (ShardedDataSet
    semantics), which is what the Optimizer's end-of-epoch call and
    resume replay rely on."""

    def __init__(self, source: SampleSource, batch_size: Optional[int] = None,
                 workers: int = 4, depth: int = 2, seed: int = 0,
                 shuffle: bool = True, mode: str = "global",
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 plan: Optional[EpochPlan] = None, join_timeout: float = 5.0):
        if plan is None:
            if batch_size is None:
                raise ValueError("ExecutorDataSet needs batch_size (or an "
                                 "explicit plan)")
            plan = EpochPlan(len(source), batch_size, seed=seed,
                             shuffle=shuffle, mode=mode,
                             process_index=process_index,
                             process_count=process_count)
        self.source = source
        self.plan = plan
        self.workers = max(1, int(workers))
        self.depth = max(1, int(depth))
        self.join_timeout = float(join_timeout)
        # max_inflight proves the backpressure bound (<= depth);
        # join_timeouts counts shutdowns that leaked a worker thread
        self.stats = {"max_inflight": 0, "batches": 0, "join_timeouts": 0}

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> Iterator[MiniBatch]:
        epoch = int(self.plan.epoch)
        idx = self.plan.batch_indices(epoch)
        steps = int(idx.shape[0])
        if steps == 0:
            return
        bs = int(idx.shape[1])
        total = steps * bs
        depth = self.depth
        cond = threading.Condition()
        state = {"ticket": 0, "consumed": 0, "stop": False, "err": None}
        buffers: dict = {}  # batch -> fixed slot list (the ticket buffers)
        filled: dict = {}   # batch -> slots filled so far

        def work():
            try:
                while True:
                    with cond:
                        while True:
                            if state["stop"] or state["err"] is not None:
                                return
                            t = state["ticket"]
                            if t >= total:
                                return
                            b = t // bs
                            # backpressure: never more than `depth`
                            # batches past the consumer
                            if b - state["consumed"] < depth:
                                state["ticket"] = t + 1
                                break
                            cond.wait(0.1)
                        inflight = b - state["consumed"] + 1
                        if inflight > self.stats["max_inflight"]:
                            self.stats["max_inflight"] = inflight
                    sample = self.source.load(int(idx[b, t % bs]), epoch)
                    with cond:
                        slot = buffers.get(b)
                        if slot is None:
                            slot = buffers[b] = [None] * bs
                        slot[t % bs] = sample
                        filled[b] = filled.get(b, 0) + 1
                        if filled[b] == bs:
                            cond.notify_all()
            except BaseException as e:  # surfaced on the consumer side
                with cond:
                    if state["err"] is None:
                        state["err"] = e
                    cond.notify_all()

        threads = [threading.Thread(target=work, daemon=True,
                                    name=f"bigdl-pipe-w{i}")
                   for i in range(self.workers)]
        for t in threads:
            t.start()
        try:
            for b in range(steps):
                with cond:
                    while filled.get(b, 0) < bs and state["err"] is None:
                        cond.wait(0.1)
                    if state["err"] is not None:
                        raise state["err"]
                    samples = buffers.pop(b)
                    filled.pop(b, None)
                    state["consumed"] = b + 1
                    cond.notify_all()
                self.stats["batches"] += 1
                yield self.source.collate(samples)
        finally:
            # normal exhaustion AND early exit (break / GeneratorExit /
            # a raised worker error): unwind the pool
            with cond:
                state["stop"] = True
                cond.notify_all()
            deadline = time.monotonic() + self.join_timeout
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            leaked = [t.name for t in threads if t.is_alive()]
            if leaked:
                self.stats["join_timeouts"] += 1
                logger.warning(
                    "pipeline executor: %d worker thread(s) failed to exit "
                    "within %.1fs: %s (daemon threads — they cannot block "
                    "process exit, but a stuck sample source should be "
                    "investigated)", len(leaked), self.join_timeout, leaked)

    # ------------------------------------------------------------- DataSet
    def size(self) -> int:
        return len(self.source)

    def shuffle(self, seed: Optional[int] = None) -> None:
        self.plan.advance(seed)

    def skip_epoch(self) -> None:
        self.plan.advance()

    def signature(self) -> dict:
        """Pipeline provenance (``cli.perf``'s ``pipeline`` field)."""
        return {"workers": self.workers, "depth": self.depth,
                "plan": self.plan.signature(),
                **self.source.signature()}


def as_executor(ds, workers: int, depth: int = 2,
                seed: int = 0) -> Optional[ExecutorDataSet]:
    """Convert a known DataSet into its executor-fed equivalent, or None
    when the type carries no (source, plan) decomposition — callers fall
    back to the thread-wrapper prefetch for those."""
    from bigdl_tpu_torch.dataset.dataset import BatchDataSet
    from bigdl_tpu_torch.dataset.distributed import ShardedDataSet
    from bigdl_tpu_torch.dataset.streaming import _StreamingImageBase

    if isinstance(ds, ExecutorDataSet):
        ds.workers = max(1, int(workers))
        ds.depth = max(1, int(depth))
        return ds
    if isinstance(ds, _StreamingImageBase):
        if getattr(ds, "_batch_cap", None) is not None:
            # partitioned record sets cap batches at the smallest
            # partition — schedule lives outside the plan; keep legacy
            return None
        src = StreamingSampleSource(ds)
        plan = EpochPlan(len(src), ds.batch_size, seed=ds.seed,
                         shuffle=ds.train, process_index=0,
                         process_count=1, epoch=ds._epoch)
        return ExecutorDataSet(src, workers=workers, depth=depth, plan=plan)
    if isinstance(ds, ShardedDataSet):
        src = ArraySampleSource(ds.features, ds.labels)
        plan = EpochPlan(len(src), ds.local_batch, seed=ds._seed,
                         shuffle=ds._shuffle, mode="global",
                         process_index=ds.pi, process_count=ds.pc,
                         epoch=ds._epoch)
        return ExecutorDataSet(src, workers=workers, depth=depth, plan=plan)
    if isinstance(ds, BatchDataSet):
        src = ArraySampleSource(ds.features, ds.labels)
        plan = EpochPlan(len(src), ds.batch_size, seed=seed,
                         shuffle=ds._shuffle, process_index=0,
                         process_count=1)
        return ExecutorDataSet(src, workers=workers, depth=depth, plan=plan)
    return None
