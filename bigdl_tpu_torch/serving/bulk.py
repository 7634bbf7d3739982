"""Offline bulk inference: the checkpointable, sharded batch-scoring job
behind ``batch-predict`` (counterpart of ``bigdl_tpu/serving/bulk.py``;
numpy and the standard library only, as there).

Batch scoring was BigDL's bread-and-butter workload (RDD-fed model
evaluation fanned across executors, arxiv 1804.05839). Here it composes
layers the port has: the ``dataset/pipeline`` executor (N workers, a
deterministic :class:`EpochPlan`, optional device staging) feeds the
bucketed :class:`~bigdl_tpu_torch.serving.engine.InferenceEngine`
forwards, ``--strategy dp[:N]`` fans batches round-robin across engine
replicas, and outputs append to a sharded, order-reconstructible JSONL
sink.

Determinism and resume contract:

* the record order is the ``EpochPlan``'s (``shuffle=False``): batch
  ordinal ``s`` covers ``plan.batch_indices(0)[s]`` and always lands in
  output shard ``s % n_groups``; the global order comes back by sorting
  merged lines on ``"i"``;
* a cursor (``cursor.json``, written atomically through tmp+rename at
  drain barriers every ``checkpoint_every`` batches) records the feed's
  signature, the first unscored batch ordinal, and every shard's byte
  offset;
* resume checks the signature (a changed feed is an error, not a silent
  rescore), truncates each shard to its checkpointed offset (dropping
  lines written after the last barrier), and skips ordinals below the
  watermark: kill and resume give output byte-identical to an
  uninterrupted run, no record scored twice or dropped.

Phase attribution follows the training perf loop (``cli/perf.py``):
``data_wait`` is time blocked on the feed, ``dispatch`` time blocked
handing a batch to a scoring worker, ``device`` the summed engine forward
wall, so the batch-predict report carries the same ``stall_frac``
column.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ShardSink", "load_cursor", "save_cursor", "run_bulk",
           "shard_paths", "merge_shards"]

CURSOR_FILE = "cursor.json"


def shard_paths(out_dir: str, n_groups: int) -> List[str]:
    return [os.path.join(out_dir,
                         f"scores-{g:05d}-of-{n_groups:05d}.jsonl")
            for g in range(n_groups)]


class ShardSink:
    """One append-mode JSONL output shard with byte-offset resume.

    Lines are rendered deterministically (``sort_keys``, plain ``repr``
    floats) so byte-identity across kill+resume reduces to scoring
    determinism. ``resume_offset`` truncates the file to the last
    checkpointed byte before appending — lines written after the final
    barrier of a killed run are discarded, never duplicated."""

    def __init__(self, path: str, resume_offset: Optional[int] = None):
        self.path = path
        if resume_offset is not None and os.path.exists(path):
            with open(path, "r+b") as f:
                f.truncate(int(resume_offset))
        else:
            open(path, "wb").close()
        self._f = open(path, "ab")
        self.offset = os.path.getsize(path)
        self.lines = 0

    def write_batch(self, indices, preds,
                    scores: Optional[np.ndarray] = None) -> int:
        rows = []
        for j, i in enumerate(indices):
            d: dict = {"i": int(i), "pred": int(preds[j])}
            if scores is not None:
                d["scores"] = [float(v) for v in
                               np.asarray(scores[j], np.float64)]
            rows.append(json.dumps(d, sort_keys=True))
        data = ("\n".join(rows) + "\n").encode()
        self._f.write(data)
        self.offset += len(data)
        self.lines += len(rows)
        return len(rows)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


# ------------------------------------------------------------------ cursor
def load_cursor(out_dir: str) -> Optional[dict]:
    path = os.path.join(out_dir, CURSOR_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_cursor(out_dir: str, signature: dict, next_batch: int,
                offsets: Sequence[int], records_done: int) -> None:
    """Atomic (tmp+rename) cursor write — a kill mid-write leaves the
    previous cursor intact, never a torn one."""
    path = os.path.join(out_dir, CURSOR_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"signature": signature,
                   "next_batch": int(next_batch),
                   "offsets": [int(o) for o in offsets],
                   "records_done": int(records_done)}, f,
                  sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def merge_shards(out_dir: str) -> List[dict]:
    """All shard lines merged back into plan-record order (sorted on
    ``"i"``) — the order-reconstruction half of the sink contract."""
    rows: List[dict] = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("scores-") and name.endswith(".jsonl"):
            with open(os.path.join(out_dir, name)) as f:
                rows.extend(json.loads(ln) for ln in f if ln.strip())
    rows.sort(key=lambda d: d["i"])
    return rows


# ------------------------------------------------------------------ runner
class _Group:
    """One scoring group: an engine, its output shard, and the worker
    thread that drains this group's batch queue."""

    def __init__(self, index: int, engine, sink: ShardSink):
        self.index = index
        self.engine = engine
        self.sink = sink
        self.queue: queue.Queue = queue.Queue(maxsize=2)
        self.device_s = 0.0
        self.records = 0
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None

    def start(self, scores: bool) -> None:
        def _work():
            while True:
                item = self.queue.get()
                try:
                    if item is None:
                        return
                    if self.error is None:  # after a failure keep
                        indices, x = item   # draining (task_done) so
                        t0 = time.perf_counter()  # barriers never hang
                        y = np.asarray(self.engine.predict_scores(x))
                        self.device_s += time.perf_counter() - t0
                        preds = np.argmax(y, axis=-1)
                        self.records += self.sink.write_batch(
                            indices, preds, y if scores else None)
                except BaseException as e:  # surfaced by the dispatcher
                    self.error = e
                finally:
                    self.queue.task_done()

        self.thread = threading.Thread(
            target=_work, name=f"bulk-score-{self.index}", daemon=True)
        self.thread.start()

    def join(self) -> None:
        self.queue.put(None)
        if self.thread is not None:
            self.thread.join()


def run_bulk(engines: Sequence, feed, signature: dict, out_dir: str, *,
             scores: bool = False, checkpoint_every: int = 32,
             phase: Optional[Dict[str, float]] = None,
             on_batch: Optional[Callable[[int], None]] = None) -> dict:
    """Drive ``feed`` through ``engines`` into the sharded sink.

    ``feed`` yields ``(ordinal, indices, x)`` — the global batch
    ordinal, the plan's record indices for that batch, and the input
    rows (host or device array). Batch ``ordinal`` is scored by engine
    ``ordinal % len(engines)`` and written to that group's shard.
    ``signature`` is the deterministic feed identity (plan signature +
    scoring config) the resume path validates. ``phase`` is an optional
    perf-style accumulator dict (``data_wait``/``dispatch``/``device``
    keys are added); ``on_batch`` is a per-dispatch hook (capture
    windows, progress).

    Returns the report dict: record/batch counts, resume watermark, and
    shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    n_groups = len(engines)
    paths = shard_paths(out_dir, n_groups)

    cursor = load_cursor(out_dir)
    next_batch = 0
    records_done = 0
    if cursor is not None:
        if cursor.get("signature") != signature:
            raise ValueError(
                f"resume refused: {out_dir}/{CURSOR_FILE} was written "
                f"for a different feed\n  cursor:  "
                f"{json.dumps(cursor.get('signature'), sort_keys=True)}"
                f"\n  current: {json.dumps(signature, sort_keys=True)}")
        if len(cursor.get("offsets", [])) != n_groups:
            raise ValueError(
                f"resume refused: cursor has "
                f"{len(cursor.get('offsets', []))} shards, run has "
                f"{n_groups} (changed --strategy?)")
        next_batch = int(cursor["next_batch"])
        records_done = int(cursor.get("records_done", 0))
        logger.info("resuming batch-predict at batch %d (%d records "
                    "already scored)", next_batch, records_done)
    resumed_from = next_batch

    groups = [_Group(g, engines[g],
                     ShardSink(paths[g],
                               resume_offset=(cursor["offsets"][g]
                                              if cursor else None)))
              for g in range(n_groups)]
    for grp in groups:
        grp.start(scores)

    def _barrier() -> None:
        for grp in groups:
            grp.queue.join()
            if grp.error is not None:
                raise grp.error
            grp.sink.flush()

    pc = time.perf_counter
    ph = phase if phase is not None else {}
    for k in ("data_wait", "dispatch", "device"):
        ph.setdefault(k, 0.0)
    dispatched = 0
    total_batches = 0
    try:
        it = iter(feed)
        while True:
            t = pc()
            try:
                ordinal, indices, x = next(it)
            except StopIteration:
                break
            ph["data_wait"] += pc() - t
            total_batches = max(total_batches, ordinal + 1)
            if ordinal < next_batch:
                continue  # already scored before the kill
            if on_batch is not None:
                on_batch(ordinal)
            t = pc()
            grp = groups[ordinal % n_groups]
            while True:
                if grp.error is not None:  # dead worker: fail fast,
                    raise grp.error        # never block on a full queue
                try:
                    grp.queue.put((np.asarray(indices), x), timeout=1.0)
                    break
                except queue.Full:
                    continue
            ph["dispatch"] += pc() - t
            dispatched += 1
            records_done += len(indices)
            if dispatched % max(1, checkpoint_every) == 0:
                _barrier()
                save_cursor(out_dir, signature, ordinal + 1,
                            [grp.sink.offset for grp in groups],
                            records_done)
        _barrier()
        save_cursor(out_dir, signature, total_batches,
                    [grp.sink.offset for grp in groups], records_done)
    finally:
        for grp in groups:
            grp.join()
            grp.sink.close()
    for grp in groups:
        if grp.error is not None:
            raise grp.error
    ph["device"] += sum(grp.device_s for grp in groups)
    return {"records": records_done,
            "batches": total_batches,
            "batches_scored_this_run": dispatched,
            "resumed_from_batch": resumed_from,
            "groups": n_groups,
            "shards": paths,
            "shard_lines": [grp.sink.lines for grp in groups]}
