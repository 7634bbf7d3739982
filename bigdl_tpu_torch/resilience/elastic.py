"""Elastic data parallelism: survive the loss of ranks and re-form
(counterpart of ``bigdl_tpu/resilience/elastic.py``; the reference's
``DistriOptimizer`` outlives executor loss because Spark re-forms the job).

* On a :class:`DeviceLossFault` the :class:`ElasticSupervisor` retries: the
  next attempt re-probes ``faults.healthy_devices()`` (the surviving
  ranks), re-forms the data axis over them (``parallel.make_mesh(axes,
  devices)``, a ``new_group`` of the survivors; a lost rank leaves the
  job with exit code 0), rebuilds the strategy (the gradient bucket bound
  is resolved again through the tuner, whose ``grad_comm`` key holds
  ``n_devices``) and resumes from the newest valid checkpoint pair, whose
  blobs hold whole tensors (resharding is a placement).
* The global batch is held (``--elastic hold``: padded with wrap-around
  rows to the next multiple of the surviving count) or scaled (``--elastic
  scale``: trimmed to divisibility) by :class:`ElasticDataParallel`, on
  the global batch, before each rank takes its rows.
* Fewer than ``--minDevices`` survivors is a clean
  :class:`SupervisorGaveUp`.
* Every reshape is recorded (from/to counts, ``restore_ms``, the bucket
  bound before and after), published as ``elastic_reshapes_total`` and
  ``elastic_devices`` on the process registry and as a ``reshape`` span
  instant, and stamped into ``cli.perf``'s line as ``reshape``.

What is bit-identical across a reshape: the restored parameters and
optimizer state. What is not: the loss after it under ``hold`` (padded
rows enter the batch mean), and any step at another rank count (the
reduction orders differ).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.parallel.data_parallel import DataParallel
from bigdl_tpu_torch.resilience.faults import DeviceLossFault, healthy_devices
from bigdl_tpu_torch.resilience.supervisor import (RETRYABLE_EXCEPTIONS,
                                                   RetryPolicy, Supervisor,
                                                   SupervisorGaveUp)

logger = logging.getLogger(__name__)

__all__ = ["ELASTIC_POLICIES", "ElasticDataParallel", "ElasticSupervisor"]

# --elastic choices: `hold` keeps every real row and pads to divisibility
# (the global batch is a training hyperparameter); `scale` trims rows so
# the per-rank batch stays constant
ELASTIC_POLICIES = ("hold", "scale")


class ElasticSupervisor(Supervisor):
    """A :class:`Supervisor` that retries device loss and keeps the
    reshape ledger. The attempt callable calls ``probe()`` first (the
    healthy roster, or :class:`SupervisorGaveUp` below ``min_devices``),
    then ``observe_topology(n_devices, ...)`` once its strategy is built:
    the first call records the baseline, and the first call after a
    caught :class:`DeviceLossFault` closes out a reshape event."""

    def __init__(self, policy: Optional[RetryPolicy] = None, *,
                 min_devices: int = 1, batch_policy: str = "hold",
                 name: str = "elastic", **kwargs):
        if batch_policy not in ELASTIC_POLICIES:
            raise ValueError(f"unknown --elastic policy {batch_policy!r} "
                             f"(choices: {', '.join(ELASTIC_POLICIES)})")
        if min_devices < 1:
            raise ValueError(f"--minDevices must be >= 1, got {min_devices}")
        retryable = tuple(kwargs.pop("retryable", RETRYABLE_EXCEPTIONS))
        if DeviceLossFault not in retryable:
            retryable = retryable + (DeviceLossFault,)
        super().__init__(policy, retryable=retryable, name=name, **kwargs)
        self.min_devices = int(min_devices)
        self.batch_policy = batch_policy
        self.reshapes: List[dict] = []
        self._last_seen: Optional[dict] = None
        self._pending_loss: Optional[str] = None

    def probe(self) -> list:
        """The surviving roster for this attempt. Below ``min_devices``
        this raises :class:`SupervisorGaveUp`, which ``run()`` does not
        retry."""
        devs = healthy_devices()
        if len(devs) < self.min_devices:
            raise SupervisorGaveUp(
                f"{len(devs)} healthy device(s) < --minDevices "
                f"{self.min_devices} — cannot re-form a viable mesh",
                self.annotation()["events"])
        return devs

    def observe_topology(self, n_devices: int,
                         bucket_bytes: Optional[int] = None,
                         restore_ms: Optional[float] = None) -> None:
        """Record the topology an attempt built; closes out a pending
        reshape (a device loss was caught since the last call)."""
        prev, self._last_seen = self._last_seen, {
            "n_devices": int(n_devices),
            "bucket_bytes": (int(bucket_bytes)
                             if bucket_bytes is not None else None)}
        try:  # the process registry backs the live /metrics endpoint
            from bigdl_tpu_torch.obs.metrics import get_registry
            get_registry().gauge(
                "elastic_devices",
                "devices in the current elastic mesh").set(int(n_devices))
        except Exception:
            pass  # observability must never break recovery
        if self._pending_loss is None or prev is None:
            return
        ev = {"event": "reshape",
              "from_devices": prev["n_devices"],
              "to_devices": int(n_devices),
              "restore_ms": (round(float(restore_ms), 3)
                             if restore_ms is not None else None),
              "bucket_bytes_before": prev["bucket_bytes"],
              "bucket_bytes_after": self._last_seen["bucket_bytes"]}
        self.reshapes.append(ev)
        self.events.append(dict(ev))
        self._pending_loss = None
        try:
            from bigdl_tpu_torch.obs.metrics import get_registry
            get_registry().counter(
                "elastic_reshapes_total",
                "mesh re-formations after device loss").inc()
        except Exception:
            pass
        try:  # the reshape at its place on the span timeline
            from bigdl_tpu_torch.obs.spans import instant
            instant("reshape", from_devices=ev["from_devices"],
                    to_devices=ev["to_devices"],
                    restore_ms=ev["restore_ms"])
        except Exception:
            pass
        logger.info("elastic[%s]: reshaped %d -> %d devices "
                    "(restore %.1f ms, bucket %s -> %s)", self.name,
                    ev["from_devices"], ev["to_devices"],
                    ev["restore_ms"] or 0.0, ev["bucket_bytes_before"],
                    ev["bucket_bytes_after"])

    def run(self, attempt_fn):
        def wrapped(attempt: int):
            try:
                return attempt_fn(attempt)
            except DeviceLossFault as e:
                self._pending_loss = str(e)
                raise

        return super().run(wrapped)

    def reshape_annotation(self) -> Optional[dict]:
        """The ``reshape`` dict of ``cli.perf``'s line: the newest reshape
        and the count, or None when the topology never changed."""
        if not self.reshapes:
            return None
        last = {k: v for k, v in self.reshapes[-1].items() if k != "event"}
        last["count"] = len(self.reshapes)
        return last

    def annotation(self) -> dict:
        out = super().annotation()
        out["reshapes"] = len(self.reshapes)
        out["min_devices"] = self.min_devices
        out["batch_policy"] = self.batch_policy
        return out


class ElasticDataParallel(DataParallel):
    """:class:`DataParallel` whose batch placement takes a global batch the
    (post-loss) rank count does not divide: ``hold`` pads it with
    wrap-around copies of its leading rows to the next multiple, ``scale``
    trims its trailing rows to divisibility. Both are the identity when
    the batch divides, so at full topology this is :class:`DataParallel`
    bit for bit."""

    def __init__(self, mesh=None, axis: str = "data",
                 batch_policy: str = "hold", **kwargs):
        if batch_policy not in ELASTIC_POLICIES:
            raise ValueError(
                f"unknown --elastic policy {batch_policy!r} "
                f"(choices: {', '.join(ELASTIC_POLICIES)})")
        super().__init__(mesh, axis, **kwargs)
        self.batch_policy = batch_policy

    def _fit_rows(self, arr):
        """``arr`` (numpy array or tensor) padded or trimmed along dim 0."""
        n = int(self.mesh.shape[self.axis])
        b = int(arr.shape[0])
        if n <= 1 or b % n == 0:
            return arr
        if self.batch_policy == "hold":
            per = -(-b // n)  # ceil
            idx = np.arange(per * n - b) % b
            if isinstance(arr, np.ndarray):
                return np.concatenate([arr, arr[idx]], axis=0)
            import torch
            return torch.cat([arr, arr[torch.from_numpy(idx).to(
                arr.device)]], dim=0)
        keep = (b // n) * n
        if keep == 0:
            raise ValueError(
                f"batch of {b} rows cannot be scaled onto {n} "
                f"devices (fewer rows than devices)")
        return arr[:keep]

    def _fit(self, y):
        if isinstance(y, (tuple, list)):
            return type(y)(self._fit(t) for t in y)
        return self._fit_rows(y if hasattr(y, "shape") else np.asarray(y))

    def shard_batch(self, x, y, rank_local: bool = False):
        """This rank's rows of the global batch after the policy's fit; a
        rank-local batch is not fitted (each rank's feed sized it)."""
        if rank_local:
            return super().shard_batch(x, y, rank_local=True)
        return super().shard_batch(self._fit(x), self._fit(y))
