"""Data-parallel engine replicas behind one front door (counterpart of
``bigdl_tpu/serving/replicas.py``).

``serve --strategy dp:N`` runs N independent engine stacks in one
process, each an engine, batcher and decoder on its own ``device`` with
its own CUDA graphs, and routes every request to the least-loaded live
replica:

* routing is deterministic: the least load (the batcher's queue depth for
  /predict, the decoder's active slots plus waiting queue for /generate),
  ties to the lowest replica index; the chosen index is stamped into the
  request's lifecycle record (``reqtrace.note_replica``). The server
  routes through :meth:`ReplicaSet.routed`, whose pick counts in its
  replica's load until the submit returns: a decoder's submit runs the
  prefill before its slot shows in ``queue_load``, so without that a
  burst that lands during one prefill would all pick the same replica;
* readiness is the fleet's: ``/readyz`` stays 200 while one replica
  lives, and its body names every dead one;
* shedding is the fleet's: /generate sheds only when every live replica
  is past the saturation fraction;
* each replica's components register their series against a labelled
  view (``replica="i"``); this module adds the unlabelled fleet
  aggregates ``replicas``, ``replicas_live``, ``kv_cache_bytes``,
  ``kv_pages_in_use`` and ``fleet_generated_tokens_total``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import List

from bigdl_tpu_torch.serving.batcher import WorkerDied

logger = logging.getLogger(__name__)

__all__ = ["Replica", "ReplicaSet"]


class Replica:
    """One dp replica: a full serving stack pinned to its own device
    group. Pure container + health/load accessors — construction (and
    the choice of which components exist) belongs to the caller."""

    def __init__(self, index: int, *, devices=None, mesh=None,
                 engine=None, batcher=None, decoder=None, watchdog=None,
                 metrics=None):
        self.index = int(index)
        self.name = f"r{self.index}"
        self.devices = list(devices) if devices is not None else []
        self.mesh = mesh
        self.engine = engine
        self.batcher = batcher
        self.decoder = decoder
        self.watchdog = watchdog
        self.metrics = metrics
        # requests routed here by ReplicaSet.routed whose submit has not
        # returned yet (guarded by the set's lock)
        self.routing = 0

    # ------------------------------------------------------------- health
    def alive(self) -> bool:
        """Every component this replica has is healthy. A replica with a
        dead batcher OR decoder is out of rotation entirely — half-alive
        replicas would make routing verdicts endpoint-dependent."""
        if self.watchdog is not None and not self.watchdog.ready():
            return False
        for comp in (self.batcher, self.decoder):
            if comp is not None and not comp.alive():
                return False
        return True

    def dead_components(self) -> List[str]:
        out = []
        if self.watchdog is not None and not self.watchdog.ready():
            out.extend(sorted(self.watchdog.failures))
        for nm, comp in (("batcher", self.batcher),
                         ("decoder", self.decoder)):
            if comp is not None and not comp.alive():
                out.append(nm)
        return out

    # --------------------------------------------------------------- load
    def predict_depth(self) -> int:
        return self.batcher.queue_depth if self.batcher is not None else 0

    def generate_load(self) -> int:
        return self.decoder.queue_load() if self.decoder is not None else 0

    def generate_saturated(self, frac: float) -> bool:
        """This replica's own tier-1 shed verdict — same predicate the
        single-replica server applies globally."""
        if (self.batcher is not None
                and self.batcher.queue_depth
                >= frac * self.batcher.max_queue):
            return True
        if (self.decoder is not None
                and len(self.decoder._waiting)
                >= frac * self.decoder.max_waiting):
            return True
        return False

    def kv_bytes(self) -> int:
        return self.decoder.kv_bytes() if self.decoder is not None else 0

    def kv_pages_in_use(self) -> int:
        return (self.decoder.kv_pages_in_use()
                if self.decoder is not None else 0)

    def generated_tokens(self) -> int:
        d = self.decoder
        if d is None or d._m_tokens is None:
            return 0
        return int(d._m_tokens.value)

    def describe(self) -> dict:
        out = {"replica": self.index, "alive": self.alive(),
               "devices": len(self.devices),
               "predict_depth": self.predict_depth(),
               "generate_load": self.generate_load()}
        dead = self.dead_components()
        if dead:
            out["dead"] = dead
        return out

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.batcher is not None:
            self.batcher.close()
        if self.decoder is not None:
            self.decoder.close()


class ReplicaSet:
    """N replicas + the routing/readiness/aggregation policy over them.

    ``metrics`` (the FLEET registry, not a labelled view) receives the
    unlabelled aggregates; per-replica series are registered by each
    replica's own components against their labelled views."""

    def __init__(self, replicas: List[Replica], metrics=None):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self.replicas = list(replicas)
        self._lock = threading.Lock()
        if metrics is not None:
            metrics.gauge("replicas", "configured dp engine replicas",
                          fn=lambda: len(self.replicas))
            metrics.gauge("replicas_live",
                          "replicas currently passing health checks",
                          fn=lambda: sum(r.alive()
                                         for r in self.replicas))
            # fleet aggregates of the per-replica gauges — SAME names
            # the single-replica decoder registers, so dashboards and
            # `explain --mem` keep reading totals under dp
            metrics.gauge("kv_cache_bytes",
                          "KV cache bytes, summed over replicas",
                          fn=lambda: sum(r.kv_bytes()
                                         for r in self.replicas))
            metrics.gauge("kv_pages_in_use",
                          "KV pool pages handed out, summed over "
                          "replicas",
                          fn=lambda: sum(r.kv_pages_in_use()
                                         for r in self.replicas))
            # counters can't be fn-backed sums of counters without
            # double-counting scrapes, so the fleet total is a gauge
            # under a fleet_ name (per-replica counters keep the
            # canonical name, labelled)
            metrics.gauge("fleet_generated_tokens_total",
                          "decode tokens emitted, summed over replicas",
                          fn=lambda: sum(r.generated_tokens()
                                         for r in self.replicas))

    def __len__(self) -> int:
        return len(self.replicas)

    # -------------------------------------------------------------- routing
    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive()]

    def _pick(self, load_fn) -> Replica:
        live = self.live()
        if not live:
            raise WorkerDied("all engine replicas are dead")
        # min() keeps the FIRST minimal element, and self.replicas is in
        # index order — so ties break to the lowest index, always
        return min(live, key=lambda r: load_fn(r) + r.routing)

    def pick_predict(self) -> Replica:
        """Least batcher queue depth among live replicas; lowest index
        wins ties. Raises WorkerDied (-> 503) when none are live."""
        return self._pick(lambda r: r.predict_depth())

    def pick_generate(self) -> Replica:
        """Least decode load (active slots + waiting queue) among live
        replicas; lowest index wins ties."""
        return self._pick(lambda r: r.generate_load())

    @contextlib.contextmanager
    def routed(self, endpoint: str):
        """The replica :meth:`pick_predict` (``endpoint == "predict"``) or
        :meth:`pick_generate` would choose, reserved while the block runs:
        the caller submits inside it, and until the block ends the request
        counts one in that replica's load, so concurrent picks spread."""
        pick = (self.pick_predict if endpoint == "predict"
                else self.pick_generate)
        with self._lock:
            rep = pick()
            rep.routing += 1
        try:
            yield rep
        finally:
            with self._lock:
                rep.routing -= 1

    # ------------------------------------------------------------ readiness
    def ready_detail(self) -> tuple:
        """(ok, detail): ok while >= 1 replica is live — dead replicas
        are routed around, not a reason to drain the fleet — but every
        replica's verdict is in the detail body."""
        states = [r.describe() for r in self.replicas]
        n_live = sum(1 for s in states if s["alive"])
        detail = {"replicas": len(self.replicas),
                  "replicas_live": n_live,
                  "replica_states": states}
        dead = [s["replica"] for s in states if not s["alive"]]
        if dead:
            detail["replicas_dead"] = dead
        return n_live > 0, detail

    def shed_generate(self, frac: float) -> bool:
        """Fleet tier-1 shed: only when EVERY live replica is past its
        saturation fraction (idle replicas must keep taking work)."""
        live = self.live()
        if not live:
            return False  # dead-fleet requests 503 via routing, not 429
        return all(r.generate_saturated(frac) for r in live)

    # ------------------------------------------------------------ lifecycle
    def debug_snapshot(self) -> dict:
        out = {"replicas": []}
        for r in self.replicas:
            snap = (r.decoder.debug_snapshot()
                    if r.decoder is not None else {})
            snap["replica"] = r.index
            snap["alive"] = r.alive()
            if r.batcher is not None:
                snap["batcher"] = {
                    "queue_depth": r.batcher.queue_depth,
                    "max_queue": r.batcher.max_queue,
                    "worker_up": r.batcher.alive()}
            out["replicas"].append(snap)
        return out

    def close(self) -> None:
        for r in self.replicas:
            try:
                r.close()
            except Exception:  # one bad replica must not block the rest
                logger.exception("closing replica %d failed", r.index)
