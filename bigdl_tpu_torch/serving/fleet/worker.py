"""Fleet engine worker (counterpart of
``bigdl_tpu/serving/fleet/worker.py``): the ``serve`` stack plus the
control surface the router talks to.

A worker is the single-process server (same flags, engines and
endpoints), started by the router on an ephemeral port with two more
routes:

* ``GET /control/state``  — the heartbeat (:mod:`fleet.control`): state,
  queue depth (batcher rows and decode load), active decode slots, SLO
  burn and goodput from the request tracer, the model version served,
  and the restart count the router put in the environment;
* ``POST /admin/reload``  — the worker half of the rolling weight swap
  (:func:`fleet.swap.swap_app_weights`).

``python -m bigdl_tpu_torch.serving.fleet.worker transformer_lm ...``
also runs alone, a fleet of one. It builds every CUDA graph before it
prints the ``serving ... on http://host:port`` line the router reads,
then a line with its boot time and the card memory it holds.
"""

from __future__ import annotations

import os
import threading
import time

from bigdl_tpu_torch.serving.fleet import control, swap

__all__ = ["WorkerControl", "build_parser", "main"]

# the environment variable the router passes a worker's restart count in
RESTARTS_ENV = "BIGDL_TPU_WORKER_RESTARTS"


class WorkerControl:
    """The worker's control plane: the lifecycle state (ready ->
    reloading -> ready), heartbeats, and reloads one at a time (a second
    reload waits on the lock)."""

    def __init__(self, app, *, index: int = 0, version: str = "v0",
                 port: int = 0, clock=time.monotonic):
        self.app = app
        self.index = int(index)
        self.port = int(port)
        self.clock = clock
        self._t0 = clock()
        self._state = "ready"
        self._lock = threading.Lock()
        self.restarts = int(os.environ.get(RESTARTS_ENV, "0") or 0)
        app.model_version = str(version)
        app.extra_routes[("GET", control.CONTROL_PATH)] = self.handle_state
        app.extra_routes[("POST", control.RELOAD_PATH)] = self.handle_reload

    # ------------------------------------------------------------- signals
    def queue_depth(self) -> int:
        n = 0
        if self.app.batcher is not None:
            n += int(self.app.batcher.queue_depth)
        if self.app.decoder is not None:
            n += int(self.app.decoder.queue_load())
        return n

    def decode_active(self) -> int:
        dec = self.app.decoder
        return 0 if dec is None else sum(r is not None for r in dec._reqs)

    @staticmethod
    def _slo():
        from bigdl_tpu_torch.serving import reqtrace as _reqtrace
        rt = _reqtrace.get()
        return rt.slo if rt is not None else None

    def status(self) -> control.WorkerStatus:
        slo = self._slo()
        return control.WorkerStatus(
            index=self.index, pid=os.getpid(), port=self.port,
            state=self._state,
            queue_depth=self.queue_depth(),
            decode_active=self.decode_active(),
            slo_burn=(round(slo.burn_rate(), 4) if slo is not None
                      else 0.0),
            goodput=(round(slo.goodput_frac(), 4) if slo is not None
                     else 1.0),
            model_version=str(self.app.model_version or "v0"),
            restarts=self.restarts,
            uptime_s=round(self.clock() - self._t0, 3))

    # ------------------------------------------------------------ handlers
    def handle_state(self, _payload=None):
        return 200, self.status().to_dict()

    def handle_reload(self, payload):
        payload = payload or {}
        ckpt = payload.get("checkpoint")
        version = payload.get("version")
        if not ckpt or not version:
            return 400, {"error": "reload needs 'checkpoint' and "
                                  "'version'"}
        try:
            drain_s = float(payload.get("drain_timeout_s", 60.0))
        except (TypeError, ValueError):
            return 400, {"error": "'drain_timeout_s' must be a number"}
        with self._lock:
            self._state = "reloading"
            try:
                swap.swap_app_weights(self.app, str(ckpt), str(version),
                                      drain_timeout_s=drain_s)
            except swap.WeightSwapError as e:
                return 503, {"error": str(e)}
            except Exception as e:  # the old weights keep serving
                return 500, {"error": f"{type(e).__name__}: {e}"}
            finally:
                # a failed swap leaves the old weights serving: back into
                # rotation either way
                self._state = "ready"
        return 200, {"status": "reloaded",
                     "version": str(self.app.model_version)}


def build_parser():
    from bigdl_tpu_torch.cli import serve as serve_cli
    p = serve_cli.build_parser()
    p.prog = "python -m bigdl_tpu_torch.serving.fleet.worker"
    p.add_argument("--workerIndex", type=int, default=0,
                   help="this worker's slot in the fleet (router-assigned; "
                        "labels heartbeats and metrics)")
    return p


def main(argv=None) -> int:
    t0 = time.perf_counter()
    from bigdl_tpu_torch.cli import common
    common.setup_logging()
    args = build_parser().parse_args(argv)
    if args.fleet:
        raise SystemExit("--fleet belongs to the router process; a worker "
                         "serves exactly one engine stack")
    # a --faultPlan 'worker_kill@worker_boot:N' kills the Nth boot of this
    # process: the router's supervised-restart drill (no-op without one)
    common.install_fault_plan(args)
    from bigdl_tpu_torch.resilience.faults import hook as _fault_hook
    _fault_hook("worker_boot")

    import torch

    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving.server import run_server

    app, _, _, _ = serve_cli.build_app(args)
    WorkerControl(app, index=args.workerIndex,
                  version=args.modelVersion or "v0", port=args.port)
    if app.engine.device.type == "cuda":
        mem = (f"{torch.cuda.max_memory_allocated(app.engine.device)} bytes "
               f"peak allocated on {torch.cuda.get_device_name(0)}")
    else:
        mem = "on the CPU"
    print(f"worker {args.workerIndex} built in "
          f"{time.perf_counter() - t0:.1f}s, {mem}", flush=True)
    return run_server(app, args.host, args.port)


if __name__ == "__main__":
    raise SystemExit(main())
