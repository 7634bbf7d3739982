"""Fleet engine worker (counterpart of
``bigdl_tpu/serving/fleet/worker.py``): the ``serve`` stack plus the
control surface the router talks to.

A worker is the single-process server (same flags, engines and
endpoints), started by the router on an ephemeral port with two more
routes:

* ``GET /control/state``  — the heartbeat (:mod:`fleet.control`): state,
  queue depth (batcher rows and decode load) and active decode slots,
  summed over the worker's replicas, SLO burn and goodput from the
  request tracer, the model version served, and the restart count the
  router put in the environment;
* ``POST /admin/reload``  — the worker half of the rolling weight swap
  (:func:`fleet.swap.swap_app_weights`).

``--strategy`` is the serve CLI's. A ``dp:N`` worker is one process with
N replicas (``serving.replicas``). A ``tp:K`` or ``dp:N+tp:K`` worker is
a group of K processes, one a device, started by the process the router
spawns (:func:`run_group`), which then only watches them: rank 0 serves
HTTP with the control routes (and ``GET /debug/ranks``: each rank's pid,
tp calls run and ``flash_fwd`` launches); ranks 1..K-1 follow rank 0's
calls through ``TPLink``, the weight swap's among them. The group has a
rendezvous of its own (a fresh ``MASTER_PORT`` at every start; gloo on
the CPU, and where the ranks outnumber the cards, which they then share,
``LOCAL_RANK`` modulo the card count), and lives or dies whole: when any
rank exits the others are killed and the group exits non-zero, so the
router counts one restart and brings all K back. The router runs each
worker in a session of its own and kills the whole process group.

``--faultPlan`` is installed on rank 0 alone: ``worker_kill@worker_boot:N``
counts boots of the worker (rank 0), as the JAX worker is one process.

``python -m bigdl_tpu_torch.serving.fleet.worker transformer_lm ...``
also runs alone, a fleet of one. It builds every CUDA graph before it
prints the ``serving ... on http://host:port`` line the router reads,
then a line with its boot time and the card memory it holds.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

from bigdl_tpu_torch.serving.fleet import control, swap

__all__ = ["WorkerControl", "build_parser", "main", "run_group"]

# the environment variable the router passes a worker's restart count in
RESTARTS_ENV = "BIGDL_TPU_WORKER_RESTARTS"
# the route of a tp worker's per-rank report
RANKS_PATH = "/debug/ranks"


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
        if swap._links(app):
            app.extra_routes[("GET", RANKS_PATH)] = self.handle_ranks

    # ------------------------------------------------------------- signals
    def _components(self):
        if self.app.replicas is not None:
            return [(r.batcher, r.decoder)
                    for r in self.app.replicas.replicas]
        return [(self.app.batcher, self.app.decoder)]

    def queue_depth(self) -> int:
        n = 0
        for batcher, decoder in self._components():
            if batcher is not None:
                n += int(batcher.queue_depth)
            if decoder is not None:
                n += int(decoder.queue_load())
        return n

    def decode_active(self) -> int:
        n = 0
        for _, decoder in self._components():
            if decoder is not None:
                n += sum(r is not None for r in decoder._reqs)
        return n

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

    def handle_ranks(self, _payload=None):
        return 200, {"ranks": rank_report(self.app)}

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


# -------------------------------------------------------- the tp:K group
def install_tp(app) -> None:
    """On every rank of a tp worker, after ``build_app``: the swap's
    handlers and the rank report on each replica's ``TPLink``, then one
    agreement over each link, so that no rank is called before every rank
    has registered."""
    swap.install_tp_swap(app)
    for link, (engine, _, decoder) in zip(swap._links(app),
                                          swap._stacks(app)):
        def report(link=link):
            from bigdl_tpu_torch.ops import attention_kernel as ak
            return link.agree({"rank": link.rank, "pid": os.getpid(),
                               "calls": link.calls,
                               "flash_fwd": int(ak.flash_fwd.launches)})
        link.register("worker.ranks", report)
        with swap._pool(engine, decoder).work():  # no link call beside it
            link.agree(True)


def rank_report(app) -> list:
    """Each rank's ``{"rank", "pid", "calls", "flash_fwd"}`` of a tp
    worker (rank 0's call over the first replica's link)."""
    link = swap._links(app)[0]
    engine, _, decoder = swap._stacks(app)[0]
    with swap._pool(engine, decoder).work():
        return link.call("worker.ranks")


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(argv, k: int, poll_s: float = 0.05) -> int:
    """Start the K ranks of a tp worker (this module again, with
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and a fresh ``MASTER_PORT``;
    their output is this process's) and watch them: when one exits, kill
    the rest and return its code (non-zero unless rank 0 ended cleanly
    and the followers after it). SIGTERM kills every rank. Imports no
    torch."""
    port = _free_port()
    procs: list = []

    def kill_all(sig=signal.SIGKILL):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:
                    pass
        for p in procs:
            p.wait()

    def on_term(signum, _frame):
        kill_all()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    try:
        for rank in range(int(k)):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(rank),
                       WORLD_SIZE=str(k), LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bigdl_tpu_torch.serving.fleet.worker"]
                + list(argv), env=env))
        while True:
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    continue
                if rank == 0 and rc == 0:
                    # a clean close releases the followers: let them end
                    t_end = time.monotonic() + 10.0
                    while time.monotonic() < t_end and any(
                            q.poll() is None for q in procs):
                        time.sleep(poll_s)
                    if all(q.poll() == 0 for q in procs):
                        return 0
                print(f"worker group: rank {rank} of {k} exited with {rc}; "
                      f"stopping the group", flush=True)
                return rc if rc > 0 else (128 - rc if rc < 0 else 1)
            time.sleep(poll_s)
    finally:
        kill_all()


def _join_group(args, k: int) -> None:
    """This rank's process group: gloo on the CPU and where the ranks
    outnumber the cards (which they then share), else NCCL."""
    import torch

    from bigdl_tpu_torch.parallel import init_distributed
    cards = (torch.cuda.device_count()
             if args.platform != "cpu" and torch.cuda.is_available() else 0)
    init_distributed(backend="gloo" if cards < k else None)


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
    raw = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(raw)
    if args.fleet:
        raise SystemExit("--fleet belongs to the router process; a worker "
                         "serves exactly one engine stack")
    tp_k = common.resolve_serve_config(args).serving_tp
    if tp_k > 1 and "RANK" not in os.environ:
        return run_group(raw, tp_k)
    leader = int(os.environ.get("RANK", "0")) == 0
    if leader:
        # a --faultPlan 'worker_kill@worker_boot:N' kills the Nth boot of
        # the worker: the router's supervised-restart drill (no-op
        # without one)
        common.install_fault_plan(args)
        from bigdl_tpu_torch.resilience.faults import hook as _fault_hook
        _fault_hook("worker_boot")

    import torch

    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving.server import run_server

    if tp_k > 1:
        _join_group(args, tp_k)
    app, engine, _, _ = serve_cli.build_app(args)
    if tp_k > 1:
        install_tp(app)
    if getattr(app, "follower", False):
        # ranks 1..K-1: rank 0's calls until it closes
        try:
            app.serve()
            return 0
        finally:
            app.close()
    WorkerControl(app, index=args.workerIndex,
                  version=args.modelVersion or "v0", port=args.port)
    if engine.device.type == "cuda":
        mem = (f"{torch.cuda.max_memory_allocated(engine.device)} bytes "
               f"peak allocated on {torch.cuda.get_device_name(0)}")
    else:
        mem = "on the CPU"
    print(f"worker {args.workerIndex} built in "
          f"{time.perf_counter() - t0:.1f}s, {mem}", flush=True)
    return run_server(app, args.host, args.port)


if __name__ == "__main__":
    raise SystemExit(main())
