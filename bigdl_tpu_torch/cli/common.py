"""What the port's training CLIs share (counterpart of
``bigdl_tpu/cli/common.py``): the training and test flags, the
data-parallel strategy (``--strategy dp``, ``--gradCompress``,
``--gradBuckets``), building the Optimizer, loading a trained checkpoint
and evaluating it; for ``serve``, the fleet router and its workers, the
one parse of the serving flags (:func:`resolve_serve_config`) and the
``--faultPlan`` install; recovery (``--supervise``, ``--faultPlan``,
``--elastic``, ``--minDevices``: :func:`run_optimize`); observability
(``--obs``, ``--traceDir``, ``--traceSteps``, ``--metricsPort``:
:func:`install_observability`). The training CLIs take ``--strategy dp``
and ``tp``, and exit with the JAX text for sp, pp and ep, which
``cli.perf`` takes (:func:`build_strategy`).

Data parallelism runs one process a GPU: ``torchrun --nproc_per_node N
-m bigdl_tpu_torch.cli.resnet train ... --strategy dp``, or on the CPU N
gloo processes (``--platform cpu``). ``--batchSize`` is the global batch,
as in the JAX package."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Optional, Sequence

__all__ = ["setup_logging", "add_train_args", "add_test_args",
           "add_fused_bn_arg", "apply_fused_bn", "add_pipeline_args",
           "add_conv_args", "apply_conv_args", "add_strategy_arg",
           "parse_strategy_spec", "resolve_strategy",
           "check_strategy_dispatch", "strategy_mesh_axes",
           "add_grad_comm_args", "make_grad_comm", "build_strategy",
           "build_feed", "build_optimizer", "load_trained", "evaluate",
           "OPTIM_METHODS", "PIPELINE_STAGE_CHOICES", "STRATEGY_CHOICES",
           "SERVING_STRATEGY_CHOICES", "parse_serving_strategy",
           "GRAD_COMPRESS_CHOICES", "QUANTIZE_CHOICES", "ResolvedConfig",
           "resolve_serve_config", "install_fault_plan", "add_autotune_arg",
           "apply_autotune", "AUTOTUNE_CHOICES", "add_resilience_args",
           "apply_platform", "run_optimize", "run_supervised",
           "check_elastic", "add_obs_args", "ObsState",
           "install_observability"]

OPTIM_METHODS = ("sgd", "adam", "adamw", "adagrad", "rmsprop", "lars", "lamb")
# dataset.pipeline.STAGE_CHOICES, spelled here so that building a parser
# imports no dataset module (a test holds the two equal)
PIPELINE_STAGE_CHOICES = ("off", "host", "device")


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")


def _add_platform_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="device to run on (default cuda); cpu runs the "
                        "kernels' plain versions")


# tuning.MODES, spelled here so that building a parser imports no torch
# (a test holds the two equal)
AUTOTUNE_CHOICES = ("off", "cached", "measure")


def add_autotune_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--autotune", default="off",
                   choices=list(AUTOTUNE_CHOICES),
                   help="per-shape autotuner (bigdl_tpu_torch.tuning): conv "
                        "pass layouts, the BN kernels' slab height, the "
                        "key-padding path's key block, the gradient bucket "
                        "bound, the KV page size, the int8 product. "
                        "'cached' = read persisted decisions (~/.cache/"
                        "bigdl_tpu/autotune/<device>.json, or "
                        "$BIGDL_TPU_AUTOTUNE_CACHE), never measure; "
                        "'measure' = time the candidates on the card on a "
                        "miss and persist the winner (without a card it "
                        "records the defaults untimed); 'off' = the "
                        "untuned defaults")


def apply_autotune(args) -> None:
    """Install ``--autotune`` process-wide (the JAX ``apply_platform``'s
    step): a bad mode exits with the tuner's message."""
    mode = getattr(args, "autotune", None)
    if mode:
        from bigdl_tpu_torch import tuning
        try:
            tuning.set_mode(mode)
        except ValueError as e:
            raise SystemExit(str(e))


def add_resilience_args(p: argparse.ArgumentParser) -> None:
    """--supervise/--faultPlan/--elastic/--minDevices, the JAX CLIs'
    recovery flags (shared by the training CLIs and perf)."""
    p.add_argument("--supervise", nargs="?", const=5, type=int,
                   default=None, metavar="BUDGET",
                   help="supervised recovery (bigdl_tpu_torch.resilience): "
                        "catch retryable faults (transient dispatch "
                        "errors, checkpoint I/O failures, checksum "
                        "mismatches, soft preemptions), retry with "
                        "exponential backoff + deterministic jitter, "
                        "auto-resume from the newest checksum-VALID "
                        "checkpoint, give up past BUDGET retries (bare "
                        "flag = 5). Fault-free overhead is one pointer "
                        "check per step")
    p.add_argument("--faultPlan", default=None, metavar="SPEC|FILE",
                   help="deterministic seeded fault injection "
                        "(bigdl_tpu_torch.resilience.faults): ';'-separated "
                        "kind@site:VISITS[:ARG] entries or a JSON file — "
                        "e.g. 'preempt@step:7' (process-fatal kill "
                        "before step 7), 'dispatch@step:p0.01;seed=3' "
                        "(1%% transient step failures), "
                        "'corrupt@ckpt_save:2' (bit-rot the 2nd "
                        "checkpoint), 'stall@step:4:0.25', "
                        "'kill_device@step:5:1' (lose 1 rank before "
                        "step 5 — recoverable only under --elastic). "
                        "Sites: data, step, ckpt_save, ckpt_restore, "
                        "infer, request. No-op when unset")
    p.add_argument("--elastic", default=None, choices=["hold", "scale"],
                   metavar="POLICY",
                   help="elastic data parallelism "
                        "(bigdl_tpu_torch.resilience.elastic): on rank "
                        "loss (kill_device fault / DeviceLossFault) re-form "
                        "the data axis over the surviving ranks, re-resolve "
                        "the grad-comm bucket bound for the new count, and "
                        "resume from the last valid checkpoint — holding "
                        "the global batch (hold: pad with wrap-around "
                        "rows) or scaling it (scale: trim to "
                        "divisibility). dp strategy only")
    p.add_argument("--minDevices", type=int, default=1, metavar="N",
                   help="give up cleanly (SupervisorGaveUp) when fewer "
                        "than N healthy devices survive — elastic "
                        "reshape never thrashes below a viable mesh "
                        "(default 1)")


def add_obs_args(p: argparse.ArgumentParser) -> None:
    """--obs/--traceDir/--traceSteps/--metricsPort: the observability
    layer, shared by perf and every training CLI."""
    p.add_argument("--obs", action="store_true",
                   help="step-phase observability (bigdl_tpu_torch.obs): "
                        "spans around the loop's phases (data_wait/h2d/"
                        "dispatch/device/ckpt), per-step phase histograms "
                        "in the shared metrics registry, the memory plan "
                        "and live allocator gauges, and phase columns in "
                        "perf JSON lines. Off: no device wait and no "
                        "histogram; the columns are null")
    p.add_argument("--traceDir", default=None, metavar="DIR",
                   help="observability artifact dir: the Chrome-trace span "
                        "timeline (spans.trace.json, for chrome://tracing "
                        "or ui.perfetto.dev), the capture windows "
                        "(capture_<step>/trace.json) and an OOM's "
                        "memory_report.json; a rank of a multi-process "
                        "job writes under DIR/rank<r>. Implies --obs")
    p.add_argument("--traceSteps", default=None, metavar="N@M",
                   help="capture a torch.profiler trace of steps M..M+N-1 "
                        "mid-run into --traceDir (verified and attributed "
                        "on close). Independently, SIGUSR2 or `touch "
                        "DIR/CAPTURE` opens a bounded window on a run in "
                        "flight")
    p.add_argument("--metricsPort", type=int, default=None, metavar="PORT",
                   help="start a live /metrics listener (the Prometheus "
                        "exposition) for this training/perf run; 0 = "
                        "auto-pick a free port (printed and stamped into "
                        "the perf JSON obs annotation). An explicit port "
                        "that is taken is a clean SystemExit")


class ObsState:
    """What :func:`install_observability` wired up for this process:
    whether span tracing is on, the capture controller, the live metrics
    listener, where artifacts land, and (installed by the perf harness)
    the memory plan and live sampler. ``finalize()`` is idempotent: the
    perf harness calls it before stamping its line, the training path
    after ``optimize()``."""

    def __init__(self, enabled: bool, trace_dir: Optional[str],
                 capture, server):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.capture = capture
        self.server = server
        self.mem_plan: Optional[dict] = None
        self.mem_sampler = None
        self._final: Optional[dict] = None

    def finalize(self) -> dict:
        """Close any open capture window and export the span timeline;
        returns ``{trace_json, span_events, captures, metrics_port,
        metrics_url}`` (the keys that apply)."""
        if self._final is not None:
            return self._final
        from bigdl_tpu_torch import obs
        info: dict = {}
        if self.capture is not None:
            self.capture.finish()
            ann = self.capture.annotation()
            if ann:
                info["captures"] = ann
        tracer = obs.get_tracer()
        if tracer is not None and self.trace_dir:
            path = os.path.join(self.trace_dir, "spans.trace.json")
            try:
                n = tracer.export_chrome_trace(path)
            except OSError as e:
                logging.getLogger(__name__).warning(
                    "obs: span export to %s failed: %s", path, e)
            else:
                info["trace_json"] = path
                info["span_events"] = n
                print(f"obs: wrote {n} span(s) to {path}", flush=True)
        if self.server is not None:
            info["metrics_port"] = self.server.port
            info["metrics_url"] = self.server.url
        self._final = info
        return info


def install_observability(args) -> Optional[ObsState]:
    """Activate the --obs/--traceDir/--traceSteps/--metricsPort surface
    (None when none is set). --traceDir implies span tracing;
    --traceSteps needs --traceDir. A rank of a multi-process job
    (``WORLD_SIZE`` > 1) writes under ``<traceDir>/rank<RANK>``: each
    process has its own profiler session. The state is stashed on
    ``args`` as ``_obs``."""
    obs_flag = getattr(args, "obs", False)
    trace_dir = getattr(args, "traceDir", None)
    trace_steps = getattr(args, "traceSteps", None)
    port = getattr(args, "metricsPort", None)
    if not (obs_flag or trace_dir or trace_steps or port is not None):
        return None
    if trace_steps and not trace_dir:
        raise SystemExit("--traceSteps needs --traceDir DIR (somewhere "
                         "for the capture windows to land)")
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.core.module import resolve_device

    if trace_dir and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        trace_dir = os.path.join(trace_dir,
                                 f"rank{os.environ.get('RANK', '0')}")
    enabled = bool(obs_flag or trace_dir)
    if enabled and not obs.enabled():
        obs.enable()
    capture = None
    if trace_dir:
        try:
            capture = obs.CaptureController(
                trace_dir, trace_steps=trace_steps,
                device=resolve_device(getattr(args, "platform", None)))
        except ValueError as e:
            raise SystemExit(str(e))
        # a device OOM anywhere in this process has a home for its report
        obs.memory.install(trace_dir=trace_dir)
    server = None
    if port is not None:
        server = obs.start_metrics_server(obs.get_registry(), port=port,
                                          strict=(port != 0))
    state = ObsState(enabled, trace_dir, capture, server)
    args._obs = state
    return state


def apply_platform(args) -> None:
    """The training CLIs' platform step: refuse an unavailable
    ``--platform`` before any data is read, and install ``--faultPlan``
    and the ``--obs`` family process-wide (no-ops without them), as the
    JAX ``apply_platform`` does."""
    from bigdl_tpu_torch.core.module import resolve_device

    resolve_device(getattr(args, "platform", None))
    install_fault_plan(args)
    install_observability(args)


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The reference's common training knobs (-f, -b, --learningRate,
    --maxEpoch, --checkpoint, --model resume), with ``--platform`` picking
    the device (cuda unless the CPU is asked for)."""
    _add_platform_arg(p)
    p.add_argument("-f", "--folder", default="./", help="data folder")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--learningRate", type=float, default=0.05)
    p.add_argument("--learningRateDecay", type=float, default=0.0)
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--maxEpoch", type=int, default=5)
    p.add_argument("--checkpoint", default=None,
                   help="dir for model.<n>/state.<n> snapshots, written "
                        "every epoch")
    p.add_argument("--model", default=None,
                   help="checkpoint dir to resume from (the port's or the "
                        "JAX package's)")
    p.add_argument("--overWriteCheckpoint", action="store_true")
    p.add_argument("--keepCheckpoints", type=int, default=None, metavar="K",
                   help="keep only the newest K snapshots (the newest valid "
                        "pair is never deleted)")
    add_resilience_args(p)
    add_obs_args(p)
    p.add_argument("--stepsPerDispatch", type=int, default=1, metavar="K",
                   help="K optimizer steps over K batches per dispatch: a "
                        "CUDA graph of the K steps on the card, replayed "
                        "each dispatch (the first dispatch runs eagerly); "
                        "the same update math and seeds as K=1, with the "
                        "log, validation and checkpoint triggers firing at "
                        "dispatch boundaries")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--logEvery", type=int, default=10)
    p.add_argument("--optimMethod", default="sgd", choices=OPTIM_METHODS,
                   help="optimizer (sgd keeps the reference defaults, "
                        "dampening = momentum; weightDecay and momentum "
                        "apply where meaningful)")
    add_fused_bn_arg(p)
    add_pipeline_args(p)
    add_conv_args(p)
    p.add_argument("--dataParallel", action="store_true",
                   help="deprecated alias of --strategy dp")
    add_strategy_arg(p)
    add_grad_comm_args(p)
    add_autotune_arg(p)
    add_lint_arg(p)


# the JAX CLIs' --strategy names; the port has dp
STRATEGY_CHOICES = ("dp", "tp", "sp", "pp", "ep")
# parallel/grad_comm.COMPRESS_MODES, spelled here so that building a
# parser imports no parallel module (a test holds the two equal)
GRAD_COMPRESS_CHOICES = ("off", "bf16", "fp16", "bf16+ec", "fp16+ec")
# serving/quant.QUANTIZE_CHOICES, spelled here so that the serve parser,
# which the fleet router builds, imports no torch (a test holds the two
# equal)
QUANTIZE_CHOICES = ("off", "int8", "fp8", "kv8", "int8+kv8", "fp8+kv8")


def add_strategy_arg(p: argparse.ArgumentParser) -> None:
    """--strategy NAME[:K], with the JAX CLIs' spelling."""
    p.add_argument("--strategy", default=None, metavar="NAME[:K]",
                   help="multi-device training strategy over the ranks "
                        "of a torchrun job, one process a GPU: dp = data "
                        "parallel (ZeRO-1 optimizer state, batch norm over "
                        "the global batch); tp[:K] = Megatron tensor "
                        "parallel over a model axis of K ranks (default "
                        "N/2 at 4 or more ranks, else N) times data "
                        "parallel over the rest. cli.perf also takes "
                        "sp[:K] (ring attention over a seq axis), pp[:K] "
                        "(a GPipe pipeline of K stages) and ep[:K] (an "
                        "expert-parallel MoE). Replaces the deprecated "
                        "--dataParallel")


def parse_strategy_spec(spec: Optional[str]):
    """``"name[:K]"`` -> ``(name, k or None)``; SystemExit on junk."""
    if not spec:
        return None, None
    name, _, k = str(spec).partition(":")
    if name not in STRATEGY_CHOICES:
        raise SystemExit(f"--strategy {spec!r}: unknown strategy "
                         f"{name!r}; choose from {list(STRATEGY_CHOICES)}"
                         " (optionally NAME:K to size the non-data axis)")
    if not k:
        return name, None
    try:
        kk = int(k)
    except ValueError:
        raise SystemExit(f"--strategy {spec!r}: K must be an integer")
    if kk < 1:
        raise SystemExit(f"--strategy {spec!r}: K must be >= 1")
    return name, kk


def resolve_strategy(args):
    """The run's ``(strategy name, k or None)``: ``--strategy`` wins; the
    deprecated ``--dataParallel`` means ``dp``."""
    name, k = parse_strategy_spec(getattr(args, "strategy", None))
    if name is not None:
        return name, k
    if getattr(args, "dataParallel", False):
        logging.getLogger(__name__).warning(
            "--dataParallel is deprecated; use --strategy dp")
        return "dp", None
    return None, None


def check_strategy_dispatch(steps: int, flag: str = "--stepsPerDispatch"):
    """Multi-step dispatch is single-device: with a strategy it exits."""
    if steps and int(steps) > 1:
        raise SystemExit(
            f"{flag} > 1 is a single-device dispatch amortization (the "
            "stepsPerDispatch contract); it cannot be combined with a "
            "multi-device --strategy/--dataParallel (whose runtime "
            "pipelines dispatch already)")


def strategy_mesh_axes(name: str, n_devices: int, k: Optional[int] = None
                       ) -> dict:
    """The mesh axes of ``name`` over ``n_devices`` (the JAX function's):
    ``{"data": n}`` for dp; ``{"data": n // k, "model"|"seq": k}`` for tp
    and sp, k defaulting to n // 2 at 4 or more devices, else n;
    ``{"pipe": k, "data": n // k}`` for pp, k defaulting to 4 stages
    where 4 divides n, else 2; ``{"expert": k or n}`` for ep."""
    n = int(n_devices)
    if name == "dp":
        return {"data": n}
    if name in ("tp", "sp"):
        axis = "model" if name == "tp" else "seq"
        kk = k or (n // 2 if n >= 4 else n)
        if n % kk:
            raise SystemExit(f"--strategy {name}:{kk} needs the {axis} "
                             f"axis to divide {n} devices")
        return {"data": n // kk, axis: kk}
    if name == "pp":
        kk = k or (4 if n % 4 == 0 and n >= 4 else 2)
        if n % kk:
            raise SystemExit(f"--strategy pp:{kk} needs the stage count "
                             f"to divide {n} devices")
        return {"pipe": kk, "data": n // kk}
    if name == "ep":
        return {"expert": k or n}
    raise SystemExit(f"unknown strategy {name!r}")


# the strategies that compose with the model and step structure: cli.perf
# builds them (ring attention, the pipeline stack, the MoE)
HARNESS_STRATEGIES = ("sp", "pp", "ep")


def add_grad_comm_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gradCompress", default="off",
                   choices=list(GRAD_COMPRESS_CHOICES),
                   help="the gradient all-reduce's wire dtype under "
                        "--strategy dp (bigdl_tpu_torch.parallel."
                        "grad_comm): dense buckets cross the wire as "
                        "bf16/fp16 (half the bytes); '+ec' carries each "
                        "rank's rounding residual into its next step "
                        "(error feedback). 'off' sums f32")
    p.add_argument("--gradBuckets", default="auto", metavar="auto|N",
                   help="dense-bucket bound of the gradient all-reduce: "
                        "'auto' = the tuner's grad_comm decision under "
                        "--autotune cached|measure, else the 4 MiB "
                        "default; an integer N pins it "
                        "to N MiB")


def make_grad_comm(args):
    """``(--gradCompress, --gradBuckets)`` -> GradCommConfig (None when
    the surface is untouched); SystemExit on junk."""
    compress = getattr(args, "gradCompress", None)
    buckets = getattr(args, "gradBuckets", None)
    if (compress or "off") == "off" and (buckets in (None, "auto")):
        return None
    from bigdl_tpu_torch.parallel.grad_comm import make_config
    try:
        return make_config(compress, buckets)
    except ValueError as e:
        raise SystemExit(str(e))


def check_elastic(name: Optional[str], elastic: Optional[str]) -> None:
    """``--elastic`` needs ``--strategy dp``: the JAX CLIs' exits."""
    if elastic is None:
        return
    if name is None:
        raise SystemExit("--elastic needs --strategy dp (elastic "
                         "reshape is a data-parallel contract)")
    if name != "dp":
        raise SystemExit(f"--elastic composes with --strategy dp only "
                         f"(got {name}); tp/sp/pp/ep meshes cannot "
                         "re-form at arbitrary surviving counts")


def _world() -> int:
    """The job's live rank count: the live mesh's (after an elastic
    re-formation, the survivors), else the job's."""
    from bigdl_tpu_torch.parallel.mesh import live_size
    return live_size()


def _join(args) -> None:
    from bigdl_tpu_torch.parallel import init_distributed
    init_distributed(backend="gloo" if getattr(args, "platform", None)
                     == "cpu" else None)


def build_strategy(args, model=None, batch: Optional[int] = None,
                   harness: bool = False):
    """The ``DataParallel`` that ``--strategy dp`` (or ``--dataParallel``)
    asks for, or the ``TensorParallel`` of ``--strategy tp[:K]`` (over
    ``model``, or the model a later ``bind`` names), over the ranks of
    this torchrun job (joined here with ``init_distributed``: gloo under
    ``--platform cpu``), or None. ``harness`` (``cli.perf``) takes sp, pp
    and ep too: sp gives a ``SequenceParallel`` over ``{"data", "seq"}``,
    pp and ep the mesh their harness builds its step over; the training
    CLIs exit for them with the JAX text. Under
    ``--elastic`` it is an ``ElasticDataParallel`` over the surviving
    ranks (``resilience.faults.healthy_devices()``); a rank that is not
    among them leaves the job here with exit code 0. Exits as the JAX CLIs
    do: ``--elastic`` without dp or with another strategy; ``--strategy
    dp`` or ``tp`` in one process naming
    ``torchrun`` (the deprecated alias then means nothing);
    ``--stepsPerDispatch`` or ``--innerSteps`` > 1; a global ``batch`` the
    ranks do not divide (elastic runs pad or trim instead)."""
    name, k = resolve_strategy(args)
    elastic = getattr(args, "elastic", None)
    check_elastic(name, elastic)
    if name is None:
        return None
    if name in HARNESS_STRATEGIES and not harness:
        raise SystemExit(f"--strategy {name} composes with the model/step "
                         "structure and is wired through the perf harness "
                         "(bigdl-tpu perf --strategy {sp,pp,ep}); the "
                         "training CLIs support dp/tp")
    from bigdl_tpu_torch.parallel import DataParallel, make_mesh
    _join(args)
    devices = None
    if elastic is not None:
        from bigdl_tpu_torch.resilience.faults import healthy_devices
        devices = healthy_devices()
        n = len(devices)
    else:
        n = _world()
    if n <= 1:
        if getattr(args, "strategy", None):
            raise SystemExit(
                f"--strategy {name} needs more than one device; the port "
                f"runs one process a GPU: launch with torchrun "
                f"--nproc_per_node N (on the CPU, N gloo processes with "
                f"--platform cpu)")
        return None  # the deprecated --dataParallel alias: a no-op
    check_strategy_dispatch(getattr(args, "stepsPerDispatch", 1) or 1)
    check_strategy_dispatch(getattr(args, "innerSteps", 1) or 1,
                            "--innerSteps")
    axes = strategy_mesh_axes(name, n, k)
    data = axes.get("data", 1)
    if batch is not None and batch % data and elastic is None:
        raise SystemExit(f"batch {batch} must be divisible by the data "
                         f"axis ({data}) of --strategy {name} (mesh "
                         f"{axes})")
    if name in ("pp", "ep"):
        return make_mesh(axes)
    if name == "sp":
        from bigdl_tpu_torch.parallel import SequenceParallel
        return SequenceParallel(make_mesh(axes),
                                grad_comm=make_grad_comm(args))
    if name == "tp":
        from bigdl_tpu_torch.parallel import TensorParallel
        return TensorParallel(make_mesh(axes), model,
                              grad_comm=make_grad_comm(args))
    mesh = make_mesh(axes, devices)
    if elastic is None:
        return DataParallel(mesh, grad_comm=make_grad_comm(args))
    if not mesh.member:
        import torch.distributed as dist
        logging.getLogger(__name__).info(
            "elastic: rank %d was lost; the job goes on at %d ranks "
            "without it", dist.get_rank(), n)
        raise SystemExit(0)
    from bigdl_tpu_torch.resilience.elastic import ElasticDataParallel
    return ElasticDataParallel(mesh, batch_policy=elastic,
                               grad_comm=make_grad_comm(args))


def add_conv_args(p: argparse.ArgumentParser) -> None:
    """--convLayout/--convGeom: the conv layout policy
    (:mod:`bigdl_tpu_torch.ops.conv2d`), with the JAX CLIs' spellings."""
    p.add_argument("--convLayout", default=None,
                   metavar="FWD,DGRAD,WGRAD",
                   help="per-pass conv activation layouts (NHWC|NCHW|"
                        "GEMM each, or 'auto'/'default'; GEMM = a matrix "
                        "product for eligible 1x1/stride-1 convs, "
                        "exact-parity fallback elsewhere). Unset = "
                        "'auto': the measured probe decision shipped for "
                        "this device (ops/conv2d.MEASURED_DECISIONS, "
                        "none yet), no-op on unmeasured devices; "
                        "'default' forces all-NHWC. Wins over --convGeom")
    p.add_argument("--convGeom", default=None, metavar="FILE",
                   help="per-conv-geometry layout decision JSON "
                        "(tools/conv_probe.py --geom): decisions keyed by "
                        "(kh, kw, stride, cin, cout, groups, dilation, "
                        "dtype), each pass independently NHWC/NCHW/GEMM")


def apply_conv_args(args) -> None:
    """Install ``--convGeom``, then ``--convLayout`` (an explicit spec wins
    at lookup), as the JAX CLIs do before a model runs; a bad file or spec
    exits with the JAX message. Installing the same flags again changes
    nothing."""
    from bigdl_tpu_torch.ops.conv2d import (install_geom_file,
                                            install_layout_spec)
    geom = getattr(args, "convGeom", None)
    if geom:
        try:
            n = install_geom_file(geom)
        except (OSError, ValueError) as e:  # JSONDecodeError included
            raise SystemExit(f"--convGeom {geom}: {e}")
        logging.getLogger(__name__).info(
            "installed %d per-geometry conv layout decisions from %s",
            n, geom)
    spec = getattr(args, "convLayout", None)
    if spec:
        try:
            install_layout_spec(spec)
        except ValueError as e:
            raise SystemExit(str(e))


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    """--dataWorkers/--prefetchDepth/--stage: the input pipeline's
    executor and staging thread (dataset/pipeline/), with the JAX CLI's
    choices and defaults."""
    p.add_argument("--dataWorkers", type=int, default=0, metavar="N",
                   help="N decode/augment worker threads race the epoch "
                        "plan's sample tickets and reassemble batches in "
                        "order: the batch stream is the same for any N >= 1 "
                        "and across a kill and resume. 0 = the dataset's "
                        "own feed")
    p.add_argument("--prefetchDepth", type=int, default=2, metavar="D",
                   help="batches prepared ahead of the loop: bounds the "
                        "executor's batches in flight and the staging "
                        "queue (default 2)")
    p.add_argument("--stage", default="off",
                   choices=list(PIPELINE_STAGE_CHOICES),
                   help="staging thread: 'host' prepares batches ahead in "
                        "pinned memory; 'device' also copies batch N+1 to "
                        "the card on a side stream while the card runs "
                        "step N (with --stepsPerDispatch K too: the graph's "
                        "buffers are filled by copies on the card); 'off' "
                        "= feed inline (default)")


def build_feed(dataset, args):
    """``dataset`` wrapped per ``(--dataWorkers, --prefetchDepth,
    --stage)``; returns ``(dataset, provenance or None)`` and keeps the
    provenance on ``args._pipeline``. Unlike the JAX CLI, ``--stage
    device`` stays ``device`` under ``--stepsPerDispatch K > 1``: the
    graphed step takes device-staged batches by copies on the card."""
    from bigdl_tpu_torch.dataset.pipeline import wrap_pipeline

    ds, prov = wrap_pipeline(
        dataset, workers=int(getattr(args, "dataWorkers", 0) or 0),
        depth=int(getattr(args, "prefetchDepth", 2) or 2),
        stage=getattr(args, "stage", None) or "off",
        seed=getattr(args, "seed", 0), device=getattr(args, "platform",
                                                      None))
    args._pipeline = prov
    return ds, prov


def add_test_args(p: argparse.ArgumentParser) -> None:
    _add_platform_arg(p)
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--model", required=True,
                   help="checkpoint dir (its newest model.<n>) or file, the "
                        "port's or the JAX package's")


def add_fused_bn_arg(p: argparse.ArgumentParser) -> None:
    """--fusedBN [off|stats|apply]: the BN kernels for training-mode batch
    norm; a bare --fusedBN means 'stats', as in the JAX package."""
    p.add_argument("--fusedBN", nargs="?", const="stats", default=None,
                   choices=["off", "stats", "apply"],
                   help="BN kernels (ops/bn_kernel.py): 'stats' = the "
                        "stats kernels, apply and dx in PyTorch; 'apply' = "
                        "the fused block, stats+apply+absorbed ReLU in the "
                        "forward kernels, reductions+dx in the backward "
                        "ones. Bare --fusedBN means 'stats'")


def apply_fused_bn(model, mode):
    """Install the --fusedBN choice on a built model (nothing for None or
    'off'). Returns the model."""
    if mode and mode != "off":
        from bigdl_tpu_torch.nn import set_bn_fused
        set_bn_fused(model, mode)
    return model


def add_lint_arg(p: argparse.ArgumentParser) -> None:
    """--lint[=strict]: the lint pre-flight (bigdl_tpu_torch.analysis)
    before the run launches anything: a trace on fake tensors, seconds on
    the CPU. ``strict`` refuses to launch on error-severity findings."""
    p.add_argument("--lint", nargs="?", const="on", default=None,
                   choices=["on", "strict"],
                   help="pre-flight static analysis of the model/config "
                        "(bigdl_tpu_torch.analysis): dtype upcasts, "
                        "in-place state updates, kernel launch plans "
                        "(tiles, shared memory), fusion opportunities "
                        "(unfused BN, GEMM-eligible convs), host syncs, "
                        "the sharded step's collectives. Bare --lint "
                        "prints the report and continues; --lint=strict "
                        "exits nonzero on error-severity findings. "
                        "Findings are stamped into perf JSON lines as "
                        "'lint'")


def run_preflight_lint(report, strict: bool = False, quiet: bool = False):
    """Print one lint report (unless ``quiet``: a rank other than the
    first of a job); returns ``(exit_code, annotation)``: exit_code 0
    means proceed (the annotation is stamped into result JSON), nonzero
    means the caller aborts the launch (strict mode with error-severity
    findings)."""
    if not quiet:
        print(report.render(), flush=True)
    rc = report.exit_code(strict=strict)
    if rc:
        if not quiet:
            print(f"lint: {report.errors} error-severity finding(s) — "
                  "refusing to launch (--lint=strict)", flush=True)
        return rc, None
    return 0, report.annotation()


def _method(args, name: str):
    """The --optimMethod ``name`` with the reference's flags, and the
    ``Default`` lr-decay schedule where the method takes one."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.optim.schedules import Default

    sched = Default(args.learningRateDecay)
    lr, wd = args.learningRate, args.weightDecay
    return {
        "sgd": lambda: optim.SGD(learning_rate=lr, weight_decay=wd,
                                 momentum=args.momentum, schedule=sched),
        "adam": lambda: optim.Adam(learning_rate=lr, schedule=sched),
        "adamw": lambda: optim.AdamW(learning_rate=lr, weight_decay=wd,
                                     schedule=sched),
        # Adagrad and RMSprop carry their own decay knobs, no schedule
        "adagrad": lambda: optim.Adagrad(learning_rate=lr, weight_decay=wd,
                                         lr_decay=args.learningRateDecay),
        "rmsprop": lambda: optim.RMSprop(learning_rate=lr),
        "lars": lambda: optim.LARS(learning_rate=lr, weight_decay=wd,
                                   momentum=args.momentum, schedule=sched),
        "lamb": lambda: optim.LAMB(learning_rate=lr, weight_decay=wd,
                                   schedule=sched),
    }[name]()


def build_optimizer(model, dataset, criterion, args, optim_method=None):
    """The Optimizer the reference's flags describe, with the strategy
    (:func:`build_strategy`), ``--autotune`` (:func:`apply_autotune`), the
    conv layout flags (:func:`apply_conv_args`) and --fusedBN installed:
    ``optim_method``, else the --optimMethod one, ending after
    ``--maxEpoch`` epochs, fed through :func:`build_feed`; an every-epoch
    checkpoint into ``--checkpoint`` and a resume from ``--model`` when
    given; under ``--lint`` the lint pre-flight of its step, which exits
    under ``--lint=strict`` on an error."""
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    strategy = build_strategy(args, model, getattr(args, "batchSize", None))
    apply_autotune(args)
    apply_conv_args(args)
    apply_fused_bn(model, getattr(args, "fusedBN", None))
    method = optim_method or _method(args, getattr(args, "optimMethod",
                                                   "sgd"))
    dataset, _ = build_feed(dataset, args)
    opt = Optimizer(model, dataset, criterion, optim_method=method,
                    end_when=Trigger.max_epoch(args.maxEpoch),
                    seed=args.seed, log_every=args.logEvery,
                    steps_per_dispatch=args.stepsPerDispatch,
                    strategy=strategy, device=args.platform)
    if args.checkpoint:
        if "://" not in args.checkpoint:
            os.makedirs(args.checkpoint, exist_ok=True)
        opt.set_checkpoint(Trigger.every_epoch(), args.checkpoint,
                           overwrite=args.overWriteCheckpoint,
                           keep_last=args.keepCheckpoints)
    if args.model:
        opt.resume(args.model)
    lint_mode = getattr(args, "lint", None)
    if lint_mode:
        # the lint of the step this Optimizer will run
        # (analysis.preflight_optimizer): module rules always, the traced
        # step when the dataset exposes its batch geometry; strict aborts
        # before any step
        from bigdl_tpu_torch.analysis import preflight_optimizer
        rc, _ = run_preflight_lint(preflight_optimizer(opt),
                                   strict=(lint_mode == "strict"),
                                   quiet=_world() > 1 and _rank() != 0)
        if rc:
            raise SystemExit(rc)
    return opt


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def load_trained(model, path: str):
    """Load a checkpoint into ``model`` in place: a directory's newest
    ``model.<n>``, one blob file, or one DCP snapshot directory, local or
    fsspec, written by the port or by the JAX package (reference
    Module.load; ``utils.orbax_ckpt.restore_for_inference``, whose
    ``SystemExit`` lines a missing or corrupt checkpoint raises). Returns
    the model."""
    from bigdl_tpu_torch.utils.orbax_ckpt import restore_for_inference

    params, state = restore_for_inference(path, model)
    model.load_state_dict({**params, **state}, strict=True)
    return model


def evaluate(model, dataset, methods: Optional[Sequence] = None,
             device=None):
    """Evaluate ``model`` over ``dataset`` and print ``<method> is
    <result>`` lines (reference optim/Validator.scala,
    models/*/Test.scala); Top1Accuracy when no method is given."""
    from bigdl_tpu_torch.optim import Top1Accuracy, Validator

    methods = list(methods) if methods else [Top1Accuracy()]
    results = Validator(model, dataset, device).test(methods)
    for m, r in zip(methods, results):
        print(f"{m.name} is {r!r}")
    return results


@dataclasses.dataclass(frozen=True)
class ResolvedConfig:
    """One run configuration, resolved once from the shared flag surface
    (the JAX package's ``ResolvedConfig``): what ``cli.lint`` and every
    ``--lint`` pre-flight hand the analyzer (:func:`resolve_lint_config`),
    and the serving flags ``serve``, the fleet router and every worker
    agree on (:func:`resolve_serve_config`: the topology of
    ``--strategy``, ``serving_replicas`` dp replicas of ``serving_tp``
    ranks each). ``mesh_axes`` is the declared mesh (axis -> size) the
    strategy implies over ``n_devices``; with no real devices the lint
    sizes it over virtual ones."""

    model: str
    batch: int = 32
    seq: Optional[int] = None
    classes: int = 1000
    dtype: str = "bfloat16"
    fused_bn: Optional[str] = None
    conv_layout: Optional[str] = None
    conv_geom: Optional[str] = None
    autotune: str = "off"
    strategy: Optional[str] = None
    strategy_k: Optional[int] = None
    n_devices: int = 1
    mesh_axes: tuple = ()            # ((axis, size), ...): hashable
    grad_compress: str = "off"
    grad_buckets: str = "auto"
    quantize: Optional[str] = None
    speculate: int = 0
    kv_page_tokens: Optional[int] = None
    slots: int = 4
    lint_mode: Optional[str] = None
    trace: bool = True
    serving_replicas: int = 1
    serving_tp: int = 1
    fleet_workers: int = 0

    @property
    def mesh(self) -> dict:
        return dict(self.mesh_axes)

    def make_grad_comm(self):
        """The GradCommConfig this run would build (None when the
        --gradCompress surface is untouched)."""
        if (self.grad_compress or "off") == "off" \
                and self.grad_buckets in (None, "auto"):
            return None
        from bigdl_tpu_torch.parallel.grad_comm import make_config
        try:
            return make_config(self.grad_compress, self.grad_buckets)
        except ValueError as e:
            raise SystemExit(str(e))

    def describe(self) -> dict:
        """Provenance dict (result-JSON / lint-report annotation)."""
        out = {"model": self.model, "batch": self.batch}
        if self.strategy:
            out["strategy"] = (f"{self.strategy}:{self.strategy_k}"
                               if self.strategy_k else self.strategy)
            out["mesh"] = ",".join(f"{a}:{s}" for a, s in self.mesh_axes)
        if (self.grad_compress or "off") != "off":
            out["grad_compress"] = self.grad_compress
        if self.quantize:
            out["quantize"] = self.quantize
        if self.speculate:
            out["speculate"] = self.speculate
        if self.kv_page_tokens:
            out["kv_page_tokens"] = self.kv_page_tokens
        if self.serving_replicas > 1 or self.serving_tp > 1:
            out["serving_replicas"] = self.serving_replicas
            out["serving_tp"] = self.serving_tp
        if self.fleet_workers:
            out["fleet_workers"] = self.fleet_workers
        return out


def _virtual_mesh_devices(name: str, k: Optional[int]) -> tuple:
    """(n_devices, k) sized for a lint with no real devices: enough
    virtual ranks that the strategy's default shape exists."""
    if name == "dp":
        return 8, None
    if name in ("tp", "sp"):
        kk = k or 4
        return 2 * kk, kk
    if name == "pp":
        kk = k or 2
        return 2 * kk, kk
    if name == "ep":
        return (k or 8), (k or 8)
    raise SystemExit(f"unknown strategy {name!r}")


def _int_or_none(v) -> Optional[int]:
    """An integer flag value, or None ('auto' and the like)."""
    return int(v) if v and str(v).lstrip("-").isdigit() else None


def resolve_lint_config(args, *, n_devices: Optional[int] = None
                        ) -> ResolvedConfig:
    """Resolve the shared flag families on ``args`` into one
    :class:`ResolvedConfig`. ``n_devices=None`` (the lint CLI: no job)
    sizes the strategy over virtual ranks, traced over a fake process
    group, so nothing is allocated; a pre-flight of a real run passes its
    rank count."""
    name, k = parse_strategy_spec(getattr(args, "strategy", None))
    mesh_axes: tuple = ()
    n = int(n_devices or 1)
    if name is not None:
        if n_devices is None:
            n, k = _virtual_mesh_devices(name, k)
        axes = strategy_mesh_axes(name, n, k)
        mesh_axes = tuple((str(a), int(s)) for a, s in axes.items())
    quantize = getattr(args, "quantize", None)
    if quantize == "off":
        quantize = None
    if quantize is not None and quantize not in QUANTIZE_CHOICES:
        raise SystemExit(f"--quantize {quantize!r}: must be one of "
                         f"{'/'.join(QUANTIZE_CHOICES)}")
    return ResolvedConfig(
        model=getattr(args, "model", None) or "",
        batch=int(getattr(args, "batchSize", 32) or 32),
        seq=getattr(args, "seq", None),
        classes=int(getattr(args, "classes", 1000) or 1000),
        dtype=("float32" if getattr(args, "f32", False) else "bfloat16"),
        fused_bn=getattr(args, "fusedBN", None),
        conv_layout=getattr(args, "convLayout", None),
        conv_geom=getattr(args, "convGeom", None),
        autotune=getattr(args, "autotune", "off") or "off",
        strategy=name, strategy_k=k, n_devices=n, mesh_axes=mesh_axes,
        grad_compress=getattr(args, "gradCompress", "off") or "off",
        grad_buckets=getattr(args, "gradBuckets", "auto") or "auto",
        quantize=quantize,
        speculate=int(getattr(args, "speculate", 0) or 0),
        # serve spells --kvPageTokens 'auto' too; the lint needs a number
        kv_page_tokens=_int_or_none(getattr(args, "kvPageTokens", None)),
        slots=int(getattr(args, "slots", 4) or 4),
        lint_mode=getattr(args, "lint", None),
        trace=not getattr(args, "no_trace", False))


# the serving --strategy grammar: tp[:K] shards one engine over K ranks,
# dp[:N] runs N engine replicas, dp:N+tp:K composes them (the JAX
# package's); there is no implicit data axis
SERVING_STRATEGY_CHOICES = ("dp", "tp")


def parse_serving_strategy(spec: Optional[str], n_devices: int):
    """``"tp[:K] | dp[:N] | dp:N+tp:K"`` -> ``(replicas, tp_k)`` (the JAX
    function's rules): an omitted size takes every device (``tp``) or one
    replica a device (``dp``), in the composed form what the other axis
    leaves; ``replicas * tp_k`` must fit ``n_devices``. None -> (1, 1)."""
    n = int(n_devices)
    if not spec:
        return 1, 1
    replicas: Optional[int] = None
    tp_k: Optional[int] = None
    seen_dp = seen_tp = False
    for part in str(spec).split("+"):
        name, _, k = part.strip().partition(":")
        if name not in SERVING_STRATEGY_CHOICES:
            raise SystemExit(
                f"serve --strategy {spec!r}: unknown axis {name!r}; the "
                f"serving grammar is tp[:K], dp[:N], or dp:N+tp:K")
        try:
            kk = int(k) if k else None
        except ValueError:
            raise SystemExit(f"serve --strategy {spec!r}: axis size in "
                             f"{part!r} must be an integer")
        if kk is not None and kk < 1:
            raise SystemExit(f"serve --strategy {spec!r}: axis size in "
                             f"{part!r} must be >= 1")
        if name == "dp":
            if seen_dp:
                raise SystemExit(f"serve --strategy {spec!r}: dp given "
                                 f"twice")
            seen_dp, replicas = True, kk
        else:
            if seen_tp:
                raise SystemExit(f"serve --strategy {spec!r}: tp given "
                                 f"twice")
            seen_tp, tp_k = True, kk
    if seen_tp and tp_k is None:
        tp_k = max(n // (replicas or 1), 1) if seen_dp else max(n, 1)
    if seen_dp and replicas is None:
        replicas = max(n // (tp_k or 1), 1) if seen_tp else max(n, 1)
    replicas, tp_k = replicas or 1, tp_k or 1
    if replicas * tp_k > n:
        need = replicas * tp_k
        shape = (f"{replicas} replicas x {tp_k}-way tp"
                 if seen_dp and seen_tp else
                 f"{tp_k}-way tp" if seen_tp else
                 f"one device per replica x {replicas} replicas")
        raise SystemExit(
            f"serve --strategy {spec!r} needs {need} devices ({shape}) "
            f"but only {n} are visible; tp:K runs K ranks (torchrun "
            f"--nproc_per_node K; on the CPU with --platform cpu), dp:N "
            f"takes N devices (--devices, e.g. cpu,cpu or cuda:0,cuda:0)")
    return replicas, tp_k


def _virtual_serving_devices(spec: Optional[str]) -> int:
    """A device count to resolve a serving strategy abstractly (the fleet
    router, which imports no torch): large enough for any explicit
    shape."""
    need = 1
    for part in str(spec or "").split("+"):
        _, _, k = part.strip().partition(":")
        if k and str(k).lstrip("-").isdigit():
            need *= max(int(k), 1)
    return max(8, need)


def resolve_serve_config(args, *, n_devices: Optional[int] = None
                         ) -> ResolvedConfig:
    """Resolve the serve/fleet flags once: check ``--strategy`` (over
    ``n_devices``, or abstractly), ``--quantize``, ``--speculate`` and
    ``--fleet``, and record ``--lint``. Pure Python: the fleet router
    calls this before any worker boots, and hands ``--strategy`` to every
    worker; it imports no torch."""
    spec = getattr(args, "strategy", None)
    n = (int(n_devices) if n_devices is not None
         else _virtual_serving_devices(spec))
    replicas, tp_k = parse_serving_strategy(spec, n)
    quantize = getattr(args, "quantize", None)
    if quantize == "off":  # serve spells the default as the string off
        quantize = None
    if quantize is not None and quantize not in QUANTIZE_CHOICES:
        raise SystemExit(f"--quantize {quantize!r}: must be one of "
                         f"{'/'.join(QUANTIZE_CHOICES)}")
    speculate = int(getattr(args, "speculate", 0) or 0)
    if speculate < 0:
        raise SystemExit(f"--speculate {speculate}: draft length must "
                         "be >= 0")
    fleet = int(getattr(args, "fleet", 0) or 0)
    if fleet < 0:
        raise SystemExit(f"--fleet {fleet}: worker count must be >= 0")
    return ResolvedConfig(model=getattr(args, "model", None) or "",
                          quantize=quantize, speculate=speculate,
                          serving_replicas=int(replicas),
                          serving_tp=int(tp_k), fleet_workers=fleet,
                          strategy=spec or None,
                          lint_mode=getattr(args, "lint", None))


def install_fault_plan(args):
    """Activate ``--faultPlan`` process-wide (``BIGDL_FAULT_LOG`` names a
    JSONL file every fired fault is appended to, written before a
    process-fatal kind acts); returns the injector, or None without a
    plan. The entry points call it before they build anything."""
    spec = getattr(args, "faultPlan", None)
    if not spec:
        return None
    from bigdl_tpu_torch.resilience.faults import install_plan, parse_plan
    try:
        plan = parse_plan(spec)
    except ValueError as e:
        raise SystemExit(f"--faultPlan: {e}")
    inj = install_plan(plan, log_path=os.environ.get("BIGDL_FAULT_LOG"))
    logging.getLogger(__name__).info("fault plan installed: %r", plan)
    return inj


def _bucket_bytes(strat, model) -> Optional[int]:
    """The gradient bucket bound ``strat`` resolves for ``model`` at its
    rank count (the tuner's ``grad_comm`` decision, keyed by
    ``n_devices``, else the default), or None without a strategy."""
    if strat is None:
        return None
    from bigdl_tpu_torch.parallel.grad_comm import _resolve_bucket_bytes
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    return _resolve_bucket_bytes(strat.grad_comm, param_bytes,
                                 strat.world)[0]


def _drop_failed_attempt() -> None:
    """Free what a failed attempt held (its model, its optimizer state, a
    step graph and its pool: they sit in reference cycles) before the next
    attempt builds and captures its own."""
    import gc

    gc.collect()
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run_supervised(sup, attempt_fn, elastic: bool):
    """``sup.run(attempt_fn)``; under ``--elastic`` a give-up (fewer
    survivors than ``--minDevices``, or the budget spent) exits with the
    JAX ``elastic: ...`` line."""
    from bigdl_tpu_torch.resilience.supervisor import SupervisorGaveUp
    try:
        return sup.run(attempt_fn)
    except SupervisorGaveUp as e:
        if not elastic:
            raise
        raise SystemExit(f"elastic: {e}")


def run_optimize(make_optimizer, args):
    """``make_optimizer().optimize()``, supervised under ``--supervise``
    or ``--elastic``: each attempt builds a fresh Optimizer (and, in the
    CLIs, a fresh model and dataset: the failed attempt's have moved on)
    and, after the first, resumes from the newest checksum-valid snapshot
    in ``--checkpoint``, so the run replays the seeds and batches of an
    uninterrupted one. Only the retryable faults are retried
    (``RETRYABLE_EXCEPTIONS``, and ``DeviceLossFault`` under
    ``--elastic``); anything else propagates. Under ``--elastic`` each
    attempt probes the surviving ranks first (below ``--minDevices`` the
    run exits with ``elastic: ...``) and records its topology, so a
    reshape is logged with its ``restore_ms`` (the attempt's start to its
    resume: the re-formation, the build and the snapshot's choice; the
    port reads the snapshot when the loop starts) and the bucket bound
    before and after. A ``supervisor:`` line is logged when anything
    fired. Under ``--traceDir`` each attempt's Optimizer drives the one
    capture controller, and the observability state is finalized after
    the run, supervised or not."""
    obs_state = getattr(args, "_obs", None)
    if obs_state is not None and obs_state.capture is not None:
        # every attempt's Optimizer drives the one capture controller
        inner = make_optimizer

        def make_optimizer():
            return inner().set_capture(obs_state.capture)
    try:
        return _run_optimize(make_optimizer, args)
    finally:
        if obs_state is not None:
            obs_state.finalize()


def _run_optimize(make_optimizer, args):
    import json
    import time

    budget = getattr(args, "supervise", None)
    elastic = getattr(args, "elastic", None)
    if budget is None and elastic is None:
        return make_optimizer().optimize()
    from bigdl_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                       Supervisor)
    ckpt_dir = getattr(args, "checkpoint", None)
    policy = RetryPolicy(budget=int(budget if budget is not None else 5),
                         seed=getattr(args, "seed", 0))
    if elastic is not None:
        check_elastic(resolve_strategy(args)[0], elastic)
        _join(args)  # every rank in the group before the roster is read
        from bigdl_tpu_torch.resilience.elastic import ElasticSupervisor
        sup = ElasticSupervisor(policy, batch_policy=elastic,
                                min_devices=getattr(args, "minDevices", 1))
    else:
        sup = Supervisor(policy)

    def attempt(n):
        if n > 0:
            _drop_failed_attempt()
        t0 = time.perf_counter()
        if elastic is not None:
            sup.probe()  # SupervisorGaveUp below --minDevices
        opt = make_optimizer()
        try:
            if n > 0 and ckpt_dir:
                opt.resume(ckpt_dir)
            if elastic is not None:
                strat = opt.strategy
                sup.observe_topology(
                    strat.world if strat is not None else 1,
                    bucket_bytes=_bucket_bytes(strat, opt.model),
                    restore_ms=((time.perf_counter() - t0) * 1000.0
                                if n > 0 else None))
            return opt.optimize()
        except BaseException:
            opt._graph = None  # the step graph goes with the attempt
            raise

    result = run_supervised(sup, attempt, elastic is not None)
    ann = sup.annotation()
    if ann["retries"] or ann["events"]:
        logging.getLogger(__name__).info(
            "supervisor: %s", json.dumps(ann, sort_keys=True))
    return result
