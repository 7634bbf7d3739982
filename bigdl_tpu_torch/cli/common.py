"""What the port's training CLIs share (counterpart of
``bigdl_tpu/cli/common.py``): the training and test flags, the
data-parallel strategy (``--strategy dp``, ``--gradCompress``,
``--gradBuckets``), building the Optimizer, loading a trained checkpoint
and evaluating it; for ``serve``, the fleet router and its workers, the
one parse of the serving flags (:func:`resolve_serve_config`) and the
``--faultPlan`` install. Flags of features the port does not have yet are not
parsed, so argparse refuses them; the strategies and ``--elastic`` are
parsed and refused by name.

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
           "GRAD_COMPRESS_CHOICES", "QUANTIZE_CHOICES", "ResolvedConfig",
           "resolve_serve_config", "install_fault_plan"]

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
    """--strategy NAME[:K] and --elastic, with the JAX CLIs' spellings."""
    p.add_argument("--strategy", default=None, metavar="NAME[:K]",
                   help="multi-device training strategy: dp = data "
                        "parallel over the ranks of a torchrun job, one "
                        "process a GPU (ZeRO-1 optimizer state, batch "
                        "norm over the global batch). tp, sp, pp and ep "
                        "are not in the PyTorch port yet. Replaces the "
                        "deprecated --dataParallel")
    p.add_argument("--elastic", default=None, metavar="POLICY",
                   help="elastic data parallelism: not in the PyTorch "
                        "port yet (refused)")


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


def _refuse_unported(name: str) -> None:
    if name != "dp":
        raise SystemExit(
            f"--strategy {name} is not in the PyTorch port yet: tensor, "
            f"sequence, pipeline and expert parallelism come with "
            f"ROADMAP.md queue 1 entry 13; the port has dp")


def strategy_mesh_axes(name: str, n_devices: int, k: Optional[int] = None
                       ) -> dict:
    """The mesh axes of ``name`` over ``n_devices``: ``{"data": n}`` for
    dp; the other strategies exit by name."""
    _refuse_unported(name)
    return {"data": int(n_devices)}


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
                        "'auto' = the 4 MiB default; an integer N pins it "
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


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def build_strategy(args, model=None, batch: Optional[int] = None):
    """The ``DataParallel`` that ``--strategy dp`` (or ``--dataParallel``)
    asks for, over the ranks of this torchrun job (joined here with
    ``init_distributed``: gloo under ``--platform cpu``), or None. Exits
    as the JAX CLIs do: ``--elastic`` and the strategies other than dp by
    name; ``--strategy dp`` in one process naming ``torchrun`` (the
    deprecated alias then means nothing); ``--stepsPerDispatch`` or
    ``--innerSteps`` > 1; a global ``batch`` the ranks do not divide."""
    name, k = resolve_strategy(args)
    if getattr(args, "elastic", None) is not None:
        raise SystemExit("--elastic is not in the PyTorch port yet: "
                         "elastic data parallelism comes with ROADMAP.md "
                         "queue 1 entry 12 (resilience/)")
    if name is None:
        return None
    _refuse_unported(name)
    from bigdl_tpu_torch.parallel import DataParallel, init_distributed
    from bigdl_tpu_torch.parallel import make_mesh
    init_distributed(backend="gloo" if getattr(args, "platform", None)
                     == "cpu" else None)
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
    if batch is not None and batch % n:
        raise SystemExit(f"batch {batch} must be divisible by the data "
                         f"axis ({n}) of --strategy {name} (mesh "
                         f"{strategy_mesh_axes(name, n, k)})")
    return DataParallel(make_mesh(strategy_mesh_axes(name, n, k)),
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
    (:func:`build_strategy`), the conv layout flags
    (:func:`apply_conv_args`) and --fusedBN installed:
    ``optim_method``, else the --optimMethod one, ending after
    ``--maxEpoch`` epochs, fed through :func:`build_feed`; an every-epoch
    checkpoint into ``--checkpoint`` and a resume from ``--model`` when
    given."""
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    strategy = build_strategy(args, model, getattr(args, "batchSize", None))
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
        os.makedirs(args.checkpoint, exist_ok=True)
        opt.set_checkpoint(Trigger.every_epoch(), args.checkpoint,
                           overwrite=args.overWriteCheckpoint,
                           keep_last=args.keepCheckpoints)
    if args.model:
        opt.resume(args.model)
    return opt


def load_trained(model, path: str):
    """Load a checkpoint into ``model`` in place: a directory's newest
    ``model.<n>``, or one file, written by the port or by the JAX package
    (reference Module.load). Returns the model."""
    from bigdl_tpu_torch.interop.checkpoint import load_model
    from bigdl_tpu_torch.utils.file import latest_checkpoint

    p = path
    if os.path.isdir(path):
        p = latest_checkpoint(path, "model.")
        if p is None:
            raise FileNotFoundError(f"no model.<n> checkpoint in {path}")
    tensors, _ = load_model(p, model)
    model.load_state_dict(tensors, strict=True)
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
    """The serving flags resolved once (the fields of the JAX package's
    ``ResolvedConfig`` that serving reads), so ``serve``, the fleet
    router and every worker agree on one parse. The serving topology is
    one replica of one shard until ``--strategy`` is ported."""

    model: str
    quantize: Optional[str] = None
    speculate: int = 0
    serving_replicas: int = 1
    serving_tp: int = 1
    fleet_workers: int = 0


def resolve_serve_config(args) -> ResolvedConfig:
    """Resolve the serve/fleet flags once: refuse the flags the port does
    not have yet (naming their ROADMAP.md entry), and check
    ``--quantize``, ``--speculate`` and ``--fleet``. Pure Python: the
    fleet router calls this before any worker boots and imports no
    torch."""
    from bigdl_tpu_torch.cli.serve import refuse_later_flags

    refuse_later_flags(args)
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
                          fleet_workers=fleet)


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
