"""What the port's training CLIs share (counterpart of
``bigdl_tpu/cli/common.py``): the training and test flags, building the
Optimizer, loading a trained checkpoint and evaluating it. Flags of
features the port does not have yet are not parsed, so argparse refuses
them."""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

__all__ = ["setup_logging", "add_train_args", "add_test_args",
           "add_fused_bn_arg", "apply_fused_bn", "build_optimizer",
           "load_trained", "evaluate", "OPTIM_METHODS"]

OPTIM_METHODS = ("sgd", "adam", "adamw", "adagrad", "rmsprop", "lars", "lamb")


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
    """The Optimizer the reference's flags describe, with --fusedBN
    installed on the model: ``optim_method``, else the --optimMethod one,
    ending after ``--maxEpoch`` epochs; an every-epoch checkpoint into
    ``--checkpoint`` and a resume from ``--model`` when given."""
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    apply_fused_bn(model, getattr(args, "fusedBN", None))
    method = optim_method or _method(args, getattr(args, "optimMethod",
                                                   "sgd"))
    opt = Optimizer(model, dataset, criterion, optim_method=method,
                    end_when=Trigger.max_epoch(args.maxEpoch),
                    seed=args.seed, log_every=args.logEvery,
                    steps_per_dispatch=args.stepsPerDispatch,
                    device=args.platform)
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
