"""What the port's training CLIs share (counterpart of
``bigdl_tpu/cli/common.py``): the training flags and building the
Optimizer. Flags of features the port does not have yet are not parsed,
so argparse refuses them."""

from __future__ import annotations

import argparse
import logging

__all__ = ["setup_logging", "add_train_args", "add_fused_bn_arg",
           "apply_fused_bn", "build_optimizer", "OPTIM_METHODS"]

# --optimMethod choices of the JAX package; the port has the first two
OPTIM_METHODS = ("sgd", "adam", "adamw", "adagrad", "rmsprop", "lars", "lamb")


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The reference's common training knobs, with ``--platform`` picking
    the device (cuda unless the CPU is asked for)."""
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="device to train on (default cuda); cpu runs the "
                        "kernels' plain versions")
    p.add_argument("-f", "--folder", default="./", help="data folder")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--learningRate", type=float, default=0.05)
    p.add_argument("--learningRateDecay", type=float, default=0.0)
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--maxEpoch", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--logEvery", type=int, default=10)
    p.add_argument("--optimMethod", default="sgd", choices=OPTIM_METHODS,
                   help="sgd (BigDL defaults: dampening = momentum) or "
                        "adam; the others come with a later slice")
    add_fused_bn_arg(p)


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


def build_optimizer(model, dataset, criterion, args, optim_method=None):
    """The Optimizer the reference's flags describe, with --fusedBN
    installed on the model: ``optim_method``, else SGD or Adam with the
    ``Default`` lr-decay schedule, ending after ``--maxEpoch`` epochs."""
    from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, Trigger
    from bigdl_tpu_torch.optim.schedules import Default

    apply_fused_bn(model, getattr(args, "fusedBN", None))
    sched = Default(args.learningRateDecay)
    name = getattr(args, "optimMethod", "sgd")
    if optim_method is not None:
        method = optim_method
    elif name == "sgd":
        method = SGD(learning_rate=args.learningRate,
                     weight_decay=args.weightDecay, momentum=args.momentum,
                     schedule=sched)
    elif name == "adam":
        method = Adam(learning_rate=args.learningRate, schedule=sched)
    else:
        raise SystemExit(f"--optimMethod {name} is not in the PyTorch port "
                         f"yet: it comes with the rest of optim/ (ROADMAP.md "
                         f"queue 1 item 6); use sgd or adam")
    return Optimizer(model, dataset, criterion, optim_method=method,
                     end_when=Trigger.max_epoch(args.maxEpoch),
                     seed=args.seed, log_every=args.logEvery,
                     device=args.platform)

