"""What the port's training CLIs share (counterpart of
``bigdl_tpu/cli/common.py``): the training flags and building the
Optimizer. Flags of features the port does not have yet are not parsed,
so argparse refuses them."""

from __future__ import annotations

import argparse
import logging

__all__ = ["setup_logging", "add_train_args", "build_optimizer",
           "OPTIM_METHODS"]

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


def build_optimizer(model, dataset, criterion, args):
    """The Optimizer the reference's flags describe: SGD or Adam with the
    ``Default`` lr-decay schedule, ending after ``--maxEpoch`` epochs."""
    from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, Trigger
    from bigdl_tpu_torch.optim.schedules import Default

    sched = Default(args.learningRateDecay)
    name = getattr(args, "optimMethod", "sgd")
    if name == "sgd":
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

