"""ResNet training CLI (counterpart of ``bigdl_tpu/cli/resnet.py``;
reference models/resnet/Train.scala, Test.scala)::

    python -m bigdl_tpu_torch.cli.resnet train --dataset cifar10 -f DIR \\
        [--depth 20] [--fusedBN apply] [--stepsPerDispatch K] \\
        [--checkpoint CKPT] [--model CKPT] [--platform cpu]
    python -m bigdl_tpu_torch.cli.resnet test -f DIR --model CKPT \\
        [--depth 20] [--platform cpu]

trains a depth 6n+2 ResNet on the cifar-10-binary files of DIR with the
reference recipe: SGD with nesterov momentum 0.9, weight decay 1e-4 and
the lr cut by 10x at epochs 81 and 122, and a Top1Accuracy validation on
``test_batch.bin`` every epoch. Images are normalised with the CIFAR
training mean and std and shuffled each epoch; the JAX package's native
pipeline (random crop and flip) is not in the port yet, so there is no
augmentation (ROADMAP.md queue 1 item 9). ``test`` evaluates a
checkpoint (a directory's newest ``model.<n>`` or one file, the port's or
the JAX package's) on ``test_batch.bin`` and prints ``top1 accuracy is
...``. ``--dataset imagenet`` and ``--s2d`` raise, naming the work that
brings them.
"""

from __future__ import annotations

import argparse

import numpy as np

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def _one_split(folder: str, batch: int, train_split: bool, augment: bool):
    """A normalised BatchDataSet of one split, shuffled when
    ``augment`` (the JAX package's pure-python branch)."""
    from bigdl_tpu_torch.dataset import (TRAIN_MEAN, TRAIN_STD, BatchDataSet,
                                         load_cifar10)

    mean = np.asarray([m * 255 for m in TRAIN_MEAN], np.float32)
    std = np.asarray([s * 255 for s in TRAIN_STD], np.float32)
    x, y = load_cifar10(folder, train=train_split)
    return BatchDataSet((x.astype(np.float32) - mean) / std, y, batch,
                        shuffle=augment)


def _later(what: str, item: int, brings: str):
    return SystemExit(f"{what} is not in the PyTorch port yet: it comes with "
                      f"{brings} (ROADMAP.md queue 1 item {item})")


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.resnet")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    tr.add_argument("--dataset", choices=["cifar10", "imagenet"],
                    default="cifar10")
    tr.add_argument("--depth", type=int, default=20,
                    help="6n+2 (20/32/44/56/110)")
    tr.add_argument("--classNum", type=int, default=10)
    tr.add_argument("--bnStatSample", type=int, default=None,
                    help="BN training stats from this many batch rows "
                         "(nn.set_bn_stat_sample)")
    tr.add_argument("--s2d", action="store_true",
                    help="space-to-depth stem (imagenet models; not ported)")
    tr.set_defaults(weightDecay=1e-4)  # the reference recipe's
    te = sub.add_parser("test")
    common.add_test_args(te)
    te.add_argument("--dataset", choices=["cifar10", "imagenet"],
                    default="cifar10")
    te.add_argument("--depth", type=int, default=20)
    te.add_argument("--classNum", type=int, default=10)
    te.add_argument("--s2d", action="store_true",
                    help="a checkpoint trained with --s2d (not ported)")
    args = p.parse_args(argv)

    if args.dataset == "imagenet":
        raise _later("--dataset imagenet", 9, "dataset/folder.py")
    if args.s2d:
        raise _later("--s2d", 7, "SpaceToDepthStem")
    if (args.depth - 2) % 6:
        raise SystemExit(f"--depth {args.depth} invalid for cifar10; depth "
                         f"must be 6n+2 (20/32/44/56/110)")

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.models import resnet_cifar
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.schedules import EpochSchedule, Regime

    resolve_device(args.platform)  # refuse before reading the data
    model = resnet_cifar(args.depth, args.classNum,
                         generator=torch.Generator().manual_seed(
                             getattr(args, "seed", 0)))
    test = _one_split(args.folder, args.batchSize, False, False)
    if args.cmd == "test":
        common.load_trained(model, args.model)
        return common.evaluate(model, test, device=args.platform)
    if args.bnStatSample:
        nn.set_bn_stat_sample(model, args.bnStatSample)
    train = _one_split(args.folder, args.batchSize, True, True)
    lr = args.learningRate
    sched = EpochSchedule([Regime(1, 80, lr), Regime(81, 121, lr * 0.1),
                           Regime(122, 10 ** 9, lr * 0.01)])
    method = SGD(learning_rate=lr, weight_decay=args.weightDecay,
                 momentum=args.momentum, dampening=0.0,
                 nesterov=args.momentum > 0, schedule=sched)
    opt = common.build_optimizer(model, train, nn.ClassNLLCriterion(), args,
                                 optim_method=method)
    opt.set_validation(Trigger.every_epoch(), test, [Top1Accuracy()])
    return opt.optimize()


if __name__ == "__main__":
    main()
