"""VGG on CIFAR-10 (counterpart of ``bigdl_tpu/cli/vgg.py``; reference
models/vgg/{Train,Test}.scala)::

    python -m bigdl_tpu_torch.cli.vgg train -f DIR [-b 128] \\
        [--fusedBN stats|apply] [--maxEpoch 5] [--stepsPerDispatch K] \\
        [--checkpoint CKPT] [--model CKPT] [--platform cpu]
    python -m bigdl_tpu_torch.cli.vgg test -f DIR --model CKPT \\
        [--platform cpu]

DIR holds the cifar-10-binary files. ``vgg_for_cifar10(10)`` trains on
the native pipeline's augmented batches (shuffle, random crop and flip,
the CIFAR training mean and std on 0-255 pixels) with SGD at the common
flags' defaults, and validates Top-1 on ``test_batch.bin`` (centred,
unflipped, in order) every epoch. ``--fusedBN apply`` runs its 14 BNs
through the fused BN kernels (each absorbing the ReLU after it),
``--fusedBN stats`` through the stats kernels. ``test`` evaluates a
checkpoint, the port's or the JAX CLI's.
"""

from __future__ import annotations

import argparse

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def _one_split(folder: str, batch: int, train_split: bool, augment: bool):
    """One CIFAR split through the native pipeline: with ``augment``
    shuffled each epoch, randomly cropped and flipped; normalised with
    the training mean and std on 0-255 pixels (the JAX CLI's
    ``_one_split``). A native library that does not build or load raises
    with its cause: unlike the JAX CLI, there is no unaugmented
    fallback."""
    from bigdl_tpu_torch.dataset import (TRAIN_MEAN, TRAIN_STD,
                                         NativePrefetchDataSet, load_cifar10)

    x, y = load_cifar10(folder, train=train_split)
    return NativePrefetchDataSet(x, y, batch, train=augment,
                                 mean=[m * 255 for m in TRAIN_MEAN],
                                 std=[s * 255 for s in TRAIN_STD])


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.vgg")
    sub = p.add_subparsers(dest="cmd", required=True)
    common.add_train_args(sub.add_parser("train"))
    common.add_test_args(sub.add_parser("test"))
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import vgg_for_cifar10
    from bigdl_tpu_torch.optim import Top1Accuracy, Trigger

    common.apply_platform(args)  # refuse before reading the data

    def build():
        return vgg_for_cifar10(10, generator=torch.Generator().manual_seed(
            getattr(args, "seed", 0)))

    test = _one_split(args.folder, args.batchSize, False, False)
    if args.cmd == "test":
        model = common.load_trained(build(), args.model)
        return common.evaluate(model, test, device=args.platform)

    def _make():  # each attempt from the seed: a failed one moved on
        opt = common.build_optimizer(
            build(), _one_split(args.folder, args.batchSize, True, True),
            nn.ClassNLLCriterion(), args)
        opt.set_validation(Trigger.every_epoch(), test, [Top1Accuracy()])
        return opt

    return common.run_optimize(_make, args)


if __name__ == "__main__":
    main()
