"""LeNet-5 on MNIST (counterpart of ``bigdl_tpu/cli/lenet.py``; reference
models/lenet/{Train,Test}.scala)::

    python -m bigdl_tpu_torch.cli.lenet train -f DIR [-b 128] \\
        [--maxEpoch 5] [--checkpoint CKPT] [--model CKPT] [--platform cpu]
    python -m bigdl_tpu_torch.cli.lenet test -f DIR --model CKPT \\
        [--platform cpu]

DIR holds the MNIST idx files (``train-images-idx3-ubyte``, ... plain or
``.gz``). Pixels are scaled to [0, 1] and normalised with the MNIST
training mean and std; training shuffles each epoch, takes SGD with the
common flags' defaults (``--learningRate 0.05``, ``--momentum 0.9``) and
validates Top-1 on the ``t10k`` files every epoch. ``test`` evaluates a
checkpoint, the port's or one the JAX CLI wrote (a directory's newest
``model.<n>`` or one file), and prints ``top1 accuracy is ...``.
"""

from __future__ import annotations

import argparse

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def _one_split(folder: str, batch: int, train_split: bool):
    """One MNIST split as a BatchDataSet, normalised, shuffled for
    training (the JAX CLI's ``_one_split``)."""
    import numpy as np

    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.dataset.mnist import (TRAIN_MEAN, TRAIN_STD,
                                               load_mnist)

    x, y = load_mnist(folder, train=train_split)
    xn = ((x.astype(np.float32) / 255.0) - TRAIN_MEAN) / TRAIN_STD
    return BatchDataSet(xn, y, batch, shuffle=train_split)


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.lenet")
    sub = p.add_subparsers(dest="cmd", required=True)
    common.add_train_args(sub.add_parser("train"))
    common.add_test_args(sub.add_parser("test"))
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.models import lenet5
    from bigdl_tpu_torch.optim import Top1Accuracy, Trigger

    resolve_device(args.platform)  # refuse before reading the data
    model = lenet5(10, generator=torch.Generator().manual_seed(
        getattr(args, "seed", 0)))
    test = _one_split(args.folder, args.batchSize, False)
    if args.cmd == "test":
        common.load_trained(model, args.model)
        return common.evaluate(model, test, device=args.platform)
    train = _one_split(args.folder, args.batchSize, True)
    opt = common.build_optimizer(model, train, nn.ClassNLLCriterion(), args)
    opt.set_validation(Trigger.every_epoch(), test, [Top1Accuracy()])
    return opt.optimize()


if __name__ == "__main__":
    main()
