"""ResNet training CLI (counterpart of ``bigdl_tpu/cli/resnet.py``;
reference models/resnet/Train.scala, TrainImageNet.scala, Test.scala)::

    python -m bigdl_tpu_torch.cli.resnet train --dataset cifar10 -f DIR \\
        [--depth 20] [--fusedBN apply] [--stepsPerDispatch K] \\
        [--dataWorkers N] [--prefetchDepth D] [--stage off|host|device] \\
        [--checkpoint CKPT] [--model CKPT] [--platform cpu]
    python -m bigdl_tpu_torch.cli.resnet train --dataset imagenet -f DIR \\
        [--depth 50] [--classNum 1000] [--s2d] [--convLayout SPEC] ...
    python -m bigdl_tpu_torch.cli.resnet test [--dataset ...] -f DIR \\
        --model CKPT [--depth ...] [--platform cpu]

Two dataset families, as in the reference:

* ``--dataset cifar10`` (default): a depth 6n+2 ResNet on the
  cifar-10-binary files of DIR, trained with the JAX CLI's recipe and
  feed: the native pipeline (``NativePrefetchDataSet``, four C++ threads)
  shuffles each epoch, crops at random (the window is the whole 32 x 32
  image, as in the JAX CLI, so the crop moves nothing), flips at random
  and normalises with the CIFAR training mean and std; SGD with nesterov
  momentum 0.9, weight decay 1e-4, the lr cut by 10x at epochs 81 and
  122, and a Top1Accuracy validation on ``test_batch.bin`` (centred,
  unflipped, in order) every epoch. A native library that does not build
  or load is an error naming the cause: there is no unaugmented fallback.
* ``--dataset imagenet``: depth 18/34/50/101/152 on a label-by-folder
  tree, streamed and augmented per sample at 224 x 224 from ``DIR/train``
  (random crop of a 256-short-side resize, flip, ``IMAGENET_MEAN/STD``)
  and validated with Top-1 and Top-5 on ``DIR/val`` (scale to fill,
  centre crop) when it exists; the lr is cut by 10x at epochs 30, 60 and
  80 (reference TrainImageNet.scala).

``test`` evaluates a checkpoint (a directory's newest ``model.<n>`` or one
file, the port's or the JAX package's) on ``test_batch.bin`` or
``DIR/val`` and prints ``<method> is ...``. ``--s2d`` builds the ImageNet
models with the space-to-depth stem (``models.resnet.SpaceToDepthStem``)
and, without ``--convLayout``, pins the all-NHWC conv layouts, as the JAX
CLI does; with ``--dataset cifar10`` it exits with the JAX message.
``train`` takes ``--convLayout``/``--convGeom`` (``cli.common``).
"""

from __future__ import annotations

import argparse
import os

from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.cli.vgg import _one_split

__all__ = ["main"]


def _imagenet_datasets(folder: str, batch: int):
    """(train, val or None) image-folder streams of ``DIR/train`` and
    ``DIR/val`` at 224 x 224."""
    from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                         ImageFolderDataSet)

    train = ImageFolderDataSet(os.path.join(folder, "train"), batch,
                               size=(224, 224), train=True,
                               mean=IMAGENET_MEAN, std=IMAGENET_STD)
    vdir = os.path.join(folder, "val")
    val = (ImageFolderDataSet(vdir, batch, size=(224, 224),
                              mean=IMAGENET_MEAN, std=IMAGENET_STD)
           if os.path.isdir(vdir) else None)
    return train, val


def _build_model(args, generator):
    from bigdl_tpu_torch.models import resnet, resnet_cifar
    from bigdl_tpu_torch.models.resnet import _IMAGENET_CFG

    if args.dataset == "imagenet":
        if args.depth not in _IMAGENET_CFG:
            raise SystemExit(f"--depth {args.depth} invalid for imagenet; "
                             f"pick one of {sorted(_IMAGENET_CFG)}")
        if args.s2d and not getattr(args, "convLayout", None):
            # the JAX CLI pins all-NHWC under --s2d unless the user chose
            # layouts explicitly
            from bigdl_tpu_torch.ops.conv2d import install_layout_spec
            install_layout_spec("default")
        return resnet(args.depth, args.classNum, s2d_stem=args.s2d,
                      generator=generator)
    if args.s2d:
        raise SystemExit("--s2d applies to --dataset imagenet models only "
                         "(the CIFAR stem is already a 3x3/1 conv)")
    if (args.depth - 2) % 6:
        raise SystemExit(f"--depth {args.depth} invalid for cifar10; depth "
                         f"must be 6n+2 (20/32/44/56/110)")
    return resnet_cifar(args.depth, args.classNum, generator=generator)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", choices=["cifar10", "imagenet"],
                   default="cifar10")
    p.add_argument("--depth", type=int, default=None,
                   help="6n+2 for cifar10 (default 20); 18/34/50/101/152 "
                        "for imagenet (default 50)")
    p.add_argument("--classNum", type=int, default=None,
                   help="default 10 for cifar10, 1000 for imagenet")


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.resnet")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    _add_model_args(tr)
    tr.add_argument("--bnStatSample", type=int, default=None,
                    help="BN training stats from this many batch rows "
                         "(nn.set_bn_stat_sample)")
    tr.add_argument("--s2d", action="store_true",
                    help="space-to-depth stem (imagenet models): 2x2 "
                         "space-to-depth then a 4x4/1 conv, the same "
                         "function as the 7x7/2 stem; pins --convLayout "
                         "default unless one is given")
    tr.set_defaults(weightDecay=1e-4)  # the reference recipe's
    te = sub.add_parser("test")
    common.add_test_args(te)
    _add_model_args(te)
    te.add_argument("--s2d", action="store_true",
                    help="a checkpoint trained with --s2d")
    args = p.parse_args(argv)
    imagenet = args.dataset == "imagenet"
    if args.classNum is None:
        args.classNum = 1000 if imagenet else 10
    if args.depth is None:
        args.depth = 50 if imagenet else 20

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import (SGD, Top1Accuracy, Top5Accuracy,
                                       Trigger)
    from bigdl_tpu_torch.optim.schedules import EpochSchedule, Regime

    common.apply_platform(args)  # refuse before reading the data
    if args.cmd == "train":
        common.apply_conv_args(args)  # before --s2d pins its default

    def build():
        return _build_model(args, torch.Generator().manual_seed(
            getattr(args, "seed", 0)))

    first = [build()]  # refuses what the JAX CLI refuses before any data
    if imagenet:
        _, test = _imagenet_datasets(args.folder, args.batchSize)
        if test is None and args.cmd == "test":
            raise FileNotFoundError(f"no val/ directory under {args.folder}")
        methods = [Top1Accuracy(), Top5Accuracy()]
    else:
        test = _one_split(args.folder, args.batchSize, False, False)
        methods = [Top1Accuracy()]
    if args.cmd == "test":
        model = common.load_trained(first.pop(), args.model)
        return common.evaluate(model, test, methods, device=args.platform)
    lr = args.learningRate
    if imagenet:
        regimes = [Regime(1, 29, lr), Regime(30, 59, lr * 0.1),
                   Regime(60, 79, lr * 0.01), Regime(80, 10 ** 9, lr * 0.001)]
    else:
        regimes = [Regime(1, 80, lr), Regime(81, 121, lr * 0.1),
                   Regime(122, 10 ** 9, lr * 0.01)]

    def _make():  # each attempt from the seed: a failed one moved on
        model = first.pop() if first else build()
        if args.bnStatSample:
            nn.set_bn_stat_sample(model, args.bnStatSample)
        train = (_imagenet_datasets(args.folder, args.batchSize)[0]
                 if imagenet else
                 _one_split(args.folder, args.batchSize, True, True))
        method = SGD(learning_rate=lr, weight_decay=args.weightDecay,
                     momentum=args.momentum, dampening=0.0,
                     nesterov=args.momentum > 0,
                     schedule=EpochSchedule(regimes))
        opt = common.build_optimizer(model, train, nn.ClassNLLCriterion(),
                                     args, optim_method=method)
        if test is not None:
            opt.set_validation(Trigger.every_epoch(), test, methods)
        return opt

    return common.run_optimize(_make, args)


if __name__ == "__main__":
    main()
