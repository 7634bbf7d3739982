"""Inception-v1/v2 on ImageNet-style image folders (counterpart of
``bigdl_tpu/cli/inception.py``; reference models/inception/{Train,Test,
Options}.scala, the Poly lr schedule Train.scala:77-83)::

    python -m bigdl_tpu_torch.cli.inception train -f DIR \\
        [--modelName inception_v1|inception_v2] [--classNum 1000] \\
        [--maxIteration 62000] [-b 128] [--fusedBN stats|apply] \\
        [--checkpoint CKPT] [--model CKPT] [--platform cpu]
    python -m bigdl_tpu_torch.cli.inception test -f DIR --model CKPT \\
        [--modelName ...] [--classNum ...] [--platform cpu]

DIR holds ``train/<class>/*.jpg`` and ``val/<class>/*.jpg``, streamed at
224 x 224 (``train/``: random crop of a 256-short-side resize and flip;
``val/``: scale to fill and centre crop; ``IMAGENET_MEAN``/``STD``).
``inception_v1`` is GoogLeNet without its aux classifiers
(``inception_v1_no_aux``), as in the JAX CLI; ``inception_v2`` is
BN-Inception, whose 57 BNs take ``--fusedBN``. Training is SGD at
``--learningRate`` under ``Poly(0.5, --maxIteration)`` with a Top-1 and
Top-5 validation on ``val/`` every epoch when it exists; ``test``
evaluates a checkpoint, the port's or the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

from bigdl_tpu_torch.cli import common

__all__ = ["main"]

_MODELS = ("inception_v1", "inception_v2")


def _train_dataset(folder: str, batch: int):
    from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                         ImageFolderDataSet)

    return ImageFolderDataSet(os.path.join(folder, "train"), batch,
                              size=(224, 224), train=True,
                              mean=IMAGENET_MEAN, std=IMAGENET_STD)


def _val_dataset(folder: str, batch: int):
    from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                         ImageFolderDataSet)

    vdir = os.path.join(folder, "val")
    return (ImageFolderDataSet(vdir, batch, size=(224, 224),
                               mean=IMAGENET_MEAN, std=IMAGENET_STD)
            if os.path.isdir(vdir) else None)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--modelName", choices=list(_MODELS),
                   default="inception_v1")
    p.add_argument("--classNum", type=int, default=1000)


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.inception")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    _add_model_args(tr)
    tr.add_argument("--maxIteration", type=int, default=62000)
    te = sub.add_parser("test")
    common.add_test_args(te)
    _add_model_args(te)
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.models import inception_v1_no_aux, inception_v2
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Top5Accuracy, Trigger
    from bigdl_tpu_torch.optim.schedules import Poly

    resolve_device(args.platform)  # refuse before reading the data
    build = (inception_v1_no_aux if args.modelName == "inception_v1"
             else inception_v2)
    model = build(args.classNum, generator=torch.Generator().manual_seed(
        getattr(args, "seed", 0)))
    methods = [Top1Accuracy(), Top5Accuracy()]
    if args.cmd == "train":
        train = _train_dataset(args.folder, args.batchSize)
        val = _val_dataset(args.folder, args.batchSize)
        # reference hyperparams: lr 0.0898, Poly(0.5, 62000)
        method = SGD(learning_rate=args.learningRate,
                     schedule=Poly(0.5, args.maxIteration))
        opt = common.build_optimizer(model, train, nn.ClassNLLCriterion(),
                                     args, optim_method=method)
        if val is not None:
            opt.set_validation(Trigger.every_epoch(), val, methods)
        return opt.optimize()
    common.load_trained(model, args.model)
    val = _val_dataset(args.folder, args.batchSize)
    if val is None:
        raise FileNotFoundError(
            f"no val/ directory under {args.folder} — `inception test` "
            f"needs {args.folder}/val/<class>/*.jpg")
    return common.evaluate(model, val, methods, device=args.platform)


if __name__ == "__main__":
    main()
