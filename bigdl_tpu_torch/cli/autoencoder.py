"""The autoencoder on MNIST (counterpart of ``bigdl_tpu/cli/autoencoder.py``;
reference models/autoencoder/Train.scala)::

    python -m bigdl_tpu_torch.cli.autoencoder train -f DIR [--adagrad] \\
        [-b 128] [--learningRate 0.05] [--maxEpoch 5] [--platform cpu]

DIR holds the MNIST idx files. Pixels scaled to [0, 1] are reconstructed
by ``autoencoder(32)`` under the MSE criterion, with SGD at the common
flags' defaults or, with ``--adagrad``, Adagrad at ``--learningRate`` (the
reference's example config).
"""

from __future__ import annotations

import argparse

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.autoencoder")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    tr.add_argument("--adagrad", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.models import autoencoder
    from bigdl_tpu_torch.optim import Adagrad

    resolve_device(args.platform)  # refuse before reading the data
    xtr, _ = load_mnist(args.folder, train=True)
    x = xtr.astype(np.float32) / 255.0
    # the target is the flattened input, kept aligned under shuffling
    train = BatchDataSet(x, x.reshape(len(x), -1), args.batchSize,
                         shuffle=True)
    model = autoencoder(32, generator=torch.Generator().manual_seed(
        args.seed))
    method = (Adagrad(learning_rate=args.learningRate) if args.adagrad
              else None)
    return common.build_optimizer(model, train, nn.MSECriterion(), args,
                                  optim_method=method).optimize()


if __name__ == "__main__":
    main()
