"""CIFAR-10 binary reader (counterpart of ``bigdl_tpu/dataset/cifar.py``):
the cifar-10-binary format, 3073-byte records of 1 label byte and 3072
pixel bytes in CHW order. ``load_cifar10`` returns (N, 32, 32, 3) uint8
RGB images and int32 labels; TRAIN_MEAN/TRAIN_STD are the per-channel
training statistics over pixels scaled to [0, 1]."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_cifar10", "TRAIN_MEAN", "TRAIN_STD"]

TRAIN_MEAN = (0.4914, 0.4822, 0.4465)
TRAIN_STD = (0.2470, 0.2435, 0.2616)

_REC = 3073


def _read_bin(path: str):
    raw = np.fromfile(path, np.uint8)
    if raw.size % _REC:
        raise ValueError(f"{path}: {raw.size} bytes is not a whole number "
                         f"of {_REC}-byte cifar-10 records")
    raw = raw.reshape(-1, _REC)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs, labels


def load_cifar10(folder: str, train: bool = True):
    """The five ``data_batch_<i>.bin`` files of ``folder`` (train) or its
    ``test_batch.bin``, concatenated."""
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    imgs, labels = [], []
    for n in names:
        p = os.path.join(folder, n)
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        i, lab = _read_bin(p)
        imgs.append(i)
        labels.append(lab)
    return np.concatenate(imgs), np.concatenate(labels)
