"""MNIST idx-ubyte reader (counterpart of ``bigdl_tpu/dataset/mnist.py``;
reference models/lenet/Utils.scala raw readers), plain or ``.gz``.

Images come back (N, 28, 28, 1) uint8 (NHWC) and labels (N,) int32,
0-based, the same arrays as the JAX package's reader gives.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["load_images", "load_labels", "load_mnist",
           "TRAIN_MEAN", "TRAIN_STD"]

# the MNIST training set's pixel mean and std on [0, 1] (reference
# models/lenet/Utils.scala trainMean/trainStd)
TRAIN_MEAN = 0.13066047740239506
TRAIN_STD = 0.3081078

_IMG_MAGIC = 2051
_LBL_MAGIC = 2049


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def load_images(path: str) -> np.ndarray:
    """(N, rows, cols, 1) uint8 images of an idx3 file."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IMG_MAGIC:
            raise ValueError(f"bad MNIST image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def load_labels(path: str) -> np.ndarray:
    """(N,) int32 labels of an idx1 file."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _LBL_MAGIC:
            raise ValueError(f"bad MNIST label magic {magic} in {path}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int32)


def load_mnist(folder: str, train: bool = True):
    """(images, labels) of ``folder``'s ``train-*`` or ``t10k-*`` idx
    files, plain before ``.gz``."""
    stem = "train" if train else "t10k"
    for suffix in ("", ".gz"):
        ip = os.path.join(folder, f"{stem}-images-idx3-ubyte{suffix}")
        lp = os.path.join(folder, f"{stem}-labels-idx1-ubyte{suffix}")
        if os.path.exists(ip) and os.path.exists(lp):
            return load_images(ip), load_labels(lp)
    raise FileNotFoundError(f"MNIST files for '{stem}' not in {folder}")
