"""Label-by-folder image datasets (counterpart of
``bigdl_tpu/dataset/folder.py``; reference DataSet.ImageFolder,
dataset/DataSet.scala:322-379: images under ``root/<class>/xxx.jpg``, one
folder per class, sorted folder names -> label ids).

JPEGs decode through the port's native library where it was built with
libjpeg, other formats through PIL (``streaming.decode_resize``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

__all__ = ["list_image_folder", "load_image_folder", "ImageFolderDataSet",
           "IMAGENET_MEAN", "IMAGENET_STD"]

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp"}

# Per-channel RGB stats on raw 0-255 pixels, baked into the reference's
# ImageNet pipeline (BGRImgNormalizer defaults) — every imagenet-style CLI
# (inception/loadmodel/predict) trains and evaluates with these, so they
# live here, next to the loader they parameterize.
IMAGENET_MEAN = (123.0, 117.0, 104.0)
IMAGENET_STD = (58.4, 57.1, 57.4)


def list_image_folder(root: str) -> tuple[list[str], np.ndarray, list[str]]:
    """Scan ``root/<class>/*`` -> (paths, labels, class_names). Labels are
    0-based ids of the sorted class-folder names (reference ImageFolder
    assigns consecutive ids by folder, DataSet.scala:322-344)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths: list[str] = []
    labels: list[int] = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fn in sorted(os.listdir(cdir)):
            if os.path.splitext(fn)[1].lower() in _EXTS:
                paths.append(os.path.join(cdir, fn))
                labels.append(ci)
    return paths, np.asarray(labels, np.int32), classes


def _decode(path: str, size: Optional[tuple[int, int]]) -> np.ndarray:
    """Scale-to-fill + center crop, the standard eval transform (reference
    BGRImage.readImage). The resize convention lives in ONE place —
    streaming.decode_resize — so eval/predict numerics can't drift from
    the training pipeline's."""
    from bigdl_tpu_torch.dataset.streaming import decode_resize

    with open(path, "rb") as f:
        raw = f.read()
    if size is None:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    img = decode_resize(raw, short_side=None, fill=size)
    th, tw = size
    top = (img.shape[0] - th) // 2
    left = (img.shape[1] - tw) // 2
    return img[top:top + th, left:left + tw]


def load_image_folder(root: str, size: tuple[int, int] = (224, 224),
                      n_threads: int = 8,
                      limit: Optional[int] = None):
    """Eagerly decode a whole image folder into (images[N,H,W,3] uint8,
    labels[N] int32, class_names). Threaded decode (the reference's
    MT decode path, image/MTLabeledBGRImgToBatch.scala)."""
    paths, labels, classes = list_image_folder(root)
    if limit is not None:
        paths, labels = paths[:limit], labels[:limit]
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        images = list(ex.map(lambda p: _decode(p, size), paths))
    return np.stack(images) if images else np.zeros(
        (0, *size, 3), np.uint8), labels, classes


def ImageFolderDataSet(root: str, batch_size: int,
                       size: tuple[int, int] = (224, 224),
                       train: bool = False,
                       mean: Optional[Sequence[float]] = None,
                       std: Optional[Sequence[float]] = None,
                       seed: int = 0, n_threads: int = 8,
                       drop_remainder: bool = True, **kw):
    """Lazy batched image-folder dataset, streaming from disk (the ImageNet
    path — reference DataSet.SeqFileFolder streams Hadoop SequenceFiles).

    Backed by :class:`~bigdl_tpu_torch.dataset.streaming.StreamingImageFolder`:
    ``train=True`` gets **per-sample** random crop + horizontal flip inside
    the multithreaded decode pool (reference MTLabeledBGRImgToBatch
    semantics); eval decodes scale-to-fill + center crop. Extra keyword
    arguments (``short_side``, ``augment``, ``window``, ``hflip``) pass
    through to the streaming pipeline.
    """
    from bigdl_tpu_torch.dataset.streaming import StreamingImageFolder

    return StreamingImageFolder(
        root, batch_size, crop=tuple(size), train=train, mean=mean,
        std=std, seed=seed, n_threads=n_threads,
        drop_remainder=drop_remainder, **kw)
