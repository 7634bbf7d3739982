"""Batch image prediction over a folder (counterpart of
``bigdl_tpu/cli/predict.py``; reference example/imageclassification/
ImagePredictor.scala:34-82, DLClassifier over a folder of images)::

    python -m bigdl_tpu_torch.cli.predict --model CKPT --modelName lenet \\
        -f /path/to/images [--topN 5]

``--model`` is a whole-model file (``utils.file.save_module``: it carries
its definition, so no ``--modelName`` rebuild is needed) or a checkpoint
(a directory's newest ``model.<n>``, or one file, the port's or the JAX
package's), loaded into the ``--modelName`` model. A whole-model file of
the JAX package cannot be unpickled without ``bigdl_tpu``: it is refused
by name and its weights are loaded into the rebuilt model. Each line is
``<path>\\t<top-N class ids>``. The forwards run through an
:class:`~bigdl_tpu_torch.serving.engine.InferenceEngine` with power-of-two
batch buckets up to ``-b`` (CUDA graphs on the card), so the tail pads to
a bucket.
"""

from __future__ import annotations

import argparse
import logging
import os

from bigdl_tpu_torch.cli import common

__all__ = ["build_parser", "main"]

MODEL_NAMES = ("lenet", "alexnet", "inception_v1", "resnet50", "vgg16")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.predict")
    p.add_argument("--model", required=True,
                   help="checkpoint dir or file. Whole-model files embed "
                        "their definition as a pickle: only load files "
                        "you produced (same trust model as the "
                        "reference's Java deserialization)")
    p.add_argument("--modelName", default="lenet", choices=MODEL_NAMES)
    p.add_argument("-f", "--folder", required=True,
                   help="folder of images (flat or class subdirs)")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--topN", type=int, default=1)
    p.add_argument("--imageSize", type=int, default=None,
                   help="input side for whole-model files (defaults per "
                        "--modelName otherwise)")
    common._add_platform_arg(p)
    return p


def _rebuild(args):
    """(model, input size) of ``--modelName``, as the JAX CLI builds it."""
    from bigdl_tpu_torch import models

    if args.modelName == "lenet":
        return models.lenet5(max(args.classNum, 10)), (28, 28)
    build = {"alexnet": models.alexnet,
             "inception_v1": models.inception_v1_no_aux,
             "resnet50": models.resnet50,
             "vgg16": models.vgg16}[args.modelName]
    return build(args.classNum), ((227, 227) if args.modelName == "alexnet"
                                  else (224, 224))


def _image_paths(folder: str) -> list:
    """A class-subdir tree's images, else a flat folder's."""
    from bigdl_tpu_torch.dataset.folder import list_image_folder

    try:
        paths, _, _ = list_image_folder(folder)
    except (FileNotFoundError, ValueError):
        paths = []
    if not paths:
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        paths = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
                 if f.lower().endswith(exts)]
    return paths


def main(argv=None):
    common.setup_logging()
    args = build_parser().parse_args(argv)
    common.apply_platform(args)

    import numpy as np

    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.dataset.folder import (IMAGENET_MEAN, IMAGENET_STD,
                                                _decode)
    from bigdl_tpu_torch.dataset.mnist import TRAIN_MEAN, TRAIN_STD
    from bigdl_tpu_torch.serving import InferenceEngine, power_of_two_buckets
    from bigdl_tpu_torch.utils.file import JaxModuleFileError, load_module

    device = resolve_device(args.platform)
    model = None
    if os.path.isfile(args.model):
        # a save_module file carries its own definition: no --modelName
        # rebuild (reference Module.load)
        try:
            model = load_module(args.model)
            side = args.imageSize or 224
            size = (side, side)
        except KeyError:
            # no definition: a weights-only file, rebuilt below
            model = None
        except JaxModuleFileError as e:
            logging.getLogger("bigdl_tpu_torch").warning(
                "%s; falling back to the --modelName %s rebuild", e,
                args.modelName)
            model = None
        except Exception as e:
            # a corrupt or incompatible whole-model file would otherwise
            # surface as a confusing mismatch far from here
            logging.getLogger("bigdl_tpu_torch").warning(
                "load_module(%s) failed (%s: %s); falling back to "
                "--modelName rebuild", args.model, type(e).__name__, e)
            model = None
    if model is None:
        model, size = _rebuild(args)
        if args.imageSize:
            size = (args.imageSize, args.imageSize)
        common.load_trained(model, args.model)
    engine = InferenceEngine(model, buckets=power_of_two_buckets(
        args.batchSize), device=device)

    paths = _image_paths(args.folder)
    if not paths:
        raise SystemExit(f"no images under {args.folder}")

    try:
        for i in range(0, len(paths), args.batchSize):
            chunk = paths[i:i + args.batchSize]
            imgs = np.stack([_decode(p_, size) for p_ in chunk])
            if args.modelName == "lenet":
                # cli/lenet.py's training normalisation
                if imgs.shape[-1] == 3:
                    imgs = imgs.mean(-1, keepdims=True)
                x = ((imgs.astype(np.float32) / 255.0) - TRAIN_MEAN) \
                    / TRAIN_STD
            else:
                # the folder statistics the ImageNet CLIs train with
                x = ((imgs.astype(np.float32)
                      - np.asarray(IMAGENET_MEAN, np.float32))
                     / np.asarray(IMAGENET_STD, np.float32))
            x = x.astype(np.float32)
            if i == 0 and engine.graphs.enabled:
                # every bucket's graph at the input shape, before any use
                engine.warmup(x.shape[1:], np.float32)
            scores = engine.predict_scores(x)
            top = np.argsort(-scores, axis=-1)[:, : args.topN]
            for path, classes in zip(chunk, top):
                print(f"{path}\t{' '.join(map(str, classes))}", flush=True)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
