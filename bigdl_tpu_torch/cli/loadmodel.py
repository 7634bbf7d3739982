"""Imported-model validation (counterpart of ``bigdl_tpu/cli/loadmodel.py``;
reference example/loadmodel/ModelValidator.scala): a Caffe
(.prototxt/.caffemodel), Torch (.t7) or native checkpoint loaded into the
matching model and evaluated with Top-1 and Top-5 on an ImageNet-style
val folder::

    python -m bigdl_tpu_torch.cli.loadmodel --modelType caffe \\
        --model deploy.prototxt --weights bvlc.caffemodel \\
        --modelName alexnet -f /data/imagenet/val [--platform cpu]
    python -m bigdl_tpu_torch.cli.loadmodel --modelType torch \\
        --model model.t7 -f DIR
    python -m bigdl_tpu_torch.cli.loadmodel --modelType bigdl \\
        --modelName inception_v1 --model CKPT -f DIR

``caffe`` matches the caffemodel's layers to the model's modules by name
(``interop.load_caffe``); ``torch`` builds the whole graph from the
``.t7`` file and ignores ``--modelName``; ``bigdl`` loads a checkpoint,
the port's or the JAX package's. The val crop is 227 for alexnet and 224
for the rest, unless ``--imageSize`` says otherwise.
"""

from __future__ import annotations

import argparse

from bigdl_tpu_torch.cli import common

__all__ = ["main", "load_into"]

_BUILDERS = {
    "alexnet": lambda n, g: _models().alexnet(n, generator=g),
    "inception_v1": lambda n, g: _models().inception_v1_no_aux(n,
                                                               generator=g),
    "resnet50": lambda n, g: _models().resnet50(n, generator=g),
    "vgg16": lambda n, g: _models().vgg16(n, generator=g),
}


def _models():
    from bigdl_tpu_torch import models
    return models


def load_into(model, model_type: str, model_path: str, weights):
    """Copy imported weights into ``model`` in place (reference
    Module.load/loadCaffe, nn/Module.scala:28-41). Returns the model."""
    if model_type == "caffe":
        from bigdl_tpu_torch.interop import load_caffe
        return load_caffe(model, weights, prototxt_path=model_path)
    if model_type == "torch":
        # whole-model import: the .t7 carries the graph; the module built
        # from --modelName is ignored (reference Module.loadTorch flow)
        raise RuntimeError("torch models are whole-model files; handled "
                           "in main() before builder construction")
    if model_type == "bigdl":
        return common.load_trained(model, model_path)
    raise SystemExit(f"unknown modelType {model_type}")


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.loadmodel")
    common._add_platform_arg(p)
    p.add_argument("--modelType", required=True,
                   choices=["caffe", "torch", "bigdl"])
    p.add_argument("--modelName", default=None, choices=sorted(_BUILDERS),
                   help="model builder (required for caffe/bigdl; torch "
                        ".t7 files carry the whole graph and ignore it)")
    p.add_argument("--model", required=True,
                   help="prototxt (caffe) / .t7 (torch) / checkpoint (bigdl)")
    p.add_argument("--weights", default=None, help=".caffemodel (caffe)")
    p.add_argument("-f", "--folder", required=True,
                   help="val folder: <class>/<imgs>")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--imageSize", type=int, default=None,
                   help="val crop size (default: 227 for alexnet, else "
                        "224 — whole-model .t7 files need this when the "
                        "graph was built for another size)")
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                         ImageFolderDataSet)
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy

    resolve_device(args.platform)  # refuse before reading the files
    if args.modelType == "torch":
        # whole-model .t7: the graph and weights from the file
        # (reference Module.loadTorch, nn/Module.scala:32)
        from bigdl_tpu_torch.interop import load_torch_module
        model = load_torch_module(args.model, device="cpu")
    else:
        if args.modelName is None:
            raise SystemExit("--modelName is required for "
                             f"modelType={args.modelType}")
        model = _BUILDERS[args.modelName](args.classNum,
                                          torch.Generator().manual_seed(0))
        load_into(model, args.modelType, args.model, args.weights)
    # Caffe AlexNet crops to 227; the rest take 224
    if args.imageSize is not None:
        size = (args.imageSize, args.imageSize)
    else:
        size = (227, 227) if args.modelName == "alexnet" else (224, 224)
    val = ImageFolderDataSet(args.folder, args.batchSize, size=size,
                             mean=IMAGENET_MEAN, std=IMAGENET_STD)
    return common.evaluate(model, val, [Top1Accuracy(), Top5Accuracy()],
                           device=args.platform)


if __name__ == "__main__":
    main()
