"""VGG (counterpart of ``bigdl_tpu/models/vgg.py``; reference
models/vgg/Model.scala): ``vgg_for_cifar10``, thirteen conv-BN-ReLU
blocks (the convolutions bias-free, BN eps 1e-3) in five 2x2-pooled
stages, then Linear(512, 512), a 1-D BN, ReLU, Dropout(0.5) and the
classifier; ``vgg16`` and ``vgg19`` for ImageNet (224 x 224, conv+ReLU,
no BN, a 4096-4096 classifier with dropout). (B, H, W, C) inputs; module
names follow the JAX param tree. BASELINE config 2, VGG on CIFAR-10.

With ``--fusedBN apply`` all 14 BNs of ``vgg_for_cifar10`` absorb the
ReLU after them (``absorb_bn_relu``), the 1-D BN after the Linear
included: each BN runs one ``bn_fwd_apply`` and one ``bn_bwd_fused`` a
step, at (rows, C) from 131072 x 64 down to 128 x 512 at batch 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["vgg_for_cifar10", "vgg16", "vgg19"]

_CIFAR_CFG = ([64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
              [512, 512, 512])


def vgg_for_cifar10(class_num: int = 10, dropout: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> Sequential:
    m = Sequential(name="VggForCifar10")
    c = 3
    for block in _CIFAR_CFG:
        for cout in block:
            m.add(nn.SpatialConvolution(c, cout, 3, 3, 1, 1, 1, 1,
                                        with_bias=False, generator=generator))
            m.add(nn.SpatialBatchNormalization(cout, eps=1e-3))
            m.add(nn.ReLU())
            c = cout
        m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(nn.Reshape([512]))
    m.add(nn.Linear(512, 512, generator=generator))
    m.add(nn.BatchNormalization(512))
    m.add(nn.ReLU())
    if dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, class_num, generator=generator))
    m.add(nn.LogSoftMax())
    return m


def _vgg_imagenet(cfg, class_num: int, name: str,
                  generator: Optional[torch.Generator]) -> Sequential:
    m = Sequential(name=name)
    c = 3
    for block in cfg:
        for cout in block:
            m.add(nn.SpatialConvolution(c, cout, 3, 3, 1, 1, 1, 1,
                                        generator=generator))
            m.add(nn.ReLU())
            c = cout
        m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    m.add(nn.Reshape([512 * 7 * 7]))
    m.add(nn.Linear(512 * 7 * 7, 4096, generator=generator))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, generator=generator))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, generator=generator))
    m.add(nn.LogSoftMax())
    return m


def vgg16(class_num: int = 1000,
          generator: Optional[torch.Generator] = None) -> Sequential:
    return _vgg_imagenet([[64, 64], [128, 128], [256, 256, 256],
                          [512, 512, 512], [512, 512, 512]],
                         class_num, "Vgg_16", generator)


def vgg19(class_num: int = 1000,
          generator: Optional[torch.Generator] = None) -> Sequential:
    return _vgg_imagenet([[64, 64], [128, 128], [256, 256, 256, 256],
                          [512, 512, 512, 512], [512, 512, 512, 512]],
                         class_num, "Vgg_19", generator)
