"""AlexNet (counterpart of ``bigdl_tpu/models/alexnet.py``; reference
example/loadmodel/Model.scala builds it for Caffe import validation): the
single-tower Caffe variant over (B, 227, 227, 3) inputs, grouped
convolutions (``n_group=2``) at conv2, conv4 and conv5, cross-map LRN
after the first two. The weight layers carry the Caffe layer names
(``conv1`` ... ``fc8``), which ``interop.load_caffe`` matches; the rest of
the module and parameter names follow the JAX param tree. BASELINE config
4's Caffe-imported model beside Inception-v1."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["alexnet"]


def alexnet(class_num: int = 1000,
            generator: Optional[torch.Generator] = None) -> Sequential:
    g = generator
    m = Sequential(name="AlexNet")
    m.add(nn.SpatialConvolution(3, 96, 11, 11, 4, 4, generator=g,
                                name="conv1"))
    m.add(nn.ReLU())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2,
                                generator=g, name="conv2"))
    m.add(nn.ReLU())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1, generator=g,
                                name="conv3"))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, n_group=2,
                                generator=g, name="conv4"))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, n_group=2,
                                generator=g, name="conv5"))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.Reshape([256 * 6 * 6]))
    m.add(nn.Linear(256 * 6 * 6, 4096, generator=g, name="fc6"))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, generator=g, name="fc7"))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, generator=g, name="fc8"))
    m.add(nn.LogSoftMax())
    return m
