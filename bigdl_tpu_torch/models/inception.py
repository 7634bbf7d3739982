"""Inception / GoogLeNet (counterpart of ``bigdl_tpu/models/inception.py``;
reference models/inception/Model.scala: Inception_v1_NoAuxClassifier,
Inception_v1, Inception_v2). BASELINE config 4, Inception-v1 on ImageNet.

An inception module is a 4-branch ``Concat`` along the channels (the last
axis of (B, H, W, C)); every pooling is ceil-mode, every convolution
Xavier-initialised, as in the JAX builders. ``inception_v1`` returns the
table (main, aux1, aux2) of log-probabilities, trained with
``ParallelCriterion(repeat_target=True)`` weighted (1.0, 0.3, 0.3).
``inception_v2`` (BN-Inception) has 57 conv -> BN -> ReLU triples, no LRN
and no dropout: under ``--fusedBN apply`` every BN absorbs its ReLU, the
ones inside the Concat branches too, and the BN kernels meet 33 distinct
(rows, C) shapes a step, channel counts from 16 to 384. Module and
parameter names follow the JAX param tree (``load_jax``); weights come
from ``generator`` with the JAX package's distributions, not its
numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["inception_module", "inception_v1_no_aux", "inception_v1",
           "inception_v2"]


def inception_module(cin: int, config, with_bn: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    """config = [[c1x1], [c3x3_reduce, c3x3], [c5x5_reduce, c5x5],
    [pool_proj]] (reference Inception layer builder Model.scala)."""

    def conv(ci, co, k, pad=0):
        mods = [nn.SpatialConvolution(ci, co, k, k, 1, 1, pad, pad,
                                      init="xavier", with_bias=not with_bn,
                                      generator=generator)]
        if with_bn:
            mods.append(nn.SpatialBatchNormalization(co, eps=1e-3))
        mods.append(nn.ReLU())
        return mods

    b1 = Sequential(*conv(cin, config[0][0], 1))
    b2 = Sequential(*conv(cin, config[1][0], 1),
                    *conv(config[1][0], config[1][1], 3, 1))
    b3 = Sequential(*conv(cin, config[2][0], 1),
                    *conv(config[2][0], config[2][1], 5, 2))
    b4 = Sequential(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                    *conv(cin, config[3][0], 1))
    return Sequential(nn.Concat(b1, b2, b3, b4, axis=-1))


def _stem(generator: Optional[torch.Generator]) -> list:
    g = generator
    return [
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, init="xavier",
                              generator=g),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
        nn.SpatialConvolution(64, 64, 1, 1, init="xavier", generator=g),
        nn.ReLU(),
        nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, init="xavier",
                              generator=g),
        nn.ReLU(),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
    ]


# GoogLeNet table (Szegedy et al. 2014), as laid out in the reference's
# Inception_v1 builder: per-module [1x1, [3x3r, 3x3], [5x5r, 5x5], pool].
_V1_CFG = {
    "3a": (192, [[64], [96, 128], [16, 32], [32]]),
    "3b": (256, [[128], [128, 192], [32, 96], [64]]),
    "4a": (480, [[192], [96, 208], [16, 48], [64]]),
    "4b": (512, [[160], [112, 224], [24, 64], [64]]),
    "4c": (512, [[128], [128, 256], [24, 64], [64]]),
    "4d": (512, [[112], [144, 288], [32, 64], [64]]),
    "4e": (528, [[256], [160, 320], [32, 128], [128]]),
    "5a": (832, [[256], [160, 320], [32, 128], [128]]),
    "5b": (832, [[384], [192, 384], [48, 128], [128]]),
}


def inception_v1_no_aux(class_num: int = 1000,
                        generator: Optional[torch.Generator] = None
                        ) -> Sequential:
    """(reference Inception_v1_NoAuxClassifier) 224x224x3 -> classes."""
    g = generator
    m = Sequential(name="Inception_v1_NoAux")
    for mod in _stem(g):
        m.add(mod)
    for key in ("3a", "3b"):
        m.add(inception_module(*_V1_CFG[key], generator=g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("4a", "4b", "4c", "4d", "4e"):
        m.add(inception_module(*_V1_CFG[key], generator=g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("5a", "5b"):
        m.add(inception_module(*_V1_CFG[key], generator=g))
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.Dropout(0.4))
    m.add(nn.Reshape([1024]))
    m.add(nn.Linear(1024, class_num, init="xavier", generator=g))
    m.add(nn.LogSoftMax())
    return m


def _aux_head(cin: int, class_num: int,
              generator: Optional[torch.Generator]) -> Sequential:
    """(reference aux classifier: avgpool5/3 + conv1x1(128) + fc1024 +
    dropout 0.7 + fc classes)"""
    g = generator
    return Sequential(
        nn.SpatialAveragePooling(5, 5, 3, 3),
        nn.SpatialConvolution(cin, 128, 1, 1, init="xavier", generator=g),
        nn.ReLU(),
        nn.Reshape([128 * 4 * 4]),
        nn.Linear(128 * 4 * 4, 1024, generator=g),
        nn.ReLU(),
        nn.Dropout(0.7),
        nn.Linear(1024, class_num, generator=g),
        nn.LogSoftMax(),
    )


def _reorder(t):
    """FlattenTable's (main, aux2, aux1) as (main, aux1, aux2)."""
    return (t[0], t[2], t[1])


def inception_v1(class_num: int = 1000,
                 generator: Optional[torch.Generator] = None) -> Sequential:
    """Full GoogLeNet with two aux classifiers (reference Inception_v1).
    Output = (main, aux1, aux2) log-prob table; train with
    ParallelCriterion(repeat_target=True) weighted (1.0, 0.3, 0.3)."""
    g = generator
    trunk1 = Sequential(name="trunk1")  # up to 4a output
    for mod in _stem(g):
        trunk1.add(mod)
    for key in ("3a", "3b"):
        trunk1.add(inception_module(*_V1_CFG[key], generator=g))
    trunk1.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    trunk1.add(inception_module(*_V1_CFG["4a"], generator=g))

    trunk2 = Sequential(name="trunk2")  # 4b..4d
    for key in ("4b", "4c", "4d"):
        trunk2.add(inception_module(*_V1_CFG[key], generator=g))

    trunk3 = Sequential(name="trunk3")  # 4e..5b + head
    trunk3.add(inception_module(*_V1_CFG["4e"], generator=g))
    trunk3.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("5a", "5b"):
        trunk3.add(inception_module(*_V1_CFG[key], generator=g))
    trunk3.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    trunk3.add(nn.Dropout(0.4))
    trunk3.add(nn.Reshape([1024]))
    trunk3.add(nn.Linear(1024, class_num, init="xavier", generator=g))
    trunk3.add(nn.LogSoftMax())

    # (main, aux1, aux2): trunk1 -> split(aux1 | trunk2 -> split(aux2 | trunk3))
    inner = Sequential(
        nn.ConcatTable(
            Sequential(trunk2,
                       nn.ConcatTable(trunk3, _aux_head(528, class_num, g))),
            _aux_head(512, class_num, g),
        ),
        nn.FlattenTable(),
    )
    return Sequential(trunk1, inner, nn.Lambda(_reorder, name="reorder"),
                      name="Inception_v1")


def inception_v2(class_num: int = 1000,
                 generator: Optional[torch.Generator] = None) -> Sequential:
    """BN-Inception (reference Inception_v2): v1 topology with
    batch-normalized inception modules and no LRN. Single output."""
    g = generator
    m = Sequential(name="Inception_v2")
    m.add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                                init="xavier", generator=g))
    m.add(nn.SpatialBatchNormalization(64, eps=1e-3))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(nn.SpatialConvolution(64, 64, 1, 1, with_bias=False, init="xavier",
                                generator=g))
    m.add(nn.SpatialBatchNormalization(64, eps=1e-3))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, with_bias=False,
                                init="xavier", generator=g))
    m.add(nn.SpatialBatchNormalization(192, eps=1e-3))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("3a", "3b"):
        m.add(inception_module(*_V1_CFG[key], with_bn=True, generator=g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("4a", "4b", "4c", "4d", "4e"):
        m.add(inception_module(*_V1_CFG[key], with_bn=True, generator=g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("5a", "5b"):
        m.add(inception_module(*_V1_CFG[key], with_bn=True, generator=g))
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.Reshape([1024]))
    m.add(nn.Linear(1024, class_num, init="xavier", generator=g))
    m.add(nn.LogSoftMax())
    return m
