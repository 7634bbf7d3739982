"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``; reference
models/resnet/ResNet.scala): the CIFAR-10 family (depth 6n+2, basic
blocks, shortcut A) and the ImageNet bottleneck family (ResNet-50 the
main path's model). (B, H, W, C) input; module and parameter names
follow the JAX param tree, so a converted tree loads by name
(:func:`bigdl_tpu_torch.interop.load_jax`).

Weights come from ``generator`` (None: torch's default generator) with
the JAX package's distributions, not its numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Identity, Sequential

__all__ = ["resnet", "resnet_cifar", "resnet50", "basic_block",
           "bottleneck_block", "SpaceToDepthStem"]

_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


class SpaceToDepthStem:
    """The JAX package's space-to-depth ImageNet stem is not in the port
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SpaceToDepthStem (s2d_stem) is not in the PyTorch port yet: it "
            "comes with the rest of the ResNet slice (ROADMAP.md queue 1 "
            "item 7)")


def _conv_bn(cin, cout, k, stride=1, pad=0, relu=True, gamma_init=1.0,
             generator=None):
    m = [nn.SpatialConvolution(cin, cout, k, k, stride, stride, pad, pad,
                               with_bias=False, init="xavier",
                               generator=generator),
         nn.SpatialBatchNormalization(cout, gamma_init=gamma_init)]
    if relu:
        m.append(nn.ReLU())
    return m


def _shortcut(cin, cout, stride, shortcut_type: str, generator=None):
    """A = zero-padded identity (parameter-free), B = 1x1 conv + BN when
    the shape changes else identity, C = 1x1 conv + BN always."""
    changed = cin != cout or stride != 1
    if shortcut_type == "C" or (shortcut_type == "B" and changed):
        return Sequential(*_conv_bn(cin, cout, 1, stride, 0, relu=False,
                                    generator=generator))
    if changed:  # type A
        pool = []
        if stride != 1:
            pool.append(nn.SpatialAveragePooling(1, 1, stride, stride))
        pool.append(nn.Padding(-1, cout - cin, value=0.0))
        return Sequential(*pool)
    return Identity()


def basic_block(cin, cout, stride=1, shortcut_type="B", zero_init=False,
                generator: Optional[torch.Generator] = None):
    """3x3 + 3x3 (reference basicBlock); ``zero_init`` starts the last BN's
    gamma at 0 (zero-init residual)."""
    main = Sequential(
        *_conv_bn(cin, cout, 3, stride, 1, generator=generator),
        *_conv_bn(cout, cout, 3, 1, 1, relu=False,
                  gamma_init=0.0 if zero_init else 1.0, generator=generator))
    return Sequential(
        nn.ConcatTable(main, _shortcut(cin, cout, stride, shortcut_type,
                                       generator)),
        nn.CAddTable(), nn.ReLU())


def bottleneck_block(cin, planes, stride=1, shortcut_type="B", expansion=4,
                     zero_init=False,
                     generator: Optional[torch.Generator] = None):
    """1x1 reduce, 3x3 (stride here), 1x1 expand (reference bottleneck)."""
    cout = planes * expansion
    main = Sequential(
        *_conv_bn(cin, planes, 1, generator=generator),
        *_conv_bn(planes, planes, 3, stride, 1, generator=generator),
        *_conv_bn(planes, cout, 1, relu=False,
                  gamma_init=0.0 if zero_init else 1.0, generator=generator))
    return Sequential(
        nn.ConcatTable(main, _shortcut(cin, cout, stride, shortcut_type,
                                       generator)),
        nn.CAddTable(), nn.ReLU())


def resnet(depth: int = 50, class_num: int = 1000, shortcut_type: str = "B",
           zero_init_residual: bool = False, s2d_stem: bool = False,
           fused_bn=False,
           generator: Optional[torch.Generator] = None) -> Sequential:
    """ImageNet ResNet, input (B, 224, 224, 3). ``fused_bn``: "stats" or
    "apply" routes every BN through the BN kernels
    (:func:`~bigdl_tpu_torch.nn.set_bn_fused`)."""
    if s2d_stem:
        SpaceToDepthStem()
    kind, layers = _IMAGENET_CFG[depth]
    m = Sequential(name=f"ResNet{depth}")
    m.add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                                init="xavier", generator=generator))
    m.add(nn.SpatialBatchNormalization(64))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    cin = 64
    for stage, n_blocks in enumerate(layers):
        planes = 64 * (2 ** stage)
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            if kind == "basic":
                m.add(basic_block(cin, planes, stride, shortcut_type,
                                  zero_init=zero_init_residual,
                                  generator=generator))
                cin = planes
            else:
                m.add(bottleneck_block(cin, planes, stride, shortcut_type,
                                       zero_init=zero_init_residual,
                                       generator=generator))
                cin = planes * 4
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.Reshape([cin]))
    m.add(nn.Linear(cin, class_num, init="xavier", generator=generator))
    m.add(nn.LogSoftMax())
    if fused_bn:
        nn.set_bn_fused(m, fused_bn)
    return m


def resnet_cifar(depth: int = 20, class_num: int = 10,
                 shortcut_type: str = "A", fused_bn=False,
                 generator: Optional[torch.Generator] = None) -> Sequential:
    """CIFAR-10 ResNet, depth = 6n+2, input (B, 32, 32, 3)."""
    if (depth - 2) % 6:
        raise ValueError(f"CIFAR depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    m = Sequential(name=f"ResNet{depth}-cifar")
    m.add(nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1, with_bias=False,
                                init="xavier", generator=generator))
    m.add(nn.SpatialBatchNormalization(16))
    m.add(nn.ReLU())
    cin = 16
    for stage, planes in enumerate([16, 32, 64]):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            m.add(basic_block(cin, planes, stride, shortcut_type,
                              generator=generator))
            cin = planes
    m.add(nn.SpatialAveragePooling(8, 8, 1, 1))
    m.add(nn.Reshape([64]))
    m.add(nn.Linear(64, class_num, init="xavier", generator=generator))
    m.add(nn.LogSoftMax())
    if fused_bn:
        nn.set_bn_fused(m, fused_bn)
    return m


def resnet50(class_num: int = 1000, s2d_stem: bool = False, fused_bn=False,
             generator: Optional[torch.Generator] = None) -> Sequential:
    return resnet(50, class_num, s2d_stem=s2d_stem, fused_bn=fused_bn,
                  generator=generator)
