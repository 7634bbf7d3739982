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
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import (Identity, Sequential, SimpleModule,
                                         xavier_uniform)
from bigdl_tpu_torch.nn.conv import _conv, _hwio_to_oihw, _oihw_to_hwio

__all__ = ["resnet", "resnet_cifar", "resnet50", "basic_block",
           "bottleneck_block", "SpaceToDepthStem"]

_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


class SpaceToDepthStem(SimpleModule):
    """The space-to-depth ImageNet stem: a 2x2 space-to-depth, then a
    4x4/stride-1 convolution of 12 input channels padded ((2, 1), (2, 1)),
    which computes what the classic 7x7/stride-2 convolution of 3 channels
    padded 3 does (the MLPerf ResNet stem) over a 192-deep contraction at
    a quarter of the positions. The weight is (out, 12, 4, 4), channels_last
    (the JAX package's (4, 4, 12, out) HWIO kernel converts in
    :meth:`from_jax_leaf`); init Xavier uniform with the classic stem's
    fan-in 7*7*3. The convolution goes through the conv layout policy like
    any other (``nn.conv``)."""

    def __init__(self, out_planes: int = 64,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.out_planes = out_planes
        w = xavier_uniform((out_planes, 12, 4, 4), 7 * 7 * 3,
                           7 * 7 * out_planes, generator)
        self.weight = torch.nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))

    from_jax_leaf = staticmethod(_hwio_to_oihw)
    to_jax_leaf = staticmethod(_oihw_to_hwio)

    @staticmethod
    def weight_from_conv7(w7) -> torch.Tensor:
        """Embed a 7x7 stem kernel (out, 3, 7, 7) into the (out, 12, 4, 4)
        layout, exactly as the JAX package does in its HWIO layout: output
        row i covers pixel rows 2i-3..2i+3, so tap t maps to (block a,
        parity dy) with t = 2a+dy-1, and the slots outside the window
        are 0."""
        w7 = torch.as_tensor(w7)
        out = w7.new_zeros((w7.shape[0], 12, 4, 4))
        for a in range(4):
            for dy in range(2):
                t = 2 * a + dy - 1
                if not 0 <= t < 7:
                    continue
                for b in range(4):
                    for dx in range(2):
                        u = 2 * b + dx - 1
                        if not 0 <= u < 7:
                            continue
                        ch = dy * 6 + dx * 3
                        out[:, ch:ch + 3, a, b] = w7[:, :, t, u]
        return out

    def forward(self, x):
        b, h, w, c = x.shape
        xb = (x.reshape(b, h // 2, 2, w // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5)
              .reshape(b, h // 2, w // 2, 4 * c))
        # the uneven padding as a copy of the 12-channel input (a quarter
        # of the bytes of cropping the output of a symmetric one)
        xb = F.pad(xb, (0, 0, 2, 1, 2, 1))
        return _conv(xb, self.weight.to(x.dtype), (1, 1), (0, 0))


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
    """ImageNet ResNet, input (B, 224, 224, 3). ``s2d_stem`` swaps the
    7x7/2 stem for :class:`SpaceToDepthStem`. ``fused_bn``: "stats" or
    "apply" routes every BN through the BN kernels
    (:func:`~bigdl_tpu_torch.nn.set_bn_fused`)."""
    kind, layers = _IMAGENET_CFG[depth]
    m = Sequential(name=f"ResNet{depth}")
    if s2d_stem:
        m.add(SpaceToDepthStem(64, generator=generator))
    else:
        m.add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                                    with_bias=False, init="xavier",
                                    generator=generator))
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
