"""2-D convolution (counterpart of ``SpatialConvolution`` in
``bigdl_tpu/nn/conv.py``; reference nn/SpatialConvolution.scala).

Activations keep the JAX package's (B, H, W, C) layout. The weight is
torch's (out, in / groups, kh, kw), stored channels_last: the JAX kernel
is HWIO, and :meth:`SpatialConvolution.from_jax_leaf` converts it
(:meth:`SpatialConvolution.to_jax_leaf` converts it back). The
forward sees x as an NCHW-shaped view with channels_last strides
(``permute(0, 3, 1, 2)``, no copy), runs one ``F.conv2d`` (cuDNN on the
card), and permutes the channels_last result back to (B, H, W, C), again
without a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import uniform_fan_in, xavier_uniform

__all__ = ["SpatialConvolution"]


class SpatialConvolution(nn.Module):
    """Arguments in the reference's order: (n_input_plane,
    n_output_plane, kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h,
    n_group). Init "default" is U(+-1/sqrt(kw*kh*nin/groups)) for weight
    and bias, "xavier" Xavier uniform over fan_in/fan_out of the weight
    (the bias keeps the default). The weight is cast to the activation's
    dtype at each call, as in the JAX package; the bias is added after the
    convolution."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 init: str = "default",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by n_group {n_group}")
        if init not in ("default", "xavier"):
            raise ValueError(f"init {init!r} not in ('default', 'xavier')")
        self.name = name if name is not None else type(self).__name__
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        cin = n_input_plane // n_group
        fan_in = kernel_w * kernel_h * cin
        fan_out = kernel_w * kernel_h * (n_output_plane // n_group)
        shape = (n_output_plane, cin, kernel_h, kernel_w)
        w = (xavier_uniform(shape, fan_in, fan_out, generator)
             if init == "xavier" else uniform_fan_in(shape, fan_in,
                                                     generator))
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))
        if with_bias:
            self.bias = nn.Parameter(uniform_fan_in((n_output_plane,),
                                                    fan_in, generator))

    @staticmethod
    def from_jax_leaf(key: str, value: torch.Tensor) -> torch.Tensor:
        """A JAX leaf in this module's layout: the HWIO kernel becomes
        (out, in, kh, kw); the bias is unchanged."""
        return value.permute(3, 2, 0, 1) if key == "weight" else value

    @staticmethod
    def to_jax_leaf(key: str, value: torch.Tensor) -> torch.Tensor:
        """This module's leaf in the JAX layout: the kernel back to HWIO."""
        return value.permute(2, 3, 1, 0) if key == "weight" else value

    def forward(self, x):
        w = self.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None,
                     (self.stride_h, self.stride_w),
                     (self.pad_h, self.pad_w), 1, self.n_group)
        y = y.permute(0, 2, 3, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_h}x{self.kernel_w}, stride "
                f"({self.stride_h}, {self.stride_w}), pad ({self.pad_h}, "
                f"{self.pad_w}), groups {self.n_group}")
