"""Convolutions (counterpart of ``bigdl_tpu/nn/conv.py``; reference
nn/Spatial*Convolution*.scala, nn/TemporalConvolution.scala).

Activations keep the JAX package's (B, H, W, C) layout. The weight is
torch's (out, in / groups, kh, kw), stored channels_last: the JAX kernel
is HWIO, and :meth:`SpatialConvolution.from_jax_leaf` converts it
(:meth:`SpatialConvolution.to_jax_leaf` converts it back). The
forward sees x as an NCHW-shaped view with channels_last strides
(``permute(0, 3, 1, 2)``, no copy), runs one ``F.conv2d`` (cuDNN on the
card), and permutes the channels_last result back to (B, H, W, C), again
without a copy; while a conv layout policy is installed, the spatial
convolutions go through ``ops.conv2d.conv2d`` instead, as in the JAX
package. The transposed, dilated and connection-table
convolutions keep that layout; ``TemporalConvolution`` runs one
``F.conv1d`` over (B, T, C) seen as (B, C, T). Each converts its JAX
kernel in ``from_jax_leaf`` and back in ``to_jax_leaf``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import (SimpleModule, uniform_fan_in,
                                         xavier_uniform)

__all__ = ["SpatialConvolution", "SpatialShareConvolution",
           "SpatialFullConvolution", "SpatialDilatedConvolution",
           "SpatialConvolutionMap", "TemporalConvolution"]


def _conv(x, w, stride, pad, dilation=(1, 1), groups: int = 1):
    """NHWC ``x`` convolved with the (out, in/groups, kh, kw) ``w``: one
    ``F.conv2d`` on the channels_last view, or, while a conv layout policy
    is installed (``--convLayout``/``--convGeom``), the per-pass layouts of
    :func:`bigdl_tpu_torch.ops.conv2d.conv2d`."""
    from bigdl_tpu_torch.ops import conv2d as c2d

    if c2d.policy_active():
        return c2d.conv2d(x, w, stride, ((pad[0], pad[0]), (pad[1], pad[1])),
                          dilation, groups)
    return F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, pad, dilation,
                    groups).permute(0, 2, 3, 1)


def _hwio_to_oihw(key: str, value: torch.Tensor) -> torch.Tensor:
    return value.permute(3, 2, 0, 1) if key == "weight" else value


def _oihw_to_hwio(key: str, value: torch.Tensor) -> torch.Tensor:
    return value.permute(2, 3, 1, 0) if key == "weight" else value


class SpatialConvolution(SimpleModule):
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
        super().__init__(name)
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by n_group {n_group}")
        if init not in ("default", "xavier"):
            raise ValueError(f"init {init!r} not in ('default', 'xavier')")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w = self.dilation_h = 1
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
        return _hwio_to_oihw(key, value)

    @staticmethod
    def to_jax_leaf(key: str, value: torch.Tensor) -> torch.Tensor:
        """This module's leaf in the JAX layout: the kernel back to HWIO."""
        return _oihw_to_hwio(key, value)

    # under tensor parallelism (``parallel.TensorParallel``): the output
    # channels split, the input copied to the model axis and the output
    # gathered whole
    _tp = None

    def forward(self, x):
        tp = self._tp
        if tp is not None:
            x = tp.copy(x)
        w = self.weight.to(x.dtype)
        y = _conv(x, w, (self.stride_h, self.stride_w),
                  (self.pad_h, self.pad_w),
                  (self.dilation_h, self.dilation_w), self.n_group)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        if tp is not None:
            y = tp.gather(y, -1)
        return y

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_h}x{self.kernel_w}, stride "
                f"({self.stride_h}, {self.stride_w}), pad ({self.pad_h}, "
                f"{self.pad_w}), groups {self.n_group}")


class SpatialShareConvolution(SpatialConvolution):
    """SpatialConvolution under the reference's name
    (nn/SpatialShareConvolution.scala shares im2col buffers, which cuDNN
    has no need of)."""


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (reference nn/SpatialDilatedConvolution.scala):
    SpatialConvolution's kernel read with ``dilation`` gaps, one group,
    the default init."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 with_bias: bool = True, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h, 1, with_bias,
                         "default", generator, name)
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.to(dtype=param_dtype)


def _triangle(k: int) -> np.ndarray:
    """The bilinear filler's 1-D triangle of a k-tap kernel, in f32."""
    f = (k + 1) // 2
    c = np.float32((2 * f - 1 - f % 2) / (2.0 * f))
    return 1 - np.abs(np.arange(k, dtype=np.float32) / f - c)


class SpatialFullConvolution(SimpleModule):
    """Transposed convolution (reference nn/SpatialFullConvolution.scala):
    the transpose of SpatialConvolution's forward, with ``adj`` extra
    output rows and columns (``output_padding``) and ``n_group`` groups,
    one ``F.conv_transpose2d``. The JAX kernel (kh, kw, in/groups, out)
    is torch's (in, out/groups, kh, kw) here (``from_jax_leaf``). Init
    "default" is U(+-1/sqrt(kw*kh*out/groups)); "bilinear" fills every
    (in, out) pair with the separable triangle, "bilinear_upsample" only
    the matching pairs, both with a zero bias. ``adj`` must be below the
    stride (the reference's rule; ``conv_transpose2d`` has it too)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0, n_group: int = 1,
                 with_bias: bool = True, param_dtype=torch.float32,
                 init: str = "default",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if init not in ("default", "bilinear", "bilinear_upsample"):
            raise ValueError(f"init {init!r} not in "
                             "('default','bilinear','bilinear_upsample')")
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by n_group {n_group}")
        if adj_w >= stride_w or adj_h >= stride_h:
            raise ValueError(f"adj ({adj_h}, {adj_w}) must be below the "
                             f"stride ({stride_h}, {stride_w})")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = with_bias
        self.init_method = init
        cin = n_input_plane // n_group
        fan_in = kernel_w * kernel_h * (n_output_plane // n_group)
        hwio = (kernel_h, kernel_w, cin, n_output_plane)
        if init.startswith("bilinear"):
            tri = _triangle(kernel_h)[:, None] * _triangle(kernel_w)[None, :]
            if init == "bilinear":
                w = np.broadcast_to(tri[:, :, None, None], hwio).copy()
            else:
                w = np.zeros(hwio, np.float32)
                for i in range(min(cin, n_output_plane)):
                    w[:, :, i, i] = tri
            w = torch.from_numpy(w)
        else:
            w = uniform_fan_in(hwio, fan_in, generator)
        self.weight = nn.Parameter(self.from_jax_leaf("weight", w).to(
            param_dtype).contiguous())
        if with_bias:
            self.bias = nn.Parameter(
                torch.zeros(n_output_plane, dtype=param_dtype)
                if init.startswith("bilinear") else
                uniform_fan_in((n_output_plane,), fan_in, generator).to(
                    param_dtype))

    def from_jax_leaf(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """The JAX (kh, kw, in/g, out) kernel as (in, out/g, kh, kw)."""
        if key != "weight":
            return value
        kh, kw, cin, cout = value.shape
        g = self.n_group
        return (value.reshape(kh, kw, cin, g, cout // g)
                .permute(3, 2, 4, 0, 1).reshape(g * cin, cout // g, kh, kw))

    def to_jax_leaf(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """The kernel back to the JAX (kh, kw, in/g, out)."""
        if key != "weight":
            return value
        cin_all, cout_g, kh, kw = value.shape
        g = self.n_group
        return (value.reshape(g, cin_all // g, cout_g, kh, kw)
                .permute(3, 4, 1, 0, 2).reshape(kh, kw, cin_all // g,
                                                g * cout_g))

    def forward(self, x):
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
            (self.stride_h, self.stride_w), (self.pad_h, self.pad_w),
            (self.adj_h, self.adj_w), self.n_group).permute(0, 2, 3, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y


class SpatialConvolutionMap(SimpleModule):
    """Convolution over a connection table (reference
    nn/SpatialConvolutionMap.scala): ``conn_table`` lists 0-based
    (in_plane, out_plane) pairs. A dense (out, in, kh, kw) kernel under a
    fixed 0/1 mask (a buffer, not in the state dict, as it is not in the
    JAX trees), so an unconnected entry's gradient is 0. Init
    U(+-1/sqrt(kw*kh*pairs/out)) for weight and bias."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1, pad_w: int = 0,
                 pad_h: int = 0, n_input_plane: Optional[int] = None,
                 n_output_plane: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        ct = np.asarray(conn_table, np.int64)
        if ct.ndim != 2 or ct.shape[1] != 2:
            raise ValueError(f"conn_table must be (pairs, 2), got "
                             f"{ct.shape}")
        self.conn_table = ct
        self.n_input_plane = (int(ct[:, 0].max()) + 1
                              if n_input_plane is None else n_input_plane)
        self.n_output_plane = (int(ct[:, 1].max()) + 1
                               if n_output_plane is None else n_output_plane)
        if (ct[:, 0].max() >= self.n_input_plane
                or ct[:, 1].max() >= self.n_output_plane):
            raise ValueError("conn_table names a plane past the counts")
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = torch.zeros(self.n_output_plane, self.n_input_plane, 1, 1)
        mask[torch.from_numpy(ct[:, 1]), torch.from_numpy(ct[:, 0])] = 1.0
        self.register_buffer("mask", mask, persistent=False)
        fan_in = kernel_w * kernel_h * max(1, len(ct) // self.n_output_plane)
        self.weight = nn.Parameter(uniform_fan_in(
            (self.n_output_plane, self.n_input_plane, kernel_h, kernel_w),
            fan_in, generator))
        self.bias = nn.Parameter(uniform_fan_in((self.n_output_plane,),
                                                fan_in, generator))

    @staticmethod
    def full(n_in: int, n_out: int):
        """Full connection table (SpatialConvolutionMap.full)."""
        return np.stack(np.meshgrid(np.arange(n_in), np.arange(n_out),
                                    indexing="ij"), -1).reshape(-1, 2)

    @staticmethod
    def one_to_one(n: int):
        """Depthwise table (SpatialConvolutionMap.oneToOne)."""
        i = np.arange(n)
        return np.stack([i, i], -1)

    from_jax_leaf = staticmethod(_hwio_to_oihw)
    to_jax_leaf = staticmethod(_oihw_to_hwio)

    def forward(self, x):
        w = (self.weight * self.mask).to(x.dtype)
        y = _conv(x, w, (self.stride_h, self.stride_w),
                  (self.pad_h, self.pad_w))
        return y + self.bias.to(x.dtype)


class TemporalConvolution(SimpleModule):
    """1-D convolution over (B, T, C) sequences (Torch
    TemporalConvolution): the JAX (kw, in, out) kernel is torch's (out,
    in, kw) here; init U(+-1/sqrt(kw*in))."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1, pad_w: int = 0,
                 with_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w, self.pad_w = kernel_w, stride_w, pad_w
        self.with_bias = with_bias
        fan_in = kernel_w * input_frame_size
        self.weight = nn.Parameter(self.from_jax_leaf("weight", uniform_fan_in(
            (kernel_w, input_frame_size, output_frame_size), fan_in,
            generator)).contiguous())
        if with_bias:
            self.bias = nn.Parameter(uniform_fan_in((output_frame_size,),
                                                    fan_in, generator))

    @staticmethod
    def from_jax_leaf(key: str, value: torch.Tensor) -> torch.Tensor:
        """The JAX (kw, in, out) kernel as (out, in, kw)."""
        return value.permute(2, 1, 0) if key == "weight" else value

    @staticmethod
    def to_jax_leaf(key: str, value: torch.Tensor) -> torch.Tensor:
        """The kernel back to the JAX (kw, in, out)."""
        return value.permute(2, 1, 0) if key == "weight" else value

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), None,
                     self.stride_w, self.pad_w).transpose(1, 2)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y
