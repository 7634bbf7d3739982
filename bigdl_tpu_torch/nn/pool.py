"""Pooling (counterpart of ``bigdl_tpu/nn/pool.py``).

(B, H, W, C) in and out, through an NCHW-shaped channels_last view as in
:mod:`~bigdl_tpu_torch.nn.conv`. ``ceil_mode`` keeps Torch's output-size
convention, the one the JAX package's ``_pool_pads`` reproduces; the
padding past the input counts as -inf for the max and 0 for the sum. With
``count_include_pad`` every average divides by kh*kw, windows that
overhang the padded input included, as the JAX package's does.
``TemporalMaxPooling`` pools the time axis of (B, T, C) sequences,
without padding, windows that overhang the end dropped.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from bigdl_tpu_torch.core.module import SimpleModule

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling",
           "TemporalMaxPooling"]


class _SpatialPool(SimpleModule):
    def __init__(self, kernel_w: int, kernel_h: int,
                 stride_w: Optional[int] = None,
                 stride_h: Optional[int] = None, pad_w: int = 0,
                 pad_h: int = 0, ceil_mode: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w = stride_w if stride_w is not None else kernel_w
        self.stride_h = stride_h if stride_h is not None else kernel_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode
        if pad_w > kernel_w // 2 or pad_h > kernel_h // 2:
            raise ValueError(f"padding ({pad_h}, {pad_w}) exceeds half the "
                             f"window ({kernel_h}, {kernel_w})")

    def ceil(self):
        """Builder-style toggle (the reference's .ceil())."""
        self.ceil_mode = True
        return self

    def _args(self) -> dict:
        return dict(kernel_size=(self.kernel_h, self.kernel_w),
                    stride=(self.stride_h, self.stride_w),
                    padding=(self.pad_h, self.pad_w), ceil_mode=self.ceil_mode)


class SpatialMaxPooling(_SpatialPool):
    """(reference nn/SpatialMaxPooling.scala)"""

    def forward(self, x):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), **self._args())
        return y.permute(0, 2, 3, 1)


class SpatialAveragePooling(_SpatialPool):
    """(reference nn/SpatialAveragePooling.scala). ``count_include_pad``
    (default True, the reference's) counts padding in the divisor;
    otherwise each window divides by its real elements."""

    def __init__(self, kernel_w, kernel_h, stride_w=None, stride_h=None,
                 pad_w=0, pad_h=0, ceil_mode=False, count_include_pad=True,
                 name=None):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h,
                         ceil_mode, name)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        if self.count_include_pad:
            kw = dict(divisor_override=self.kernel_h * self.kernel_w)
        else:
            kw = dict(count_include_pad=False)
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), **self._args(), **kw)
        return y.permute(0, 2, 3, 1)


class TemporalMaxPooling(SimpleModule):
    """Max over windows of ``k_w`` time steps every ``d_w`` (default
    ``k_w``) of (B, T, C) sequences (Torch TemporalMaxPooling)."""

    def __init__(self, k_w: int, d_w: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def forward(self, x):
        return F.max_pool1d(x.transpose(1, 2), self.k_w,
                            self.d_w).transpose(1, 2)
