"""Batch normalization (counterpart of ``BatchNormalization`` and its
helpers in ``bigdl_tpu/nn/norm.py``; reference
nn/BatchNormalization.scala).

The JAX package carries the running statistics in a state pytree; here
they are f32 buffers (``running_mean``, ``running_var``) that a training
forward updates in place. Routing is the JAX package's: a training-mode
forward takes the kernels (``ops/bn_kernel.py``) only when ``fused`` is set,
the module is affine and ``stat_sample`` is unset; everything else is plain
PyTorch in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.ops import bn_kernel

__all__ = ["BatchNormalization", "SpatialBatchNormalization",
           "set_bn_fused", "bn_fused_mode", "set_bn_stat_sample"]


def _canon_fused(fused) -> "bool | str":
    """False/None/"off" -> False (plain path), True/"stats" -> "stats"
    (the stats kernels), "apply" -> "apply" (the fused block)."""
    if fused in (False, None, "off"):
        return False
    if fused in (True, "stats"):
        return "stats"
    if fused == "apply":
        return "apply"
    raise ValueError(f"fused must be one of False/'off'/True/'stats'/"
                     f"'apply', got {fused!r}")


class BatchNormalization(nn.Module):
    """Batch normalization over the feature (last) axis (defaults eps=1e-5,
    momentum=0.1, affine=True as the reference's constructor).

    Training normalizes by the batch statistics and updates the buffers
    with ``r = (1 - m) * r + m * batch_stat``, the variance taken unbiased
    (n / (n - 1)); eval normalizes by the buffers. ``fused``: False/"off",
    True/"stats" or "apply" (see :func:`set_bn_fused`). ``fuse_relu`` is
    set by :func:`~bigdl_tpu_torch.nn.structural.absorb_bn_relu` when this
    BN swallowed the ReLU after it; every path then applies that ReLU.
    ``stat_sample=k`` takes the training statistics from the first k batch
    rows only. ``axis_name`` (cross-replica statistics under shard_map)
    comes with data parallelism."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 axis_name: Optional[str] = None, gamma_init: float = 1.0,
                 stat_sample: Optional[int] = None, fused=False,
                 name: Optional[str] = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "BatchNormalization(axis_name=...) is not in the PyTorch "
                "port yet: cross-replica statistics come with data "
                "parallelism (ROADMAP.md queue 1 item 8)")
        self.name = name if name is not None else type(self).__name__
        self.n_output = n_output
        self.eps, self.momentum, self.affine = eps, momentum, affine
        self.gamma_init = gamma_init
        self.fused = _canon_fused(fused)
        self.fuse_relu = False
        self.stat_sample = stat_sample
        if affine:
            self.weight = nn.Parameter(torch.full((n_output,),
                                                  float(gamma_init)))
            self.bias = nn.Parameter(torch.zeros(n_output))
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    @torch.no_grad()
    def _update_running(self, mean, var, n: int):
        m = self.momentum
        unbiased = var * n / max(1, n - 1)
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x):
        c = x.shape[-1]
        if (self.training and self.fused and self.affine
                and not self.stat_sample):
            if self.fused == "apply":
                y, mean, var = bn_kernel.fused_bn_apply_train(
                    x, self.weight, self.bias, self.eps, self.fuse_relu)
            else:
                y, mean, var = bn_kernel.fused_bn_train(
                    x, self.weight, self.bias, self.eps)
                if self.fuse_relu:
                    y = torch.relu(y)
            self._update_running(mean, var, x.numel() // c)
            return y
        xf = x.float()
        if self.training:
            k = self.stat_sample
            xs = xf if (not k or k >= xf.shape[0]) else xf[:k]
            axes = tuple(range(x.dim() - 1))
            mean = xs.mean(dim=axes)
            var = xs.square().mean(dim=axes) - mean.square()
            self._update_running(mean.detach(), var.detach(),
                                 xs.numel() // c)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = inv * self.weight
            shift = self.bias - mean * scale
        else:
            scale = inv
            shift = -mean * scale
        y = xf * scale + shift
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"
                f", fused={self.fused!r}, fuse_relu={self.fuse_relu}")


class SpatialBatchNormalization(BatchNormalization):
    """BN over NHWC with per-channel stats (reference
    nn/SpatialBatchNormalization.scala): the same reduction, kept as its
    own class as in the model zoo."""


def set_bn_stat_sample(module: nn.Module, k: Optional[int]) -> nn.Module:
    """Set ``stat_sample`` on every BatchNormalization under ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNormalization):
            m.stat_sample = k
    return module


def set_bn_fused(module: nn.Module, fused=True) -> nn.Module:
    """Route every BatchNormalization through the BN kernels: True/"stats"
    the stats kernels (apply and dx in PyTorch), "apply" the fused block
    (stats, apply and the absorbed ReLU in the forward kernels; the
    reductions and dx in the backward ones), False/"off" back to plain
    PyTorch. "apply" also absorbs each ReLU that directly follows a BN in
    a Sequential (:func:`~bigdl_tpu_torch.nn.structural.absorb_bn_relu`);
    the rewrite stays when the mode flips back, since the BN applies the
    absorbed ReLU on every path."""
    mode = _canon_fused(fused)
    for m in module.modules():
        if isinstance(m, BatchNormalization):
            m.fused = mode
    if mode == "apply":
        from bigdl_tpu_torch.nn.structural import absorb_bn_relu
        absorb_bn_relu(module)
    return module


def bn_fused_mode(module: nn.Module) -> str:
    """"apply" if any BatchNormalization runs the fused block, else
    "stats" if any runs the stats kernels, else "off"."""
    modes = {m.fused for m in module.modules()
             if isinstance(m, BatchNormalization)}
    if "apply" in modes:
        return "apply"
    if "stats" in modes:
        return "stats"
    return "off"
