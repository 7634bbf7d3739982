"""Batch normalization (counterpart of ``BatchNormalization`` and its
helpers in ``bigdl_tpu/nn/norm.py``; reference
nn/BatchNormalization.scala).

The JAX package carries the running statistics in a state pytree; here
they are f32 buffers (``running_mean``, ``running_var``) that a training
forward updates in place. Routing is the JAX package's: a training-mode
forward takes the kernels (``ops/bn_kernel.py``) only when ``fused`` is set,
the module is affine and ``stat_sample`` is unset; everything else is plain
PyTorch in f32.

The local normalisations (``SpatialCrossMapLRN``, the subtractive,
divisive and contrastive ones, ``Normalize``) are plain PyTorch, as the
JAX layers are plain XLA: memory-bound elementwise chains and small
depthwise convolutions, for which no kernel is written. The LRN window
over channels is the JAX one, (size - 1) // 2 channels before and the
rest after; ``F.local_response_norm`` pads the mirror of that, so the two
differ at an even size.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Module, SimpleModule
from bigdl_tpu_torch.ops import bn_kernel

__all__ = ["BatchNormalization", "SpatialBatchNormalization",
           "set_bn_fused", "bn_fused_mode", "set_bn_stat_sample",
           "set_bn_axis", "unfuse_bn_for_spmd",
           "SpatialCrossMapLRN", "SpatialSubtractiveNormalization",
           "SpatialDivisiveNormalization", "SpatialContrastiveNormalization",
           "Normalize"]


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


class BatchNormalization(Module):
    """Batch normalization over the feature (last) axis (defaults eps=1e-5,
    momentum=0.1, affine=True as the reference's constructor).

    Training normalizes by the batch statistics and updates the buffers
    with ``r = (1 - m) * r + m * batch_stat``, the variance taken unbiased
    (n / (n - 1)); eval normalizes by the buffers. ``fused``: False/"off",
    True/"stats" or "apply" (see :func:`set_bn_fused`). ``fuse_relu`` is
    set by :func:`~bigdl_tpu_torch.nn.structural.absorb_bn_relu` when this
    BN swallowed the ReLU after it; every path then applies that ReLU.
    ``stat_sample=k`` takes the training statistics from the first k batch
    rows only.

    ``axis_name`` names a mesh axis (the port has ``"data"``): at more
    than one rank on it, training normalises by the statistics of the
    global batch the ranks hold parts of, the running variance counting
    the global rows (the JAX ``pmean``/``psum``). The kernel modes take
    :func:`~bigdl_tpu_torch.ops.bn_kernel.sync_bn_train`, the stats
    kernels with their sums all-reduced ("apply" too, its ReLU after:
    the fused block uses its statistics in the launch that computes them);
    the plain path all-reduces its sums through autograd. A
    :class:`~bigdl_tpu_torch.parallel.DataParallel` step sets it on every
    BN (:func:`set_bn_axis`), as a JAX BN under a mesh reduces over the
    global batch on its own."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 axis_name: Optional[str] = None, gamma_init: float = 1.0,
                 stat_sample: Optional[int] = None, fused=False,
                 name: Optional[str] = None):
        super().__init__(name)
        _check_axis(axis_name)
        self.axis_name = axis_name
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

    def _ranks(self):
        """(process group, ranks) of ``axis_name``; (None, 1) without."""
        if self.axis_name is None or not self.training:
            return None, 1
        from bigdl_tpu_torch.parallel.mesh import axis_group
        return axis_group(self.axis_name)

    def forward(self, x):
        c = x.shape[-1]
        group, ranks = self._ranks()
        if (self.training and self.fused and self.affine
                and not self.stat_sample):
            if ranks > 1:
                y, mean, var = bn_kernel.sync_bn_train(
                    x, self.weight, self.bias, self.eps, group, ranks)
                if self.fuse_relu:
                    y = torch.relu(y)
                self._update_running(mean, var, x.numel() // c * ranks)
                return y
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
            if ranks > 1:
                n = xs.numel() // c * ranks
                sums = _AllReduceSum.apply(torch.stack(
                    [xs.sum(dim=axes), xs.square().sum(dim=axes)]), group)
                mean, mean_sq = sums[0] / n, sums[1] / n
            else:
                n = xs.numel() // c
                mean, mean_sq = xs.mean(dim=axes), xs.square().mean(dim=axes)
            var = mean_sq - mean.square()
            self._update_running(mean.detach(), var.detach(), n)
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
        axis = f", axis_name={self.axis_name!r}" if self.axis_name else ""
        return (f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"
                f", fused={self.fused!r}, fuse_relu={self.fuse_relu}{axis}")


def _check_axis(axis_name) -> None:
    if axis_name not in (None, "data"):
        raise NotImplementedError(
            f"BatchNormalization(axis_name={axis_name!r}): the port's batch "
            f"norm reduces over the 'data' axis (a tensor-parallel conv's "
            f"output is gathered whole before it); the sequence and "
            f"pipeline axes come with ROADMAP.md queue 1 entry 13(b)")


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group's ranks; its gradient is
    the sum of the ranks' gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, group=group)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


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


def set_bn_axis(module: nn.Module, axis_name: str) -> int:
    """Set ``axis_name`` on every BatchNormalization under ``module`` that
    has none. Returns how many it set."""
    _check_axis(axis_name)
    count = 0
    for m in module.modules():
        if isinstance(m, BatchNormalization) and m.axis_name is None:
            m.axis_name = axis_name
            count += 1
    return count


def unfuse_bn_for_spmd(module: nn.Module, n_devices: int) -> int:
    """The JAX package's switch of every fused BN back to the plain path
    before a multi-device step (its Pallas kernels carry no partitioning
    rule); returns how many it switched, 0 for one device. The port's
    data-parallel step does not call it: its kernels take a rank's part
    of the batch and all-reduce their sums (:func:`set_bn_axis`)."""
    count = 0
    if n_devices > 1:
        for m in module.modules():
            if isinstance(m, BatchNormalization) and m.fused:
                m.fused = False
                count += 1
    return count


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


class SpatialCrossMapLRN(SimpleModule):
    """Local response normalisation across channels (reference
    nn/SpatialCrossMapLRN.scala): y = x / (k + alpha/size * S)^beta, S
    the sum of x^2 over ``size`` channels, (size - 1) // 2 before the
    channel and the rest after it, zeros past the ends."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        c, half = x.shape[-1], (self.size - 1) // 2
        sq = F.pad(torch.square(x), (half, self.size - 1 - half))
        sums = sq[..., :c]
        for j in range(1, self.size):
            sums = sums + sq[..., j:j + c]
        return x / torch.pow(self.k + (self.alpha / self.size) * sums,
                             self.beta)


def _gaussian_kernel2d(size: int) -> torch.Tensor:
    """The normalised 2-D gaussian window of ``size`` taps, sigma =
    size / 4 (Torch's image.gaussian default)."""
    sigma = 0.25 * size
    r = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(r / sigma))
    k = torch.outer(g, g)
    return k / k.sum()


class SpatialSubtractiveNormalization(SimpleModule):
    """Each channel minus its local mean under ``kernel`` (default a
    9 x 9 gaussian), normalised to sum 1 and divided at the edges by the
    kernel's mass inside the image (reference
    nn/SpatialSubtractiveNormalization.scala). The kernel is a buffer
    outside the state dict, as it is outside the JAX trees."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        k = (_gaussian_kernel2d(9) if kernel is None
             else torch.as_tensor(kernel, dtype=torch.float32))
        self.register_buffer("kernel", k, persistent=False)

    def _local_mean(self, x):
        k = self.kernel.to(x.dtype)
        k = k / k.sum()
        kh, kw = k.shape
        pads = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
        c = self.n_input_plane
        xc = F.pad(x.permute(0, 3, 1, 2), pads)
        mean = F.conv2d(xc, k.expand(c, 1, kh, kw), groups=c)
        ones = F.pad(torch.ones_like(x[:1, :, :, :1]).permute(0, 3, 1, 2),
                     pads)
        mass = F.conv2d(ones, k[None, None])
        return (mean / mass.clamp_min(1e-8)).permute(0, 2, 3, 1)

    def forward(self, x):
        return x - self._local_mean(x)


class SpatialDivisiveNormalization(SimpleModule):
    """Each value over its local standard deviation, floored per sample at
    max(mean std, threshold) (reference
    nn/SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, name: Optional[str] = None):
        super().__init__(name)
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.threshold = threshold

    def forward(self, x):
        local_std = torch.sqrt(self.sub._local_mean(torch.square(x))
                               .clamp_min(0.0))
        mean_std = local_std.mean(dim=(1, 2, 3), keepdim=True)
        return x / torch.maximum(local_std,
                                 mean_std.clamp_min(self.threshold))


class SpatialContrastiveNormalization(SimpleModule):
    """Subtractive, then divisive normalisation (reference
    nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, name: Optional[str] = None):
        super().__init__(name)
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold)

    def forward(self, x):
        return self.div(self.sub(x))


class Normalize(SimpleModule):
    """Rows over max(their Lp norm, eps) (reference nn/Normalize.scala);
    p = inf takes the max |x|."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == math.inf:
            n = x.abs().amax(-1, keepdim=True)
        else:
            n = x.abs().pow(self.p).sum(-1, keepdim=True).pow(1.0 / self.p)
        return x / n.clamp_min(self.eps)
