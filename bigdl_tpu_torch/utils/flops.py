"""Analytic matmul and conv FLOPs of a training step (counterpart of
``bigdl_tpu/utils/flops.py``), the numerator of the perf harness's MFU.

The JAX package walks the jaxpr of its train step. The port runs the step
once on fake tensors (``FakeTensorMode``: shapes only, nothing computed,
no kernel launched, any size) under a dispatch mode that counts each aten
op with the JAX package's rules, so the two counts are equal:

* a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``): 2 x batch x M x N
  x K, as a ``dot_general``;
* a convolution: 2 x |out| x (Cin / groups) x kh x kw; its input gradient
  is the conv JAX's transpose builds (the input's size, Cout / groups
  input channels, divided by the stride's structural zeros), its weight
  gradient the forward's count; a gradient autograd does not ask for (the
  stem's input) is not counted;
* everything else (BN, elementwise, reductions, gathers) counts nothing.

A 1x1 convolution run as a product under the GEMM layout counts as
``matmul``; the total is the same. Remat bodies count once (the step is
counted with remat off). The flash kernels launch through ``ctypes`` and
are invisible to a dispatch mode (on the CPU their plain versions run
dense products): their ``autograd.Function`` declares the algorithmic
count with :func:`declared`, as the JAX kernels' ``CostEstimate`` does,
and what runs inside is not counted.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["step_flops_by_kind", "fn_flops_by_kind", "flash_flops",
           "declared", "conv_unit_flops", "live_block_pairs",
           "clamp_block"]

_aten = torch.ops.aten
_ACTIVE: list = []  # the counters of the runs in progress, innermost last

# the JAX flash kernels' default tile (bigdl_tpu/ops/attention_kernel.py
# _DEFAULT_BLOCK), to which their causal count is granular
DEFAULT_BLOCK = 512


def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= float(x)
    return out


def _conv_flops(func, args, out):
    """FLOPs of one aten convolution call (forward), or of the gradients a
    ``convolution_backward`` call computes."""
    if func is _aten.convolution.default:
        if args[6]:
            raise NotImplementedError(
                "the FLOP count does not mirror JAX's for a transposed "
                "convolution")
        w = args[1]
        return 2.0 * out.numel() * w.shape[1] * _prod(w.shape[2:])
    if args[7]:
        raise NotImplementedError(
            "the FLOP count does not mirror JAX's for a transposed "
            "convolution")
    dy, x, w = args[0], args[1], args[2]
    stride, groups, mask = args[4], args[9], args[10]
    k = _prod(w.shape[2:])
    total = 0.0
    if mask[0]:  # JAX's transpose: x-sized output, Cout/groups inputs
        total += 2.0 * x.numel() * (w.shape[0] / groups) * k / _prod(stride)
    if mask[1]:  # the forward's count
        total += 2.0 * dy.numel() * w.shape[1] * k
    return total


def _op_flops(func, args, out) -> tuple:
    """(kind, FLOPs) of one aten call."""
    if func in (_aten.mm.default, _aten.addmm.default):
        a, b = args[-2], args[-1]
        return "matmul", 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        a, b = args[-2], args[-1]
        return "matmul", 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * \
            b.shape[2]
    if func in (_aten.convolution.default,
                _aten.convolution_backward.default):
        return "conv", _conv_flops(func, args, out)
    return None, 0.0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = {"matmul": 0.0, "conv": 0.0}
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.muted:
            kind, f = _op_flops(func, args, out)
            if f:
                self.total[kind] += f
        return out


@contextlib.contextmanager
def declared(flops, *args, kind: str = "matmul"):
    """Inside a count: add ``flops`` (or ``flops(*args)``, computed only
    then) of ``kind`` and count nothing the body runs. Outside a count:
    nothing."""
    if not _ACTIVE:
        yield
        return
    counter = _ACTIVE[-1]
    counter.total[kind] += float(flops(*args) if callable(flops) else flops)
    counter.muted += 1
    try:
        yield
    finally:
        counter.muted -= 1


def live_block_pairs(sq: int, sk: int, bq: int, bk: int, causal: bool,
                     q_offset: int) -> int:
    """(q block, k block) pairs whose products run per (batch, head), the
    JAX package's ``_live_block_pairs``: fully-future k blocks are skipped
    under ``causal``."""
    n_q, n_k = sq // bq, sk // bk
    if not causal:
        return n_q * n_k
    total = 0
    for j in range(n_q):
        q_end = q_offset + (j + 1) * bq - 1
        total += min(n_k, max(0, q_end // bk + 1))
    return total


def clamp_block(block: int, s: int) -> int:
    """The JAX package's ``_clamp_block``: the largest standard tile <=
    ``block`` that divides ``s`` (falling through 256/128), else
    min(block, s)."""
    b = min(block, max(8, s))
    if s % b:
        for cand in (256, 128):
            if cand < b and s % cand == 0:
                return cand
    return b


def flash_flops(b: int, h: int, s_q: int, s_k: int, d: int, causal: bool,
                block_q: Optional[int] = None,
                block_k: Optional[int] = None) -> tuple:
    """(forward, backward) FLOPs of one flash attention call as the JAX
    package counts them: per live block pair, qk+pv forward and dP+dQ+dV+dK
    backward (the backward's recomputation not counted), at the JAX
    blocks (512 unless given, clamped to the sequence). A key length the
    JAX tiles do not divide takes its dense path: full s_q x s_k."""
    bq = min(clamp_block(block_q or DEFAULT_BLOCK, s_q), max(8, s_q))
    bk = min(clamp_block(block_k or DEFAULT_BLOCK, s_k), max(8, s_k))
    unit_dense = 2.0 * b * h * s_q * s_k * d
    if s_k % bk:
        return 2 * unit_dense, 4 * unit_dense
    sq = -(-s_q // bq) * bq
    unit = 2.0 * b * h * live_block_pairs(sq, s_k, bq, bk, causal,
                                          s_k - s_q) * bq * bk * d
    return 2 * unit, 4 * unit


def conv_unit_flops(n: int, h_out: int, w_out: int, cin: int, cout: int,
                    kh: int, kw: int, groups: int = 1) -> float:
    """Closed-form 2·MAC FLOPs of one conv pass (fwd == dgrad == wgrad),
    also the count of the 1x1 GEMM spelling."""
    return 2.0 * n * h_out * w_out * cout * (cin / max(1, groups)) * kh * kw


def _count(fn: Callable) -> dict:
    """``{"matmul": f, "conv": f}`` of ``fn(fake_mode)`` run inside a
    ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = _Counter()
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        _ACTIVE.append(counter)
        try:
            with counter:
                fn(fake)
        finally:
            _ACTIVE.pop()
    return counter.total


def fn_flops_by_kind(fn: Callable, *args, **kwargs) -> dict:
    """``{"matmul": f, "conv": f}`` of ``fn(*args, **kwargs)``, run on fake
    tensors: tensor arguments (real CPU tensors or ones ``fn`` makes) are
    shapes only."""
    return _count(lambda fake: fn(*args, **kwargs))


@contextlib.contextmanager
def _remat_off(model):
    mods = [m for m in model.modules() if getattr(m, "remat", False)]
    saved = [m.remat for m in mods]
    for m in mods:
        m.remat = False
    try:
        yield
    finally:
        for m, r in zip(mods, saved):
            m.remat = r


def step_flops_by_kind(model: torch.nn.Module, x_shape, x_dtype, y_shape,
                       criterion, y_dtype=torch.int32,
                       forward_kwargs: Optional[dict] = None) -> dict:
    """``{"matmul": f, "conv": f}`` of one training step of ``model`` (on
    any device): the forward on an ``x_shape`` input of ``x_dtype``
    (with ``forward_kwargs``), ``criterion`` on the f32 output against a
    ``y_shape`` target, the gradient of every trainable parameter. Nothing
    is computed and the model's tensors are not touched."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())

    def step(fake):
        # fake CPU twins whatever the model's device: shapes, strides and
        # dtypes, so each kernel wrapper takes its plain path
        fakes = {n: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device="cpu")
                 for n, t in tensors.items()}
        for n in names:
            fakes[n].requires_grad_(True)
        x = torch.empty(tuple(x_shape), dtype=x_dtype)
        y = torch.empty(tuple(y_shape), dtype=y_dtype)
        out = torch.func.functional_call(model, fakes, (x,),
                                         forward_kwargs or {})
        loss = criterion(out.float(), y)
        torch.autograd.grad(loss, [fakes[n] for n in names])

    with _remat_off(model):
        return _count(step)
