"""Batch norm: CUDA kernels for Hopper, their plain twins, and the custom
gradients around them.

Counterpart of ``bigdl_tpu/ops/bn_kernel.py``. Its four Pallas kernels
become ``csrc/bn.cu``: ``_stats_kernel`` (:func:`bn_stats`), ``_bwd_kernel``
(:func:`bn_bwd_stats`), ``_fba_fwd_kernel`` (:func:`bn_fwd_apply`) and
``_fba_bwd_kernel`` (:func:`bn_bwd_fused`). Beside each wrapper sits its
plain PyTorch version (``*_reference``), and two autograd Functions take
the place of the JAX package's ``custom_vjp`` pair: :func:`fused_bn_train`
(the stats kernel forward, :func:`bn_bwd_stats` backward, the apply and
dx elementwise in PyTorch) and :func:`fused_bn_apply_train` (the whole
block both ways).

Operands are (rows, C) with C contiguous, f32 or bf16; sums and the
per-channel vectors are f32. On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises. Any other
dtype raises on either device. The CUDA kernels take every rows >= 1 and
C >= 1, so the JAX package's ``fused_bn_tileable``/``fba_tileable``/
``min_sublane`` routing (Mosaic tiling rules) is not ported: every shape
goes through the kernel. Its autotuner hooks (``row_block``) are not
ported either (ROADMAP.md queue 1 item 12).

A wrapper call is one count of its ``launches``, whatever it launches:
:func:`bn_stats` and :func:`bn_bwd_stats` run one kernel,
:func:`bn_fwd_apply` and :func:`bn_bwd_fused` two (the reduction, then the
elementwise pass), each after a small memset of its counters.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["bn_stats", "bn_bwd_stats", "bn_fwd_apply", "bn_bwd_fused",
           "bn_stats_reference", "bn_bwd_stats_reference",
           "bn_fwd_apply_reference", "bn_bwd_fused_reference",
           "fused_bn_train", "fused_bn_apply_train"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS, _BWD_STATS, _FWD, _BWD = range(4)
_NTHREADS = 256   # threads per CTA (csrc/bn.cu NTHREADS)
_CTAS_PER_SM = 4  # CTAs of the row sweep per SM

_count_lock = threading.Lock()
_fns: dict = {}
_sms: dict = {}


# ------------------------------------------------------------ plain twins
def bn_stats_reference(x2d):
    """(Σx, Σx²) per channel of a (rows, C) array, in f32."""
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_bwd_stats_reference(dy2d, xhat2d):
    """(Σdy, Σ(dy·x̂)) per channel, in f32."""
    dyf = dy2d.float()
    return dyf.sum(0), (dyf * xhat2d.float()).sum(0)


def bn_fwd_apply_reference(x2d, gamma, beta, eps: float, relu: bool = False):
    """(y, mean, var): the batch stats (biased var = max(Σx²/n − mean², 0))
    and y = x·scale + (β − mean·scale), scale = γ·rsqrt(var + eps), in f32
    with an optional ReLU, rounded once to x's dtype."""
    rows = x2d.shape[0]
    s, sq = bn_stats_reference(x2d)
    mean = s / rows
    var = torch.clamp_min(sq / rows - mean * mean, 0.0)
    scale = torch.rsqrt(var + eps) * gamma
    y = x2d.float() * scale + (beta - mean * scale)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype), mean, var


def bn_bwd_fused_reference(dy2d, x2d, mean, inv, gamma, beta,
                           relu: bool = False):
    """(dx, Σdy, Σ(dy·x̂)) of the BN(+ReLU) block: x̂ = (x − mean)·inv, dy
    zeroed where x̂γ + β > 0 fails (ReLU), dx = (dy − Σdy/n −
    x̂·Σ(dy·x̂)/n)·γ·inv rounded to x's dtype."""
    rows = x2d.shape[0]
    xh = (x2d.float() - mean) * inv
    dyf = dy2d.float()
    if relu:
        dyf = torch.where(xh * gamma + beta > 0.0, dyf,
                          torch.zeros((), device=dyf.device))
    sdy, sdyx = dyf.sum(0), (dyf * xh).sum(0)
    dx = (dyf - sdy / rows - xh * (sdyx / rows)) * (gamma * inv)
    return dx.to(x2d.dtype), sdy, sdyx


# -------------------------------------------------------------- wrappers
def _bind(name: str):
    fn = _fns.get(name)
    if fn is None:
        from bigdl_tpu_torch.ops import _build
        fn = getattr(_build.load("bn"), name)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        head = [i32] * 6 + [i64] + [ptr] * 6
        if name == "bn_reduce":
            fn.argtypes = head + [ptr] * 5 + [i64, i32, f32, i32, ptr]
        else:  # bn_apply
            fn.argtypes = head + [ptr] * 2 + [i64, i32, i32, ptr]
        fn.restype = i32
        _fns[name] = fn
    return fn


def _check_dtypes(kernel: str, **operands):
    """The kernels take f32 or bf16 (x̂ of bn_bwd_stats: f32); checked on
    every device, so no other dtype reaches either version."""
    for name, t in operands.items():
        ok = (t.dtype == torch.float32 if name == "xhat2d"
              else t.dtype in _DTYPES)
        if not ok:
            raise ValueError(f"{kernel} takes float32 or bfloat16 (xhat2d: "
                             f"float32) operands, got {name} {t.dtype}")


def _check_cuda(kernel: str, mats: dict, vecs: dict = None):
    """Raise unless every operand is on one CUDA device, the matrices are
    2-D, contiguous and of one (rows, C) shape with rows, C >= 1, and the
    vectors contiguous f32 (C,)."""
    first = next(iter(mats.values()))
    every = {**mats, **(vecs or {})}
    if not all(t.is_cuda and t.device == first.device
               for t in every.values()):
        devices = [str(t.device) for t in every.values()]
        raise ValueError(f"{kernel} kernel: operands must be on one CUDA "
                         f"device, got {devices}")
    if first.dim() != 2 or first.shape[0] < 1 or first.shape[1] < 1:
        raise ValueError(f"{kernel} kernel: (rows, C) operands with rows, "
                         f"C >= 1, got {tuple(first.shape)}")
    rows, c = first.shape
    for name, t in mats.items():
        if t.shape != first.shape or not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous "
                             f"({rows}, {c}), got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    for name, t in (vecs or {}).items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{kernel} kernel: {name} must be contiguous "
                             f"float32 ({c},), got {t.dtype} "
                             f"{tuple(t.shape)}")


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        props = torch.cuda.get_device_properties(idx)
        _sms[idx] = props.multi_processor_count
    return _sms[idx]


def _plan(rows: int, c: int, mats, device):
    """(vec, tx, channel blocks, slabs, rows per slab): V channels a
    thread, as wide as 16 bytes of the first operand where C and every
    operand's alignment allow; TX threads across channels (a power of two
    <= 32), 256 / TX across rows; enough slabs for ~4 CTAs an SM, with at
    least 4 rows a thread per slab."""
    vec = 16 // mats[0].element_size()
    while vec > 1 and (c % vec or any(
            t.data_ptr() % (vec * t.element_size()) for t in mats)):
        vec //= 2
    groups = -(-c // vec)
    tx = 1
    while tx < min(32, groups):
        tx *= 2
    ty = _NTHREADS // tx
    blocks = -(-c // (tx * vec))
    slabs = max(1, min(-(-rows // (4 * ty)),
                       -(-_CTAS_PER_SM * _sm_count(device) // blocks),
                       65535))
    slab = -(-rows // slabs)
    return vec, tx, blocks, -(-rows // slab), slab


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    """(device index, current stream) of the C entry points' last two
    arguments."""
    return (t.device.index or 0,
            torch.cuda.current_stream(t.device).cuda_stream)


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _reduce(kernel, mode, mats, vecs=(None,) * 4, eps=0.0, relu=False):
    """Launch ``bn_reduce``; returns (out0, out1, aux, plan)."""
    a, b = mats[0], (mats[1] if len(mats) > 1 else None)
    rows, c = a.shape
    plan = vec, tx, blocks, slabs, slab = _plan(rows, c, mats, a.device)
    f32 = dict(dtype=torch.float32, device=a.device)
    out0, out1 = torch.empty(c, **f32), torch.empty(c, **f32)
    aux = torch.empty((2, c), **f32) if mode in (_FWD, _BWD) else None
    part = torch.empty((2, slabs, c), **f32)
    count = torch.zeros(blocks, dtype=torch.int32, device=a.device)
    rc = _bind("bn_reduce")(
        mode, _DTYPES[a.dtype], int(relu), vec, tx, slabs, slab, a.data_ptr(),
        _ptr(b), *(_ptr(v) for v in vecs), part.data_ptr(), count.data_ptr(),
        out0.data_ptr(), out1.data_ptr(), _ptr(aux), rows, c, float(eps),
        *_stream(a))
    _raise_on(rc, kernel)
    return out0, out1, aux, plan


def _apply(kernel, mode, mats, vecs, aux, plan, relu):
    """Launch ``bn_apply`` (y or dx) on the plan of the reduction."""
    a, b = mats[0], (mats[1] if len(mats) > 1 else None)
    vec, tx, _, slabs, slab = plan
    out = torch.empty_like(mats[-1])
    rc = _bind("bn_apply")(
        mode, _DTYPES[a.dtype], int(relu), vec, tx, slabs, slab, a.data_ptr(),
        _ptr(b), *(_ptr(v) for v in vecs), aux.data_ptr(), out.data_ptr(),
        a.shape[0], a.shape[1], *_stream(a))
    _raise_on(rc, kernel)
    return out


def bn_stats(x2d):
    """(Σx, Σx²) per channel of a (rows, C) array in f32: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_dtypes("bn_stats", x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_stats_reference(x2d)
    _check_cuda("bn_stats", {"x2d": x2d})
    s, sq, _, _ = _reduce("bn_stats", _STATS, (x2d,))
    _count(bn_stats)
    return s, sq


def bn_bwd_stats(dy2d, xhat2d):
    """(Σdy, Σ(dy·x̂)) per channel: dy f32 or bf16, x̂ f32."""
    _check_dtypes("bn_bwd_stats", dy2d=dy2d, xhat2d=xhat2d)
    if dy2d.device.type == "cpu":
        return bn_bwd_stats_reference(dy2d, xhat2d)
    _check_cuda("bn_bwd_stats", {"dy2d": dy2d, "xhat2d": xhat2d})
    sdy, sdyx, _, _ = _reduce("bn_bwd_stats", _BWD_STATS, (dy2d, xhat2d))
    _count(bn_bwd_stats)
    return sdy, sdyx


def bn_fwd_apply(x2d, gamma, beta, eps: float, relu: bool = False):
    """Training-mode BN(+ReLU) forward of a (rows, C) array: ``(y, mean,
    var)``, y in x's dtype, the batch mean and biased var in f32."""
    _check_dtypes("bn_fwd_apply", x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_fwd_apply_reference(x2d, gamma, beta, eps, relu)
    vecs = {"gamma": gamma, "beta": beta}
    _check_cuda("bn_fwd_apply", {"x2d": x2d}, vecs)
    mean, var, aux, plan = _reduce("bn_fwd_apply", _FWD, (x2d,),
                                   (gamma, beta, None, None), eps)
    y = _apply("bn_fwd_apply", _FWD, (x2d,), (None,) * 4, aux, plan, relu)
    _count(bn_fwd_apply)
    return y, mean, var


def bn_bwd_fused(dy2d, x2d, mean, inv, gamma, beta, relu: bool = False):
    """The whole BN(+ReLU) backward: ``(dx, Σdy, Σ(dy·x̂))`` (the sums are
    dβ and dγ), dx in x's dtype."""
    _check_dtypes("bn_bwd_fused", dy2d=dy2d, x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_bwd_fused_reference(dy2d, x2d, mean, inv, gamma, beta,
                                      relu)
    if dy2d.dtype != x2d.dtype:
        raise ValueError(f"bn_bwd_fused kernel: dy {dy2d.dtype} and x "
                         f"{x2d.dtype} must share a dtype")
    vecs = (mean, inv, gamma, beta)
    _check_cuda("bn_bwd_fused", {"dy2d": dy2d, "x2d": x2d},
                dict(zip(("mean", "inv", "gamma", "beta"), vecs)))
    sdy, sdyx, aux, plan = _reduce("bn_bwd_fused", _BWD, (dy2d, x2d), vecs,
                                   relu=relu)
    dx = _apply("bn_bwd_fused", _BWD, (dy2d, x2d), vecs, aux, plan, relu)
    _count(bn_bwd_fused)
    return dx, sdy, sdyx


for _w in (bn_stats, bn_bwd_stats, bn_fwd_apply, bn_bwd_fused):
    _w.launches = 0  # wrapper calls that launched in this process


# ------------------------------------------------------ autograd Functions
class _FusedBNTrain(torch.autograd.Function):
    """``fused_bn_train``'s custom VJP: stats by :func:`bn_stats`, the
    apply in PyTorch; backward sums by :func:`bn_bwd_stats` over an f32
    x̂, dx in PyTorch. dγ = Σ(dy·x̂), dβ = Σdy."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        rows = x2.shape[0]
        s, sq = bn_stats(x2)
        mean = s / rows
        var = torch.clamp_min(sq / rows - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        scale = inv * gamma
        y = (x.float() * scale + (beta - mean * scale)).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, d_mean, d_var):
        del d_mean, d_var  # the running-stat EMA carries no gradient
        x, mean, inv, gamma = ctx.saved_tensors
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        rows = x2.shape[0]
        dy2 = dy.reshape(-1, c).contiguous()
        xhat2 = (x2.float() - mean) * inv
        sdy, sdyx = bn_bwd_stats(dy2, xhat2)
        dx = ((dy2.float() - sdy / rows - xhat2 * (sdyx / rows))
              * (gamma * inv)).to(x.dtype)
        return dx.reshape(x.shape), sdyx, sdy, None


class _FusedBNApplyTrain(torch.autograd.Function):
    """``fused_bn_apply_train``'s custom VJP: :func:`bn_fwd_apply`
    forward, :func:`bn_bwd_fused` backward with inv = rsqrt(var + eps)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, relu: bool):
        c = x.shape[-1]
        y2, mean, var = bn_fwd_apply(x.reshape(-1, c), gamma, beta, eps,
                                     relu)
        ctx.save_for_backward(x, mean, var, gamma, beta)
        ctx.eps, ctx.relu = eps, relu
        ctx.mark_non_differentiable(mean, var)
        return y2.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, d_mean, d_var):
        del d_mean, d_var
        x, mean, var, gamma, beta = ctx.saved_tensors
        c = x.shape[-1]
        inv = torch.rsqrt(var + ctx.eps)
        dx2, sdy, sdyx = bn_bwd_fused(dy.reshape(-1, c).contiguous(),
                                      x.reshape(-1, c), mean, inv, gamma,
                                      beta, ctx.relu)
        return dx2.reshape(x.shape), sdyx, sdy, None, None


def fused_bn_train(x, gamma, beta, eps: float):
    """Training-mode BN over the last axis with the stats kernels. x:
    (..., C); returns (y, mean, var), mean and var the batch stats the
    caller folds into its running estimates (no gradient)."""
    return _FusedBNTrain.apply(x, gamma, beta, eps)


def fused_bn_apply_train(x, gamma, beta, eps: float, relu: bool = False):
    """Training-mode BN(+ReLU) over the last axis with both directions in
    the fused kernels; returns (y, mean, var) as :func:`fused_bn_train`."""
    return _FusedBNApplyTrain.apply(x, gamma, beta, eps, bool(relu))
