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

A stated difference: the port's :func:`bn_bwd_stats` takes (dy, x, mean,
inv) where the JAX one takes (dy, x̂); it takes the same sums of the same
x̂ = (x − mean)·inv, formed in the kernel instead of read as an f32 array,
so it reads x in its own dtype (4 bytes an element of bf16 dy and x, not
6).

Operands are (rows, C) with C contiguous, f32 or bf16; sums and the
per-channel vectors are f32. On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises. Any other
dtype raises on either device. The CUDA kernels take every rows >= 1 and
C >= 1, so the JAX package's ``fused_bn_tileable``/``fba_tileable``/
``min_sublane`` routing (Mosaic tiling rules) is not ported: every shape
goes through the kernel. The JAX package's autotuner hooks
(``row_block``) choose the launch plan's slab height here (the rows a
CTA covers): under ``--autotune cached|measure`` :func:`_coop` asks
``tuning.bn_row_block`` (the stats pair) or ``tuning.fba_row_block`` (the
fused pair) for a height among :func:`slab_heights`; off, and on a
cached-mode miss, the plan is the untuned one.

A wrapper call is one count of its ``launches``, and launches one kernel
and nothing else: each of the four is a mode of one cooperative kernel
(``bn_coop_kernel`` in ``csrc/bn.cu``) that meets at grid-wide barriers.
Their counters are one pair per (device, stream), shared by the four,
zeroed when a stream first calls one of them and left at zero by every
launch; a CUDA graph captured on a stream shares that stream's counters,
so it must not replay while eager calls run on its capture stream. The
launch plan (:func:`_plan`) is a pure function of the shape, the vector
width, the CTAs the card holds and the slab height (None: the untuned
one).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from bigdl_tpu_torch.ops import lint_sites as _sites

__all__ = ["bn_stats", "bn_bwd_stats", "bn_fwd_apply", "bn_bwd_fused",
           "bn_stats_reference", "bn_bwd_stats_reference",
           "bn_fwd_apply_reference", "bn_bwd_fused_reference",
           "fused_bn_train", "fused_bn_apply_train", "sync_bn_train",
           "slab_heights", "pinned_slab"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bn_coop's modes (csrc/bn.cu Mode)
_STATS, _FWD, _BWD_STATS, _BWD_FUSED = range(4)
# 16-byte slots a thread of each mode keeps in shared memory (csrc/bn.cu
# Layout::SLOTS): a thread whose rows all fit reads its operands once
_SLOTS = {_STATS: 8, _FWD: 24, _BWD_STATS: 11, _BWD_FUSED: 11}
_VECS = ("mean", "inv", "gamma", "beta")
_NTHREADS = 256   # threads per CTA (csrc/bn.cu NTHREADS)
_RED_BYTES = 2 * _NTHREADS * 8 * 4  # csrc/bn.cu's static red[2][256 * MAXV]
_SLAB_ROWS = 8    # least rows a thread per slab, where there are two slabs

_count_lock = threading.Lock()
_fns: dict = {}
_ctas: dict = {}
_syncs: dict = {}
_UNSET = object()
_pinned = _UNSET  # a slab height every launch takes (pinned_slab)


# ------------------------------------------------------------ plain twins
def bn_stats_reference(x2d):
    """(Σx, Σx²) per channel of a (rows, C) array, in f32."""
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_bwd_stats_reference(dy2d, x2d, mean, inv):
    """(Σdy, Σ(dy·x̂)) per channel in f32, x̂ = (x − mean)·inv."""
    dyf = dy2d.float()
    return dyf.sum(0), (dyf * ((x2d.float() - mean) * inv)).sum(0)


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
        fn.argtypes = {
            "bn_coop_ctas": [i32] * 5 + [ctypes.POINTER(ctypes.c_int)],
            "bn_coop": [i32] * 7 + [i64] + [ptr] * 11 + [i64, i32, f32, i32,
                                                         ptr],
        }[name]
        fn.restype = i32
        _fns[name] = fn
    return fn


def _check_dtypes(kernel: str, **operands):
    """The kernels take f32 or bf16 (rows, C) operands and f32 (C,)
    vectors; checked on every device, so no other dtype reaches either
    version."""
    for name, t in operands.items():
        ok = (t.dtype == torch.float32 if name in _VECS
              else t.dtype in _DTYPES)
        if not ok:
            raise ValueError(f"{kernel} takes float32 or bfloat16 operands "
                             f"and float32 {'/'.join(_VECS)}, got {name} "
                             f"{t.dtype}")


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


def _vec(c: int, mats) -> int:
    """V channels a thread: as wide as 16 bytes of the first operand where
    C and every operand's alignment allow."""
    vec = 16 // mats[0].element_size()
    while vec > 1 and (c % vec or any(
            t.data_ptr() % (vec * t.element_size()) for t in mats)):
        vec //= 2
    return vec


class Plan(NamedTuple):
    """One launch of ``bn_coop``: TX threads across channels (a power of
    two <= 32, 256 / TX across rows), channel blocks of TX·V channels,
    ``slabs`` slabs of ``slab`` rows, ``grid`` CTAs; ``once``: every
    operand is read from device memory once (phase 1, where the mode has
    one, finds every row still in shared memory)."""
    tx: int
    blocks: int
    slabs: int
    slab: int
    grid: int
    once: bool


@functools.lru_cache(maxsize=1024)
def _plan(mode: int, rows: int, c: int, vec: int, ctas: int,
          slab: "int | None" = None) -> Plan:
    """The launch of ``mode`` over a (rows, C) array with V = ``vec``, on a
    card that holds ``ctas`` CTAs of it at once. Untuned (``slab`` None):
    one (channel block, slab) a CTA for as many CTAs as that, with at
    least _SLAB_ROWS rows a thread per slab (fewer CTAs meet at the
    barriers of a small array); one slab, and CTAs looping over channel
    blocks, when C has more blocks than that. A tuned ``slab`` (from
    :func:`slab_heights`) sets the rows a slab covers."""
    groups = -(-c // vec)
    tx = 1
    while tx < min(32, groups):
        tx *= 2
    ty = _NTHREADS // tx
    blocks = -(-c // (tx * vec))
    if slab is None:
        slabs = max(1, min(ctas // blocks, rows // (_SLAB_ROWS * ty)))
        slab = -(-rows // slabs)
    slabs = -(-rows // slab)
    once = mode in (_STATS, _BWD_STATS) or (
        blocks * slabs <= ctas and -(-slab // ty) <= _SLOTS[mode])
    return Plan(tx, blocks, slabs, slab, min(ctas, blocks * slabs), once)


def slab_heights(mode: int, rows: int, c: int, vec: int,
                 ctas: int) -> tuple:
    """The slab heights the tuner may give ``mode``'s plan at (rows, C):
    those at which every CTA stays resident (blocks x slabs <= ``ctas``),
    from one slab to as many as the CTAs allow in powers of two, with the
    untuned plan's height first. Empty where C alone has more channel
    blocks than ``ctas``."""
    base = _plan(mode, rows, c, vec, ctas)
    smax = min(ctas // base.blocks, rows)
    if smax < 1:
        return ()
    counts = {base.slabs, smax}
    s = 1
    while s <= smax:
        counts.add(s)
        s *= 2
    heights = [base.slab]
    for n in sorted(counts):
        h = -(-rows // n)
        if h not in heights and base.blocks * -(-rows // h) <= ctas:
            heights.append(h)
    return tuple(heights)


@contextlib.contextmanager
def pinned_slab(slab: "int | None"):
    """Every launch in the block takes slab height ``slab`` (None: the
    untuned plan), whatever the tuner says: how the tuner times its
    candidates."""
    global _pinned
    before, _pinned = _pinned, slab
    try:
        yield
    finally:
        _pinned = before


def _tuned_slab(mode: int, x2d, vec: int, relu: bool) -> "int | None":
    """The slab height the tuner gives this launch, or None. The two
    kernels of a key share its decision, so its heights are legal for
    both (the fewer CTAs of the two)."""
    if _pinned is not _UNSET:
        return _pinned
    from bigdl_tpu_torch.tuning import autotune as _at
    if _at.get_mode() == "off":
        return None
    rows, c = x2d.shape
    stats = mode in (_STATS, _BWD_STATS)
    pair = (_STATS, _BWD_STATS) if stats else (_FWD, _BWD_FUSED)
    is_bf16 = _DTYPES[x2d.dtype]
    ctas = min(_coop_ctas(x2d.device, m, is_bf16, relu and not stats, vec)
               for m in pair)
    heights = slab_heights(pair[0], rows, c, vec, ctas)
    if stats:
        return _at.bn_row_block(rows, c, x2d.dtype, heights)
    return _at.fba_row_block(rows, c, x2d.dtype, relu, heights)


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


def _coop_ctas(device, mode: int, is_bf16: int, relu: bool, vec: int):
    """CTAs of one ``bn_coop`` instance that the card holds at once (the
    most its cooperative launch may have)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, mode, is_bf16, relu, vec)
    if key not in _ctas:
        n = ctypes.c_int(0)
        _raise_on(_bind("bn_coop_ctas")(mode, is_bf16, int(relu), vec, idx,
                                        ctypes.byref(n)), "bn_coop")
        if n.value < 1:
            raise RuntimeError("bn_coop kernel: no CTA fits on an SM")
        _ctas[key] = n.value
    return _ctas[key]


def _sync(device, stream: int):
    """The barrier counters of ``bn_coop`` for calls on ``stream``: zeroed
    once, and left at zero by every launch."""
    key = (device.index, stream)
    with _count_lock:
        if key not in _syncs:
            _syncs[key] = torch.zeros(2, dtype=torch.int32, device=device)
        return _syncs[key]


def _coop(kernel, mode, mats, vecs=(None,) * 4, eps=0.0, relu=False):
    """Launch ``bn_coop`` in ``mode`` on ``mats`` ((x,) or (dy, x)) and the
    (mean, inv, gamma, beta) it takes; returns (out0, out1, y or dx or
    None)."""
    x2d = mats[-1]
    rows, c = x2d.shape
    dev, is_bf16 = x2d.device, _DTYPES[x2d.dtype]
    relu = bool(relu) and mode in (_FWD, _BWD_FUSED)
    vec = _vec(c, mats)
    p = _plan(mode, rows, c, vec, _coop_ctas(dev, mode, is_bf16, relu, vec),
              _tuned_slab(mode, x2d, vec, relu))
    f32 = dict(dtype=torch.float32, device=dev)
    out0, out1 = torch.empty(c, **f32), torch.empty(c, **f32)
    part = torch.empty((2, p.slabs, c), **f32)
    out = torch.empty_like(x2d) if mode in (_FWD, _BWD_FUSED) else None
    index, stream = _stream(x2d)
    rc = _bind("bn_coop")(
        mode, is_bf16, int(relu), vec, p.tx, p.grid, p.slabs, p.slab,
        mats[0].data_ptr(), _ptr(mats[1] if len(mats) > 1 else None),
        *(_ptr(v) for v in vecs), part.data_ptr(),
        _sync(dev, stream).data_ptr(), out0.data_ptr(), out1.data_ptr(),
        _ptr(out), rows, c, float(eps), index, stream)
    _raise_on(rc, kernel)
    return out0, out1, out


_MODE_NAMES = ("stats", "fwd", "bwd_stats", "bwd_fused")


def _site(kernel, mode, mats, relu=False):
    """A lint trace's stand-in for :func:`_coop`: record the launch (its
    untuned plan on an H100, the vector width its alignment would allow
    at this C) and return empty (out0, out1, y or dx or None)."""
    x2d = mats[-1]
    rows, c = x2d.shape
    vec = 16 // x2d.element_size()
    while vec > 1 and c % vec:
        vec //= 2
    relu = bool(relu) and mode in (_FWD, _BWD_FUSED)
    smem = _SLOTS[mode] * (2 if mode >= _BWD_STATS else 1) * 16 * _NTHREADS
    ctas = _sites.resident_ctas(smem + _RED_BYTES, _NTHREADS)
    p = _plan(mode, rows, c, vec, ctas)
    _sites.record(_sites.KernelSite(
        kernel, tuple(tuple(m.shape) for m in mats),
        str(x2d.dtype).replace("torch.", ""),
        {"kernel": "bn_coop_kernel", "mode": _MODE_NAMES[mode], "vec": vec,
         "relu": relu, "ctas": ctas, "grid": p.grid, "blocks": p.blocks,
         "slabs": p.slabs, "slab": p.slab, "once": p.once,
         "smem_bytes": smem + _RED_BYTES}))
    f32 = dict(dtype=torch.float32, device=x2d.device)
    out = torch.empty_like(x2d) if mode in (_FWD, _BWD_FUSED) else None
    return torch.empty(c, **f32), torch.empty(c, **f32), out


def _same_dtype(kernel, dy2d, x2d):
    if dy2d.dtype != x2d.dtype:
        raise ValueError(f"{kernel} kernel: dy {dy2d.dtype} and x "
                         f"{x2d.dtype} must share a dtype")


def bn_stats(x2d):
    """(Σx, Σx²) per channel of a (rows, C) array in f32: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_dtypes("bn_stats", x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_stats_reference(x2d)
    if type(x2d) is not torch.Tensor and _sites.traced(x2d):
        return _site("bn_stats", _STATS, (x2d,))[:2]
    _check_cuda("bn_stats", {"x2d": x2d})
    s, sq, _ = _coop("bn_stats", _STATS, (x2d,))
    _count(bn_stats)
    return s, sq


def bn_bwd_stats(dy2d, x2d, mean, inv):
    """(Σdy, Σ(dy·x̂)) per channel, x̂ = (x − mean)·inv: dy and x f32 or
    bf16 (one dtype on the card), mean and inv f32 (C,)."""
    _check_dtypes("bn_bwd_stats", dy2d=dy2d, x2d=x2d, mean=mean, inv=inv)
    if x2d.device.type == "cpu":
        return bn_bwd_stats_reference(dy2d, x2d, mean, inv)
    _same_dtype("bn_bwd_stats", dy2d, x2d)
    if type(x2d) is not torch.Tensor and _sites.traced(x2d):
        return _site("bn_bwd_stats", _BWD_STATS, (dy2d, x2d))[:2]
    _check_cuda("bn_bwd_stats", {"dy2d": dy2d, "x2d": x2d},
                {"mean": mean, "inv": inv})
    sdy, sdyx, _ = _coop("bn_bwd_stats", _BWD_STATS, (dy2d, x2d),
                         (mean, inv, None, None))
    _count(bn_bwd_stats)
    return sdy, sdyx


def bn_fwd_apply(x2d, gamma, beta, eps: float, relu: bool = False):
    """Training-mode BN(+ReLU) forward of a (rows, C) array: ``(y, mean,
    var)``, y in x's dtype, the batch mean and biased var in f32."""
    _check_dtypes("bn_fwd_apply", x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_fwd_apply_reference(x2d, gamma, beta, eps, relu)
    if type(x2d) is not torch.Tensor and _sites.traced(x2d):
        mean, var, y = _site("bn_fwd_apply", _FWD, (x2d,), relu)
        return y, mean, var
    _check_cuda("bn_fwd_apply", {"x2d": x2d}, {"gamma": gamma, "beta": beta})
    mean, var, y = _coop("bn_fwd_apply", _FWD, (x2d,),
                         (None, None, gamma, beta), eps, relu)
    _count(bn_fwd_apply)
    return y, mean, var


def bn_bwd_fused(dy2d, x2d, mean, inv, gamma, beta, relu: bool = False):
    """The whole BN(+ReLU) backward: ``(dx, Σdy, Σ(dy·x̂))`` (the sums are
    dβ and dγ), dx in x's dtype."""
    _check_dtypes("bn_bwd_fused", dy2d=dy2d, x2d=x2d)
    if x2d.device.type == "cpu":
        return bn_bwd_fused_reference(dy2d, x2d, mean, inv, gamma, beta,
                                      relu)
    _same_dtype("bn_bwd_fused", dy2d, x2d)
    if type(x2d) is not torch.Tensor and _sites.traced(x2d):
        sdy, sdyx, dx = _site("bn_bwd_fused", _BWD_FUSED, (dy2d, x2d), relu)
        return dx, sdy, sdyx
    vecs = (mean, inv, gamma, beta)
    _check_cuda("bn_bwd_fused", {"dy2d": dy2d, "x2d": x2d},
                dict(zip(_VECS, vecs)))
    sdy, sdyx, dx = _coop("bn_bwd_fused", _BWD_FUSED, (dy2d, x2d), vecs,
                          relu=relu)
    _count(bn_bwd_fused)
    return dx, sdy, sdyx


for _w in (bn_stats, bn_bwd_stats, bn_fwd_apply, bn_bwd_fused):
    _w.launches = 0  # wrapper calls that launched in this process


# ------------------------------------------------------ autograd Functions
class _FusedBNTrain(torch.autograd.Function):
    """``fused_bn_train``'s custom VJP: stats by :func:`bn_stats`, the
    apply in PyTorch; backward sums by :func:`bn_bwd_stats` from x, mean
    and inv, dx in PyTorch over an f32 x̂. dγ = Σ(dy·x̂), dβ = Σdy."""

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
        x2 = x.reshape(-1, c).contiguous()
        rows = x2.shape[0]
        dy2 = dy.reshape(-1, c).contiguous()
        sdy, sdyx = bn_bwd_stats(dy2, x2, mean, inv)
        xhat2 = (x2.float() - mean) * inv
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


class _SyncBNTrain(torch.autograd.Function):
    """``sync_bn_train``'s custom VJP: the stats kernels' sums all-reduced
    over the data axis between the reductions and the elementwise work.
    Forward: :func:`bn_stats` gives this rank's Σx and Σx², one all-reduce
    of the stacked (2, C) f32 sums the global ones, then the apply in
    PyTorch over the global row count. Backward: :func:`bn_bwd_stats`
    gives this rank's Σdy and Σ(dy·x̂), one all-reduce the global ones for
    dx; dγ and dβ are this rank's sums, which the gradient average over
    the ranks completes."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, group, ranks: int):
        import torch.distributed as dist

        c = x.shape[-1]
        x2 = x.reshape(-1, c).contiguous()
        sums = torch.stack(bn_stats(x2))
        dist.all_reduce(sums, group=group)
        n = x2.shape[0] * ranks
        mean = sums[0] / n
        var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        scale = inv * gamma
        y = (x.float() * scale + (beta - mean * scale)).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, d_mean, d_var):
        import torch.distributed as dist

        del d_mean, d_var
        x, mean, inv, gamma = ctx.saved_tensors
        c = x.shape[-1]
        x2 = x.reshape(-1, c).contiguous()
        dy2 = dy.reshape(-1, c).contiguous()
        sdy, sdyx = bn_bwd_stats(dy2, x2, mean, inv)
        sums = torch.stack([sdy, sdyx])
        dist.all_reduce(sums, group=ctx.group)
        n = ctx.n
        xhat2 = (x2.float() - mean) * inv
        dx = ((dy2.float() - sums[0] / n - xhat2 * (sums[1] / n))
              * (gamma * inv)).to(x.dtype)
        return dx.reshape(x.shape), sdyx, sdy, None, None, None


def sync_bn_train(x, gamma, beta, eps: float, group, ranks: int):
    """Training-mode BN over the last axis normalised by the statistics of
    the global batch that ``ranks`` ranks of ``group`` hold parts of,
    through the stats kernels (:class:`_SyncBNTrain`); returns (y, mean,
    var) of the global batch, as :func:`fused_bn_train`."""
    return _SyncBNTrain.apply(x, gamma, beta, eps, group, int(ranks))


def fused_bn_train(x, gamma, beta, eps: float):
    """Training-mode BN over the last axis with the stats kernels. x:
    (..., C); returns (y, mean, var), mean and var the batch stats the
    caller folds into its running estimates (no gradient)."""
    return _FusedBNTrain.apply(x, gamma, beta, eps)


def fused_bn_apply_train(x, gamma, beta, eps: float, relu: bool = False):
    """Training-mode BN(+ReLU) over the last axis with both directions in
    the fused kernels; returns (y, mean, var) as :func:`fused_bn_train`."""
    return _FusedBNApplyTrain.apply(x, gamma, beta, eps, bool(relu))
