"""Flash attention: CUDA kernels for Hopper, their plain twins, and the
custom gradient around them.

Counterpart of ``bigdl_tpu/ops/attention_kernel.py``. Its three Pallas
kernels become ``csrc/flash_fwd.cu`` (``_fwd_kernel``) and
``csrc/flash_bwd.cu`` (``_dq_kernel``, ``_dkv_kernel``). This module holds
their wrappers (:func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv`,
with :func:`flash_bwd` running the pair), the plain PyTorch version of
each (:func:`flash_attention_reference`, :func:`flash_dq_reference`,
:func:`flash_dkv_reference`, :func:`flash_bwd_reference`), the
``torch.autograd.Function`` that ties forward and backward together (the
JAX package's ``custom_vjp``), the routing (:func:`flash_attention`), the
serving prompt-length ladder, and :func:`blockwise_attention`: the JAX
package's O(seq)-memory attention in plain PyTorch (a loop over K/V
blocks with an online softmax, each block checkpointed), which takes the
key-padding masks the kernels do not.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The JAX package's ``_LSE_LANES``
replication and the ``_tileable`` fallbacks are Mosaic artefacts and are
not ported: the CUDA kernels mask ragged edges themselves.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.nn import attention as _dense
from bigdl_tpu_torch.utils import flops as _flops

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_dq",
           "flash_dkv", "flash_attention_reference", "flash_bwd_reference",
           "flash_dq_reference", "flash_dkv_reference",
           "blockwise_attention", "online_softmax_update", "flash_block_k",
           "serving_prefill_buckets", "live_tile_pairs", "SUPPORTED_HEAD_DIMS",
           "TILE"]

_NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
TILE = 64  # the kernels' query and key tile (BQ = BK in flash_common.cuh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_fns: dict = {}  # the C entry points, bound at first launch


def live_tile_pairs(sq: int, sk: int, bq: int, bk: int, causal: bool,
                    q_offset: int) -> int:
    """(query tile, key tile) pairs whose products run per (batch, head):
    fully-future key tiles are skipped under ``causal``. Same count as
    the JAX package's ``_live_block_pairs``, with ragged edges rounded up
    to whole tiles as the CUDA kernels run them."""
    n_q, n_k = -(-sq // bq), -(-sk // bk)
    if not causal:
        return n_q * n_k
    total = 0
    for j in range(n_q):
        q_end = q_offset + min((j + 1) * bq, sq) - 1
        total += min(n_k, max(0, q_end // bk + 1))
    return total


def serving_prefill_buckets(max_len: int) -> tuple:
    """Prompt-length buckets for the serving prefill: the power-of-two
    ladder from 16 up to, and always including, ``max_len``.
    The JAX package drops rungs its Pallas block plan would pad; the CUDA
    kernel masks ragged edges itself, so every rung stays."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    ladder = []
    b = 16
    while b < max_len:
        ladder.append(b)
        b *= 2
    ladder.append(int(max_len))
    return tuple(sorted(set(ladder)))


# ------------------------------------------------------------ plain twins
def _valid(s_q: int, s_k: int, causal: bool, segments, device):
    """(…, s_q, s_k) bool mask of the kernels, or None: the bottom-right
    causal triangle and, with (b, s) ``segments``, equal ids (so id-0
    padding rows see id-0 keys, as in the JAX kernels' ``_block_valid``)."""
    valid = None
    if causal:
        rows = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
        valid = rows >= torch.arange(s_k, device=device)[None, :]
    if segments is not None:
        seg = segments[:, None, :, None] == segments[:, None, None, :]
        valid = seg if valid is None else valid & seg
    return valid


def flash_attention_reference(q, k, v, causal: bool, segments=None):
    """Plain PyTorch version of the forward kernel: (b, h, s_q, d) q and
    (b, h, s_k, d) k, v -> (o, lse), o in q's dtype, lse f32 (b*h, s_q).
    Products in f32 from the inputs' values, the kernels' mask, P rounded
    to V's dtype before P@V, rows without a live key give 0."""
    s_q, s_k, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(s_q, s_k, causal, segments, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse.reshape(-1, s_q)


def _bwd_probs(q, k, v, do, lse, delta, causal, segments):
    """P and dS (f32, (b, h, s_q, s_k)) of the backward kernels: P =
    exp(S - lse) *selected* to 0 where masked (a row with no live key has
    lse = -1e30, so exp overflows to inf there; a 0/1 product would give
    NaN), dS = P (dP - delta) scale."""
    b, h, s_q, d = q.shape
    s_k = k.shape[-2]
    scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(b, h, s_q, 1))
    valid = _valid(s_q, s_k, causal, segments, q.device)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), device=p.device))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, s_q, 1)) * scale
    return p, ds


def _delta(o, do):
    """delta = rowsum(dO * O) in f32, (b*h, s_q): what the JAX package
    computes in plain XLA beside its backward kernels."""
    return (do.float() * o.float()).sum(dim=-1).reshape(-1, o.shape[-2])


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool,
                       segments=None):
    """Plain version of the dQ kernel: dQ = dS K, dS rounded to K's dtype
    first, the f32 sum cast to q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, segments)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                        segments=None):
    """Plain version of the dK/dV kernel: dV = P^T dO (P rounded to dO's
    dtype first), dK = dS^T Q (dS rounded to Q's dtype first)."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, segments)
    return _dkv_from(q, do, p, ds, k.dtype, v.dtype)


def _dkv_from(q, do, p, ds, k_dtype, v_dtype):
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k_dtype), dv.to(v_dtype)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool, segments=None):
    """Plain version of the backward pair: (dq, dk, dv) from the forward's
    o and lse and the output cotangent ``do``, with the roundings of the
    JAX package's ``_flash_bwd``."""
    delta = _delta(o, do)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, segments)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    return (dq,) + _dkv_from(q, do, p, ds, k.dtype, v.dtype)


# -------------------------------------------------------------- wrappers
def _bind(name: str):
    fn = _fns.get(name)
    if fn is None:
        from bigdl_tpu_torch.ops import _build
        lib = _build.load("flash_fwd" if name == "flash_fwd" else "flash_bwd")
        fn = getattr(lib, name)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        if name == "flash_fwd":
            fn.argtypes = [ptr] * 6 + [i32] * 7 + [f32] + [i64] * 12 + [i32,
                                                                         ptr]
        else:  # flash_dq: 8 pointers; flash_dkv: 9
            n_ptr = 8 if name == "flash_dq" else 9
            fn.argtypes = ([ptr] * n_ptr + [i32] * 7 + [f32, ptr, ptr, i32,
                                                         ptr])
        fn.restype = i32
        _fns[name] = fn
    return fn


def _check_operands(kernel: str, q, k, v, extra=()):
    """Raise on anything the kernels do not take: device, dtype, shape,
    head dim, strides (last dim contiguous, the rest divisible by the
    16-byte vector, 16-byte aligned start). ``extra``: more (name, tensor)
    pairs shaped like q."""
    tensors = (("q", q), ("k", k), ("v", v)) + tuple(extra)
    if not all(t.is_cuda and t.device == q.device for _, t in tensors):
        raise ValueError(f"{kernel} kernel: operands must be on one CUDA "
                         f"device, got {[str(t.device) for _, t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for _, t in tensors):
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16 "
                         f"operands of one dtype, got "
                         f"{[t.dtype for _, t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{kernel} kernel: q (b, h, s_q, d) and k, v "
                         f"(b, h, s_k, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_q, d = q.shape
    if k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"{kernel} kernel: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{kernel} kernel: {name} {tuple(t.shape)} "
                             f"does not match q {tuple(q.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if s_q < 1 or k.shape[2] < 1 or b * h > 65535:
        raise ValueError(f"{kernel} kernel: s_q {s_q}, s_k {k.shape[2]} "
                         f"must be >= 1 and batch*heads {b * h} <= 65535")
    vec = 16 // q.element_size()  # the kernels load 16 bytes a thread
    for name, t in tensors:
        st = t.stride()
        if st[3] != 1 or any(x % vec for x in st[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{kernel} kernel: {name} needs a contiguous last dim, "
                f"strides divisible by {vec} and a 16-byte aligned start, "
                f"got strides {st}")


def _check_rows(kernel: str, q, rows: dict):
    """Per-row f32 (b*h, s_q) vectors (lse, delta), contiguous."""
    b, h, s_q, _ = q.shape
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, s_q)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{kernel} kernel: {name} must be contiguous "
                             f"float32 ({b * h}, {s_q}) on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _segment_ids(kernel: str, q, k, segments):
    """(b, s) int32 contiguous segment ids for the kernel, or None."""
    if segments is None:
        return None
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"{kernel} kernel: segments need s_q == s_k, got "
                         f"{q.shape[2]} and {k.shape[2]}")
    if tuple(segments.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(f"{kernel} kernel: segments must be (batch, seq) "
                         f"= {(q.shape[0], q.shape[2])}, got "
                         f"{tuple(segments.shape)}")
    return segments.to(device=q.device, dtype=torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _flash_fwd_cuda(q, k, v, causal: bool, segments=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors; raises on anything
    the kernel does not take."""
    _check_operands("flash_fwd", q, k, v)
    seg = _segment_ids("flash_fwd", q, k, segments)
    b, h, s_q, d = q.shape
    o = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    rc = _bind("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), o.data_ptr(),
        lse.data_ptr(), b, h, s_q, k.shape[2], d, _DTYPES[q.dtype],
        int(causal), 1.0 / (d ** 0.5), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_fwd")
    _count(flash_fwd)
    return o, lse


def flash_fwd(q, k, v, causal: bool, segments=None):
    """(o, lse) of flash attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, segments)
    return _flash_fwd_cuda(q, k, v, causal, segments)


def _strides(*ts):
    st = [x for t in ts for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(st))(*st)


def _launch_bwd(name, q, k, v, do, lse, delta, causal, segments, outs):
    _check_operands(name, q, k, v, extra=(("do", do),))
    _check_rows(name, q, {"lse": lse, "delta": delta})
    seg = _segment_ids(name, q, k, segments)
    b, h, s_q, d = q.shape
    rc = _bind(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg),
        *(t.data_ptr() for t in outs), b, h, s_q, k.shape[2], d,
        _DTYPES[q.dtype], int(causal), 1.0 / (d ** 0.5),
        _strides(q, k, v, do), _strides(*outs), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, name)


def flash_dq(q, k, v, do, lse, delta, causal: bool, segments=None):
    """dQ of flash attention from the forward's lse and delta =
    rowsum(dO * O): ``csrc/flash_bwd.cu`` for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal, segments)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_dq", q, k, v, do, lse, delta, causal, segments, (dq,))
    _count(flash_dq)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool, segments=None):
    """(dK, dV) of flash attention: ``csrc/flash_bwd.cu`` for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, segments)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_dkv", q, k, v, do, lse, delta, causal, segments,
                (dk, dv))
    _count(flash_dkv)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool, segments=None):
    """(dq, dk, dv) of flash attention: delta in plain PyTorch, then the
    dQ and dK/dV kernels (their plain versions for CPU tensors)."""
    delta = _delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal, segments)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, segments)
    return dq, dk, dv


for _w in (flash_fwd, flash_dq, flash_dkv):
    _w.launches = 0  # kernel launches in this process (reset freely)


def _kernel_layout(t):
    """``t`` itself when its strides suit the kernels, else a contiguous
    copy: an output cotangent may arrive as an expanded or oddly strided
    view (a ``sum()`` loss gives stride 0)."""
    vec = 16 // t.element_size()
    st = t.stride()
    if st[3] == 1 and not any(x % vec for x in st[:3]) and \
            t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


class FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash``/``_flash_seg`` custom VJP: the forward
    saves q, k, v, o and lse; the backward computes delta and runs
    :func:`flash_bwd`. On CPU tensors both halves run the plain twins,
    as the JAX ``custom_vjp`` runs its kernels in interpret mode."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, segments=None):
        with _flops.declared(_declared_flops, q, k, causal, 0):
            o, lse = flash_fwd(q, k, v, causal, segments)
        ctx.save_for_backward(q, k, v, o, lse, segments)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segments = ctx.saved_tensors
        if do.is_cuda:
            do = _kernel_layout(do)
        with _flops.declared(_declared_flops, q, k, ctx.causal, 1):
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                   segments)
        return dq, dk, dv, None, None


def _declared_flops(q, k, causal: bool, which: int) -> float:
    """The algorithmic forward (``which`` 0) or backward (1) FLOPs of one
    call, as the JAX kernels declare them (:func:`~bigdl_tpu_torch.utils.
    flops.flash_flops`): the analytic count's view of the kernels."""
    b, h, s_q, d = q.shape
    return _flops.flash_flops(b, h, s_q, k.shape[-2], d, causal)[which]


# ------------------------------------------------------- blockwise path
def online_softmax_update(q, kb, vb, m, l, acc, scale, valid=None):
    """One block step of the streaming softmax: fold the K/V block (kb,
    vb) into the running (max m, normaliser l, accumulator acc) of the
    queries q. ``valid`` is an optional bool mask broadcastable to (...,
    s_q, bk). m, l and acc are f32; the products take the operands'
    values in f32 (a bf16 product accumulated in f32), and P is rounded
    to V's dtype before P @ V, as in the JAX package."""
    logits = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    if valid is not None:
        logits = logits.masked_fill(~valid, _NEG_INF)
    new_m = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - new_m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    corr = torch.exp(m - new_m)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p.to(vb.dtype).float(), vb.float())
    return new_m, l, acc


def _as_key_padding(mask, b: int, s_k: int):
    """A (b, s_k) bool key-padding mask from a (b, s_k) or (b|1, 1, 1,
    s_k) one; None for anything richer."""
    if mask is None:
        return None
    if mask.dim() == 2 and tuple(mask.shape) == (b, s_k):
        return mask
    if (mask.dim() == 4 and mask.shape[-1] == s_k and mask.shape[1] == 1
            and mask.shape[2] == 1 and mask.shape[0] in (1, b)):
        return mask[:, 0, 0, :].expand(b, s_k)
    return None


def _block_update(q, kj, vj, m, l, acc, j: int, bk: int, causal: bool,
                  q_pos, keys, seg_q, scale):
    """Block ``j``'s online-softmax step with its validity tile (the
    bottom-right causal triangle, this block's key-padding slice ``keys``
    (b, bk), or the segment equality of ``seg_q`` against this block's
    ids ``keys``), built here so a recompute rebuilds it."""
    valid = None
    if causal:
        k_pos = j * bk + torch.arange(bk, device=q.device)
        valid = q_pos[:, None] >= k_pos[None, :]
    if keys is not None:
        mj = (keys[:, None, None, :] if seg_q is None else
              seg_q[:, None, :, None] == keys[:, None, None, :])
        valid = mj if valid is None else valid & mj
    return online_softmax_update(q, kj, vj, m, l, acc, scale, valid)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        mask: Optional[torch.Tensor] = None,
                        segments: Optional[torch.Tensor] = None,
                        block_k: int = 128):
    """O(seq)-memory attention in plain PyTorch, the JAX package's
    ``blockwise_attention``: a loop over K/V blocks of ``block_k`` keys
    with an online softmax, each block's update under a non-reentrant
    ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` on the scan
    body), so the backward recomputes each block's (s_q, block_k) scores
    instead of keeping them. q, k, v: (b, h, s, d).

    Key-padding masks ((b, s_k), or (b|1, 1, 1, s_k), bool, True =
    attend) and packed-row ``segments`` ((b, s) int ids, self-attention
    shapes only; id-0 rows come out as 0) tile along the loop; a richer
    mask, or ``s_k`` not a multiple of the block, takes the dense path.
    The causal mask is bottom-right aligned (decode-style s_q < s_k)."""
    s_k, s_q = k.shape[-2], q.shape[-2]
    bk = min(block_k, s_k)
    if segments is not None and mask is not None:
        raise ValueError("segments and mask are mutually exclusive")
    if segments is not None and s_q != s_k:
        raise ValueError(f"segments requires self-attention shapes "
                         f"(s_q={s_q} != s_k={s_k})")
    kv_mask = _as_key_padding(mask, q.shape[0], s_k)
    if (mask is not None and kv_mask is None) or s_k % bk:
        if segments is not None:
            mask = _dense.make_segment_mask(segments)
        return _dense.dot_product_attention(q, k, v, causal=causal,
                                            mask=mask)
    from torch.utils.checkpoint import checkpoint

    scale = 1.0 / (q.shape[-1] ** 0.5)
    q_pos = (s_k - s_q) + torch.arange(s_q, device=q.device)
    seg_q = None if segments is None else segments.to(torch.int32)
    keys_all = kv_mask if kv_mask is not None else seg_q
    m = torch.full(q.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for j in range(s_k // bk):
        blk = slice(j * bk, (j + 1) * bk)
        keys = None if keys_all is None else keys_all[:, blk]
        args = (q, k[..., blk, :], v[..., blk, :], m, l, acc, j, bk,
                causal, q_pos, keys, seg_q, scale)
        if remat:
            # nothing here draws noise: no RNG state is saved (reading it
            # breaks a CUDA graph capture)
            m, l, acc = checkpoint(_block_update, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = _block_update(*args)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    if segments is not None:
        # id-0 rows stayed live in the loop (a finite backward); zero them
        # so this path agrees with the dense fallback
        out = torch.where((segments != 0)[:, None, :, None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def flash_block_k(s_k: int) -> int:
    """The key block :func:`flash_attention` hands
    :func:`blockwise_attention`: the JAX package's untuned rule (512
    clamped to ``s_k``: the largest of 512/256/128 that divides it, the
    whole of a shorter ``s_k``, else 512, which then takes the dense
    path). The JAX package asks its autotuner first; the port has none
    yet."""
    return _flops.clamp_block(_flops.DEFAULT_BLOCK, s_k)


def flash_attention(q, k, v, *, causal: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    segments: Optional[torch.Tensor] = None):
    """(b, h, s, d) attention with the routing of the JAX package's
    ``flash_attention``:

    * ``segments`` ((b, s) int document ids of packed rows, 0 = padding)
      go into the kernels, and rows of id 0 come out as 0 (inside the
      kernels they attend id-0 keys, which keeps their softmax live and
      the backward finite). With s_q != s_k they take the dense path
      through :func:`~bigdl_tpu_torch.nn.attention.make_segment_mask`.
    * no mask goes to the kernels;
    * a key-padding mask ((b, s_k) or (b|1, 1, 1, s_k) bool) goes to
      :func:`blockwise_attention` with the key block of
      :func:`flash_block_k`; richer masks take the plain dense path (the
      JAX package keeps both outside its kernels)."""
    if segments is not None:
        if mask is not None:
            raise ValueError("segments and mask are mutually exclusive")
        if q.shape[-2] != k.shape[-2]:
            return _dense.dot_product_attention(
                q, k, v, causal=causal,
                mask=_dense.make_segment_mask(segments))
        out = FlashAttention.apply(q, k, v, causal, segments)
        live = (segments != 0)[:, None, :, None]
        return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    if mask is not None:
        if _as_key_padding(mask, q.shape[0], k.shape[-2]) is not None:
            return blockwise_attention(q, k, v, causal=causal, mask=mask,
                                       block_k=flash_block_k(k.shape[-2]))
        return _dense.dot_product_attention(q, k, v, causal=causal,
                                            mask=mask)
    return FlashAttention.apply(q, k, v, causal, None)
