"""Attention and transformer layers (counterpart of
``bigdl_tpu/nn/attention.py``).

Shapes follow the JAX package: activations (batch, seq, d_model),
attention operands (batch, heads, seq, head_dim), weights (in, out) so a
projection is ``x @ w``. Parameters stay f32; each matmul casts its
weight to the activation dtype, as the JAX layers do. KV caches are
updated in place (the JAX package returns new arrays), which saves a
copy of the cache per layer and step.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import xavier_uniform
from bigdl_tpu_torch.nn.structural import Dropout, fold_seed

__all__ = ["dot_product_attention", "make_segment_mask", "LayerNorm",
           "rope_tables", "apply_rope", "MultiHeadAttention",
           "PositionalEncoding", "TransformerEncoderLayer",
           "TransformerEncoder"]

_NEG_INF = -1e30  # finite mask value, as in the JAX package


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None):
    """Dense scaled dot-product attention over (..., seq, head_dim).
    Scores and softmax in f32, the causal mask bottom-right aligned
    (query i of s_q sees keys <= s_k - s_q + i), fully masked rows give 0,
    weights cast to q's dtype before the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = None
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(q_len, device=q.device)[:, None] + (k_len - q_len)
        valid = rows >= torch.arange(k_len, device=q.device)[None, :]
    if mask is not None:
        valid = mask if valid is None else valid & mask
    if valid is not None:
        logits = logits.masked_fill(~valid, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    if valid is not None:
        weights = weights.masked_fill(~valid, 0.0)
    return torch.matmul(weights.to(q.dtype), v)


def make_segment_mask(segments_q, segments_k=None):
    """Block-diagonal mask of packed rows: (b, s) int document ids, equal
    id = same document, id 0 = padding that attends to nothing. Returns a
    (b, 1, s_q, s_k) bool mask (True = attend) for the dense path."""
    if segments_k is None:
        segments_k = segments_q
    same = segments_q[:, :, None] == segments_k[:, None, :]
    live = (segments_q != 0)[:, :, None] & (segments_k != 0)[:, None, :]
    return (same & live)[:, None, :, :]


class LayerNorm(nn.Module):
    """Layer norm over the last dim: statistics and affine in f32 (biased
    variance), the result cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def rope_tables(max_len: int, dim: int, base: float = 10000.0):
    """cos/sin tables (max_len, dim/2), f32 numpy, for NeoX-style RoPE:
    dims [0:dim/2] rotate with [dim/2:dim]."""
    inv = 1.0 / (base ** (np.arange(0, dim, 2).astype(np.float32) / dim))
    ang = np.arange(max_len).astype(np.float32)[:, None] * inv[None, :]
    return np.cos(ang), np.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate (..., s, d) by tables broadcastable to (..., s, d/2); the
    tables are cast to x's dtype before the products."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def seq_offset(attn_fn, s_local: int) -> int:
    """The global position of this rank's first token when the attention
    is sequence-parallel (``parallel.sequence.RingAttention``'s
    ``position_offset``), else 0."""
    at = getattr(attn_fn, "position_offset", None)
    return 0 if at is None else int(at(s_local))


def _positions(pos, n: int, device) -> torch.Tensor:
    """(b, n) absolute positions from a per-row start tensor (b,)."""
    return pos.to(device).long()[:, None] + torch.arange(n, device=device)


class MultiHeadAttention(nn.Module):
    """Multi-head self- or cross-attention with grouped-query K/V
    (``num_kv_heads``) and optional RoPE. ``attn_impl``: None for
    :func:`dot_product_attention`, ``"flash"`` for the flash kernel
    (``bigdl_tpu_torch.ops.flash_attention``), ``"blockwise"`` for
    ``bigdl_tpu_torch.ops.blockwise_attention`` (O(seq) memory, plain
    PyTorch), or a callable with the same signature (one with a
    ``position_offset``, the sequence-parallel ring, puts RoPE at its
    rank's global positions). Integer masks are packed-row segment ids:
    they go to ``attn_fn`` as ``segments=`` when it takes them, and as the
    block-diagonal :func:`make_segment_mask` otherwise.

    Under tensor parallelism (``parallel.TensorParallel``) ``_tp`` splits
    the heads: ``num_heads`` (and ``num_kv_heads`` when the axis divides
    them) are this rank's, wq/wk/wv hold its columns and wo its rows, the
    input is copied to the model axis and the output projection reduced
    over it. KV projections that stay whole (the axis does not divide the
    KV heads) read the input uncopied, and each rank takes the KV heads
    its query heads need."""

    _tp = None

    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 attn_impl: Optional[Union[str, Callable]] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 rope_max_len: int = 8192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.d_model, self.num_heads = d_model, num_heads
        self.head_dim = d_model // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {self.num_kv_heads}")
        self.causal, self.rope = causal, rope
        if rope:
            if self.head_dim % 2:
                raise ValueError("RoPE needs an even head_dim")
            cos, sin = rope_tables(rope_max_len, self.head_dim)
            self.register_buffer("rope_cos", torch.from_numpy(cos),
                                 persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin),
                                 persistent=False)
        if attn_impl == "flash":
            from bigdl_tpu_torch.ops import flash_attention
            attn_impl = flash_attention
        elif attn_impl == "blockwise":
            from bigdl_tpu_torch.ops import blockwise_attention
            attn_impl = blockwise_attention
        self.set_attn_fn(attn_impl or dot_product_attention)
        d, dkv = d_model, self.num_kv_heads * self.head_dim
        g = generator
        self.wq = nn.Parameter(xavier_uniform((d, d), d, d, g))
        self.wk = nn.Parameter(xavier_uniform((d, dkv), d, dkv, g))
        self.wv = nn.Parameter(xavier_uniform((d, dkv), d, dkv, g))
        self.wo = nn.Parameter(xavier_uniform((d, d), d, d, g))
        self.bq = nn.Parameter(torch.zeros(d))
        self.bk = nn.Parameter(torch.zeros(dkv))
        self.bv = nn.Parameter(torch.zeros(dkv))
        self.bo = nn.Parameter(torch.zeros(d))

    def set_attn_fn(self, fn: Callable) -> None:
        """Make ``fn`` the attention (an ``attn_impl``); the packed-row
        segment ids go to it as ``segments=`` when its signature takes
        them."""
        self.attn_fn = fn
        try:
            self._attn_takes_segments = "segments" in inspect.signature(
                fn).parameters
        except (TypeError, ValueError):
            self._attn_takes_segments = False

    def _split_heads(self, x, n_heads: int):
        b, s, f = x.shape
        return x.view(b, s, n_heads, f // n_heads).transpose(1, 2)

    @staticmethod
    def _merge_heads(x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _expand_kv(self, kv):
        """(b, n_kv, s, d) -> (b, num_heads, s, d): kv head j serves query
        heads j*g .. j*g+g-1 (``jnp.repeat`` on axis 1)."""
        tp = self._tp
        if tp is not None and not tp.kv_split:
            g = tp.heads // tp.kv_heads
            idx = torch.tensor([(tp.heads_lo + i) // g
                                for i in range(self.num_heads)],
                               device=kv.device)
            return tp.select(kv, 1, idx)
        g = self.num_heads // self.num_kv_heads
        return kv if g == 1 else torch.repeat_interleave(kv, g, dim=1)

    def _rope(self, x, pos):
        """Rotate (b, h, s, d) from absolute position ``pos``: an int, or
        a (b,) tensor of per-row starts."""
        s = x.shape[-2]
        if isinstance(pos, int):
            cos = self.rope_cos[pos:pos + s]
            sin = self.rope_sin[pos:pos + s]
        else:
            at = _positions(pos, s, x.device)
            cos, sin = self.rope_cos[at][:, None], self.rope_sin[at][:, None]
        return apply_rope(x, cos, sin)

    def _proj(self, x, w, b):
        dt = x.dtype
        return x @ w.to(dt) + b.to(dt)

    def _inputs(self, q_in, kv_in):
        """The q and kv projections' inputs: under tensor parallelism the
        input copied to the model axis (once for self-attention), whole KV
        projections reading it uncopied."""
        tp = self._tp
        if tp is None:
            return q_in, kv_in
        xq = tp.copy(q_in)
        if not tp.kv_split:
            return xq, kv_in
        return xq, (xq if kv_in is q_in else tp.copy(kv_in))

    def _qkv(self, x):
        xq, xkv = self._inputs(x, x)
        return (self._split_heads(self._proj(xq, self.wq, self.bq),
                                  self.num_heads),
                self._split_heads(self._proj(xkv, self.wk, self.bk),
                                  self.num_kv_heads),
                self._split_heads(self._proj(xkv, self.wv, self.bv),
                                  self.num_kv_heads))

    def _out(self, o):
        """The output projection of (b, h, s, d) heads: under tensor
        parallelism the rows of wo, reduced over the model axis, and the
        whole bias after the reduce."""
        m = self._merge_heads(o)
        tp = self._tp
        if tp is None:
            return self._proj(m, self.wo, self.bo)
        dt = m.dtype
        return tp.reduce(m @ self.wo.to(dt)) + self.bo.to(dt)

    def forward(self, x):
        """``x``: a (b, s, d) tensor (self-attention), ``(q_in, kv_in)``
        (cross), or ``(q_in, kv_in, mask)`` with a (b, s_k) key-padding
        bool mask, a broadcastable (b|1, h|1, s_q, s_k) one, or (b, s)
        integer segment ids of packed rows."""
        mask = segments = None
        if isinstance(x, (tuple, list)):
            q_in, kv_in = x[0], x[1]
            mask = x[2] if len(x) > 2 else None
        else:
            q_in = kv_in = x
        if mask is not None and mask.dtype != torch.bool:
            segments, mask = mask, None
            if not self._attn_takes_segments:
                mask, segments = make_segment_mask(segments), None
        rope_self = q_in is kv_in
        q_in, kv_in = self._inputs(q_in, kv_in)
        q = self._split_heads(self._proj(q_in, self.wq, self.bq),
                              self.num_heads)
        k = self._split_heads(self._proj(kv_in, self.wk, self.bk),
                              self.num_kv_heads)
        v = self._split_heads(self._proj(kv_in, self.wv, self.bv),
                              self.num_kv_heads)
        if self.rope:
            if not rope_self:
                raise ValueError("RoPE supports self-attention only")
            off = seq_offset(self.attn_fn, q.shape[-2])
            q, k = self._rope(q, off), self._rope(k, off)
        k, v = self._expand_kv(k), self._expand_kv(v)
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :]
        if segments is not None:
            o = self.attn_fn(q, k, v, causal=self.causal, segments=segments)
        else:
            o = self.attn_fn(q, k, v, causal=self.causal, mask=mask)
        return self._out(o)

    # ----------------------------------------------- autoregressive decode
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, x, cache):
        """Causal forward over the whole prompt that also writes K/V (the
        RoPE-rotated K) into ``cache`` at positions 0..s-1, in place."""
        q, k, v = self._qkv(x)
        if self.rope:
            q, k = self._rope(q, 0), self._rope(k, 0)
        o = self.attn_fn(q, self._expand_kv(k), self._expand_kv(v),
                         causal=True, mask=None)
        s = x.shape[1]
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
        return self._out(o)

    def decode_step(self, x, cache, pos):
        """x (b, m, d) at per-row start positions ``pos``: one token per
        row when m = 1 (:meth:`decode_chunk`)."""
        return self.decode_chunk(x, cache, pos)

    def decode_chunk(self, x, cache, pos):
        """x (b, m, d) at absolute positions pos..pos+m-1 (``pos``: (b,)
        tensor, one start per row). Writes the chunk's K/V into ``cache``
        first, then row i attends cache positions 0..pos+i over the whole
        cache length: f32 scores and softmax, P cast to q's dtype."""
        b, m, _ = x.shape
        q, k, v = self._qkv(x)
        at = _positions(pos, m, x.device)  # (b, m)
        if self.rope:
            cos, sin = self.rope_cos[at][:, None], self.rope_sin[at][:, None]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        rows = torch.arange(b, device=x.device)[:, None]
        kc, vc = cache["k"], cache["v"]
        kc[rows, :, at] = k.transpose(1, 2).to(kc.dtype)
        vc[rows, :, at] = v.transpose(1, 2).to(vc.dtype)
        ke, ve = self._expand_kv(kc), self._expand_kv(vc)
        s = torch.matmul(q.float(), ke.to(q.dtype).float().transpose(-1, -2))
        s = s / (self.head_dim ** 0.5)
        live = (torch.arange(kc.shape[2], device=x.device)[None, None, None]
                <= at[:, None, :, None])
        p = torch.softmax(s.masked_fill(~live, _NEG_INF), dim=-1)
        o = torch.matmul(p.to(q.dtype).float(),
                         ve.to(q.dtype).float()).to(x.dtype)
        return self._out(o)


class PositionalEncoding(nn.Module):
    """Sinusoidal positions added to (batch, seq, d_model); the f32 table
    covers ``max_len`` positions."""

    def __init__(self, d_model: int, max_len: int = 4096):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        pos = np.arange(max_len)[:, None].astype(np.float32)
        dim = np.arange(0, d_model, 2).astype(np.float32)
        angle = pos / np.power(10000.0, dim / d_model)
        pe = np.zeros((max_len, d_model), np.float32)
        pe[:, 0::2] = np.sin(angle)
        pe[:, 1::2] = np.cos(angle)[:, : d_model // 2]
        self.register_buffer("table", torch.from_numpy(pe), persistent=False)

    def forward(self, x, offset: int = 0):
        """``x`` + the positions ``offset`` .. ``offset + seq - 1`` (a
        sequence-parallel rank's chunk starts past 0)."""
        seq = x.shape[-2]
        if offset + seq > self.max_len:
            raise ValueError(f"sequence length {offset + seq} exceeds "
                             f"max_len {self.max_len}")
        return x + self.table[offset:offset + seq].to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)), tanh-GELU MLP, with
    inverted dropout on both branches at train time (``dropout`` > 0).

    ``forward`` takes x or ``(x, mask)`` (a key-padding mask or packed-row
    segment ids threaded through the stack) and returns the same form.
    Under tensor parallelism the attention splits its heads and ``_tp``
    splits the MLP pair (w1 by column, w2 by row, b2 added after the
    reduce).
    ``seed`` (an int or an int64 tensor) seeds this call's dropout: the
    same seed draws the same masks, so a recomputed (remat) layer repeats
    its dropout. The attention branch draws with ``fold_seed(seed, 0)``,
    the MLP branch with ``fold_seed(seed, 1)``."""

    def __init__(self, d_model: int, num_heads: int,
                 d_ff: Optional[int] = None, causal: bool = False,
                 dropout: float = 0.0, attn_impl=None,
                 num_kv_heads: Optional[int] = None,
                 rope: bool = False, rope_max_len: int = 8192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._tp = None
        d_ff = d_ff or 4 * d_model
        self.d_model, self.d_ff = d_model, d_ff
        self.drop = Dropout(dropout) if dropout > 0.0 else None
        self.ln1 = LayerNorm(d_model)
        self.mha = MultiHeadAttention(d_model, num_heads, causal=causal,
                                      attn_impl=attn_impl,
                                      num_kv_heads=num_kv_heads, rope=rope,
                                      rope_max_len=rope_max_len,
                                      generator=generator)
        self.ln2 = LayerNorm(d_model)
        self.w1 = nn.Parameter(xavier_uniform((d_model, d_ff), d_model, d_ff,
                                              generator))
        self.b1 = nn.Parameter(torch.zeros(d_ff))
        self.w2 = nn.Parameter(xavier_uniform((d_ff, d_model), d_ff, d_model,
                                              generator))
        self.b2 = nn.Parameter(torch.zeros(d_model))

    def _mlp_branch(self, x):
        dt = x.dtype
        h = self.ln2(x)
        tp = self._tp
        if tp is not None:
            h = tp.copy(h)
        h = F.gelu(h @ self.w1.to(dt) + self.b1.to(dt), approximate="tanh")
        y = h @ self.w2.to(dt)
        if tp is not None:
            y = tp.reduce(y)
        return y + self.b2.to(dt)

    def _mlp(self, x):
        return x + self._mlp_branch(x)

    def forward(self, x, seed=None):
        mask = None
        if isinstance(x, (tuple, list)):
            x, mask = x
        drop = self.drop is not None and self.training
        if drop and seed is None:
            raise ValueError("Dropout needs a seed in training mode: pass "
                             "seed= to the model's forward")
        h = self.ln1(x)
        h = self.mha(h if mask is None else (h, h, mask))
        if drop:
            h = self.drop(h, fold_seed(seed, 0))
        x = x + h
        h = self._mlp_branch(x)
        if drop:
            h = self.drop(h, fold_seed(seed, 1))
        y = x + h
        return y if mask is None else (y, mask)

    def prefill(self, x, cache):
        return self._mlp(x + self.mha.prefill(self.ln1(x), cache))

    def decode_step(self, x, cache, pos):
        return self._mlp(x + self.mha.decode_step(self.ln1(x), cache, pos))


def _save_weight_products():
    """Selective-checkpoint contexts of ``remat="dots"`` (the JAX
    package's ``dots_with_no_batch_dims_saveable``): the outputs of the
    weight projections (``aten.mm``/``aten.addmm``) are kept; everything
    else, the batched attention products and the flash forward included,
    is recomputed in the backward."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


class TransformerEncoder(nn.ModuleList):
    """Stack of encoder layers, children named "0", "1", ... as the JAX
    package's param keys. Caches are lists with one {"k", "v"} per layer.

    ``remat`` trades memory for recompute in training: False (none),
    True or ``"full"`` (``torch.utils.checkpoint`` per layer, non-reentrant:
    nothing inside a layer is kept), ``"dots"`` (the weight projections'
    outputs are kept, the rest recomputed). Layer i's dropout seed is
    :func:`~bigdl_tpu_torch.nn.structural.fold_seed` (seed, i), made inside
    the checkpointed call, so the recompute draws the same masks."""

    REMAT = ("full", "dots")

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 d_ff: Optional[int] = None, causal: bool = False,
                 dropout: float = 0.0, attn_impl=None, remat=False,
                 num_kv_heads: Optional[int] = None,
                 rope: bool = False, rope_max_len: int = 8192,
                 generator: Optional[torch.Generator] = None):
        super().__init__([
            TransformerEncoderLayer(d_model, num_heads, d_ff, causal,
                                    dropout, attn_impl,
                                    num_kv_heads=num_kv_heads,
                                    rope=rope, rope_max_len=rope_max_len,
                                    generator=generator)
            for _ in range(num_layers)])
        self.remat = remat

    @property
    def remat(self):
        return self._remat

    @remat.setter
    def remat(self, remat):
        if remat is True:
            remat = "full"
        if remat and remat not in self.REMAT:
            raise ValueError(f"remat must be False/True/'full'/'dots', "
                             f"got {remat!r}")
        self._remat = remat or False

    def forward(self, x, seed=None):
        from torch.utils.checkpoint import checkpoint
        drop = seed is not None and self.training and any(
            layer.drop is not None for layer in self)
        for i, layer in enumerate(self):
            s = fold_seed(seed, i) if drop else None
            if self.remat and torch.is_grad_enabled():
                kw = ({"context_fn": _save_weight_products}
                      if self.remat == "dots" else {})
                # the dropout masks come from s, not torch's generator, so
                # no RNG state is saved (reading it breaks a CUDA graph
                # capture)
                x = checkpoint(layer, x, s, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, s)
        return x

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> list:
        return [layer.mha.init_cache(batch, max_len, dtype, device)
                for layer in self]

    def prefill(self, x, cache):
        for layer, c in zip(self, cache):
            x = layer.prefill(x, c)
        return x

    def decode_step(self, x, cache, pos):
        for layer, c in zip(self, cache):
            x = layer.decode_step(x, c, pos)
        return x
