"""Paged KV cache for the continuous-batching decoder (counterpart of
``bigdl_tpu/serving/kv_pages.py``).

Each layer's K and V live in a pool of fixed-size pages of
``page_tokens`` tokens, and every slot owns the pages its token budget
needs, listed in its row of a page table. A short request then holds
only its pages instead of ``max_len`` positions.

* **Allocation is a host free list** (:class:`PageAllocator`). Page 0 is
  the null page: unused page-table entries point at it, and writes past a
  slot's reservation land in it. Its contents are garbage by design; the
  decode live mask never attends a position before it is written.
* **Admission is by reservation**: a slot reserves ``ceil((prompt +
  max_new) / page_tokens)`` pages up front, so a request that starts
  decoding can always finish; one that cannot reserve waits.
* **The device side is tensor functions** with the JAX package's
  semantics: :func:`gather_cache` rebuilds a slot's contiguous view,
  :func:`scatter_tokens` writes per-token K/V, :func:`scatter_pages`
  repacks a contiguous cache into pages, :func:`copy_pages` copies pages
  (the prefix cache's primitive). The port updates the pools in place
  (the JAX functions return new pools) and returns them.
  :func:`paged_verify_logits` runs a model's chunked decode over the
  pages, one layer's gathered view at a time.

**8-bit pools** (``kv8``, :class:`QuantPool`) hold int8 rows with one f32
scale a row: the write functions quantize (:func:`kv_quant_rows`), the
gathers dequantize into the view's dtype, and :func:`copy_pages` copies
both planes as they are, so a prefix-cache hit reads the bits its miss
wrote.

``page_tokens`` must divide ``max_len``, so a gathered view is exactly
``max_len`` positions and decode runs the dense path's arithmetic on it.
The page table lives on the device (the decode graphs read it) with a
host mirror that allocation edits.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch

__all__ = ["PageAllocator", "PagedKvCache", "QuantPool", "gather_cache",
           "gather_layer", "scatter_tokens", "scatter_pages", "copy_pages",
           "pages_needed", "paged_verify_logits", "kv_quant_rows"]


def pages_needed(tokens: int, page_tokens: int) -> int:
    return -(-int(tokens) // int(page_tokens))


# ---------------------------------------------------------- 8-bit pools
class QuantPool:
    """One layer's K (or V) pool in 8 bits: ``q`` the int8 pool
    (pool_pages, kv_heads, page_tokens, head_dim) and ``s`` its f32 scale
    plane (pool_pages, kv_heads, page_tokens), one symmetric scale a
    stored row over head_dim. ``view_dtype`` is the dtype a gather
    dequantizes to (the engine's cache dtype, so the attention after the
    gather is the dense path's). A page costs ``kh*pt*(hd + 4)`` bytes
    instead of ``kh*pt*hd*itemsize``."""

    __slots__ = ("q", "s", "view_dtype")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, view_dtype):
        self.q, self.s, self.view_dtype = q, s, view_dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def page_bytes(self) -> int:
        return (self.q[0].numel() * self.q.element_size()
                + self.s[0].numel() * self.s.element_size())

    def __repr__(self):
        return f"QuantPool(q={tuple(self.q.shape)}, view={self.view_dtype})"


def kv_quant_rows(vals: torch.Tensor):
    """K/V rows (..., head_dim) in the kv8 format: ``(q int8, s f32)``, one
    symmetric scale a row over head_dim, ``s`` shaped ``vals.shape[:-1]``
    (``serving.quant.kv_fake_quant`` round-trips through it)."""
    v = vals.float()
    s = v.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(v / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


# ---------------------------------------------------------- device helpers
def gather_layer(pool, pages: torch.Tensor) -> torch.Tensor:
    """One pool (pool_pages, kv_heads, page_tokens, head_dim), a tensor or
    a :class:`QuantPool`, gathered at ``pages`` (..., max_pages) ->
    (..., kv_heads, max_pages*page_tokens, head_dim), a fresh tensor
    (dequantized into ``view_dtype`` from an 8-bit pool)."""
    idx = pages.long()
    if isinstance(pool, QuantPool):
        x = (pool.q[idx].float() * pool.s[idx][..., None]).to(
            pool.view_dtype)
    else:
        x = pool[idx]                          # (..., mp, kh, pt, hd)
    *lead, mp, kh, pt, hd = x.shape
    return x.transpose(-4, -3).reshape(*lead, kh, mp * pt, hd)


def gather_cache(pools: list, pages: torch.Tensor) -> list:
    """Per-layer {"k", "v"} pools gathered at a page-table row (or rows):
    the contiguous views ``model.decode_logits`` expects."""
    return [{n: gather_layer(p, pages) for n, p in layer.items()}
            for layer in pools]


def scatter_tokens(pools: list, tok_kv: list, page_ids: torch.Tensor,
                   offsets: torch.Tensor) -> list:
    """Write per-token K/V into the pools: ``tok_kv`` per layer {"k", "v"}
    of (n, kv_heads, head_dim), ``page_ids``/``offsets`` (n,). Slots own
    disjoint pages, so real writes never collide; junk writes land in the
    null page."""
    pid, off = page_ids.long(), offsets.long()
    for layer, vals in zip(pools, tok_kv):
        for n, pool in layer.items():
            if isinstance(pool, QuantPool):
                pool.q[pid, :, off], pool.s[pid, :, off] = kv_quant_rows(
                    vals[n])
            else:
                pool[pid, :, off] = vals[n].to(pool.dtype)
    return pools


def scatter_pages(pools: list, cache: list, pages: torch.Tensor) -> list:
    """Repack a contiguous (1, kv_heads, n*page_tokens, head_dim) cache
    per layer into the pool pages ``pages`` (n,): the write after a
    prefill. Entries past the reservation are 0, so their chunks pile into
    the null page."""
    idx = pages.long()
    mp = idx.shape[0]
    for layer, c in zip(pools, cache):
        for n, pool in layer.items():
            kh, length, hd = c[n].shape[1:]
            x = c[n][0].reshape(kh, mp, length // mp, hd).transpose(0, 1)
            if isinstance(pool, QuantPool):
                pool.q[idx], pool.s[idx] = kv_quant_rows(x)
            else:
                pool[idx] = x.to(pool.dtype)
    return pools


def copy_pages(pools: list, src: torch.Tensor, dst: torch.Tensor) -> list:
    """Copy pages ``src`` to ``dst`` ((n,) each) in every layer pool (both
    planes of an 8-bit pool, as they are: no second quantization)."""
    s, d = src.long(), dst.long()
    for layer in pools:
        for pool in layer.values():
            for t in ((pool.q, pool.s) if isinstance(pool, QuantPool)
                      else (pool,)):
                t[d] = t[s]
    return pools


def paged_verify_logits(model, toks: torch.Tensor, pools: list,
                        pages: torch.Tensor, pos: torch.Tensor):
    """``model.verify_logits`` over a paged cache (what the JAX engine's
    ``_paged_step`` computes): ``toks`` (b, m) at per-row starts ``pos``
    (b,), ``pages`` (b, max_pages) page-table rows -> (b, m, vocab)
    logits. Layer by layer, the rows' contiguous views are gathered, the
    layer writes the chunk's K/V into them and attends, and the chunk's
    K/V are scattered back into the pools, so the transient is one
    layer's view, not the whole dense cache."""
    b, m = toks.shape
    at = pos[:, None] + torch.arange(m, device=toks.device)  # (b, m)
    pt = pools[0]["k"].shape[2]  # a QuantPool's shape is its q's
    page_ids = pages.gather(1, at // pt).reshape(-1)
    offsets = (at % pt).reshape(-1)
    rows = torch.arange(b, device=toks.device)[:, None]
    h = model.embed_at(toks, pos)
    for layer, pool in zip(model.encoder, pools):
        view = {n: gather_layer(p, pages) for n, p in pool.items()}
        h = layer.decode_step(h, view, pos)
        tok_kv = {n: v[rows, :, at].flatten(0, 1) for n, v in view.items()}
        scatter_tokens([pool], [tok_kv], page_ids, offsets)
    return model.head_logits(h)


# -------------------------------------------------------------- allocation
class PageAllocator:
    """Host free list over page ids 1..pool_pages-1 (0 = null); freed pages
    go to the back and are handed out again in order."""

    def __init__(self, pool_pages: int):
        if pool_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 null + 1 real), "
                             f"got {pool_pages}")
        self.pool_pages = int(pool_pages)
        self._free: collections.deque = collections.deque(
            range(1, self.pool_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.pool_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool cannot serve them (caller queues)."""
        if n > len(self._free):
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not 1 <= p < self.pool_pages:
                raise ValueError(f"freeing invalid page id {p}")
            self._free.append(int(p))


class PagedKvCache:
    """Pools, per-slot page tables and the allocator of a paged
    :class:`~bigdl_tpu_torch.serving.decode.DecodeEngine`.

    ``pools`` is a list with one {"k", "v"} per layer of (pool_pages,
    kv_heads, page_tokens, head_dim) tensors on ``device``, or with
    ``quantized`` (kv8) of :class:`QuantPool` s that gather into
    ``dtype``.
    ``page_table`` is the (slots, max_pages) int64 device table the decode
    graphs read; ``table`` is its host mirror. ``pool_pages`` defaults to
    ``1 + slots * max_pages + extra_pages``: the dense footprint plus
    headroom."""

    def __init__(self, encoder, *, slots: int, max_len: int,
                 page_tokens: int, dtype, device,
                 pool_pages: Optional[int] = None, extra_pages: int = 0,
                 quantized: bool = False):
        page_tokens = int(page_tokens)
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if max_len % page_tokens:
            raise ValueError(
                f"kv page_tokens ({page_tokens}) must divide max_len "
                f"({max_len}) so the gathered view is exactly max_len")
        self.page_tokens = page_tokens
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.max_pages = max_len // page_tokens
        if pool_pages is None:
            pool_pages = 1 + self.slots * self.max_pages + int(extra_pages)
        self.pool_pages = int(pool_pages)
        self.alloc = PageAllocator(self.pool_pages)
        self.quantized = bool(quantized)
        self.pools = encoder.init_cache(
            self.pool_pages, page_tokens,
            torch.int8 if self.quantized else dtype, device)
        if self.quantized:
            self.pools = [{n: QuantPool(t, torch.zeros(
                t.shape[:3], dtype=torch.float32, device=device), dtype)
                for n, t in layer.items()} for layer in self.pools]
        self._bytes_per_page = sum(
            t.page_bytes() if self.quantized
            else t[0].numel() * t.element_size()
            for layer in self.pools for t in layer.values())
        self.table = np.zeros((self.slots, self.max_pages), np.int64)
        self.page_table = torch.zeros((self.slots, self.max_pages),
                                      dtype=torch.int64, device=device)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.slots)]

    def _sync_row(self, slot: int) -> None:
        self.page_table[slot].copy_(torch.from_numpy(self.table[slot]))

    # --------------------------------------------------------------- slots
    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Reserve pages covering ``n_tokens`` for ``slot``; False if the
        pool cannot serve it now (the request stays queued)."""
        need = pages_needed(n_tokens, self.page_tokens)
        got = self.alloc.alloc(need)
        if got is None:
            return False
        self.release(slot)
        self.slot_pages[slot] = got
        self.table[slot, :] = 0
        self.table[slot, :need] = got
        self._sync_row(slot)
        return True

    def release(self, slot: int) -> None:
        if self.slot_pages[slot]:
            self.alloc.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
        if self.table[slot].any():
            self.table[slot, :] = 0
            self._sync_row(slot)

    # ------------------------------------------------------------- metrics
    @property
    def bytes_per_page(self) -> int:
        return self._bytes_per_page

    def allocated_bytes(self) -> int:
        """Bytes of the pages handed out (slots and prefix cache): what
        ``kv_cache_bytes`` reports in paged mode."""
        return self.alloc.pages_in_use * self._bytes_per_page

    def pool_bytes(self) -> int:
        return self.pool_pages * self._bytes_per_page
