"""Shared-prefix KV cache for the paged decoder (counterpart of
``bigdl_tpu/serving/prefix_cache.py``).

The K/V a causal model produces for a prompt prefix depends on the prefix
alone, so requests that share one (a system prompt, a few-shot block) can
share its pages:

* on a prefill miss the engine runs the bucketed prefill, then copies the
  slot's leading page-aligned pages into pages the cache owns, under a
  hash of the tokens they encode;
* on a hit the engine copies the entry's pages into the new slot and runs
  a chunked suffix prefill (``kv_pages.paged_verify_logits`` at the
  page-aligned offset) over the remaining tokens only.

Entries are page-granular: an s-token prompt caches ``(s - 1) //
page_tokens`` pages, so at least one token always recomputes (the engine
needs the logits at position s - 1, and pages hold K/V, not logits).
Matching walks aligned prefix lengths longest first. Eviction is LRU
under a page budget served by the slots' allocator, so cached pages and
decode pages meet in one account (``kv_pages_in_use`` counts both).
"""

from __future__ import annotations

import collections
import hashlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache"]


def _digest(tokens) -> bytes:
    return hashlib.sha1(np.asarray(tokens, np.int64).tobytes()).digest()


class _Entry:
    __slots__ = ("pages", "n_tokens")

    def __init__(self, pages: List[int], n_tokens: int):
        self.pages = pages
        self.n_tokens = n_tokens


class PrefixCache:
    """LRU page-granular prefix store over ``kv.alloc``
    (:class:`~bigdl_tpu_torch.serving.kv_pages.PagedKvCache`).
    ``max_pages`` bounds the pages it holds (default: half the pool); an
    insert that cannot fit evicts LRU entries first and is skipped if
    eviction cannot make room (decode never blocks on it)."""

    def __init__(self, kv, *, max_pages: Optional[int] = None,
                 metrics=None):
        self.kv = kv
        self.page_tokens = kv.page_tokens
        if max_pages is None:
            max_pages = max(1, (kv.pool_pages - 1) // 2)
        self.max_pages = int(max_pages)
        self._entries: "collections.OrderedDict[bytes, _Entry]" = \
            collections.OrderedDict()
        self.hits = self.misses = self.inserts = self.evictions = 0
        if metrics is not None:
            self._m_hits = metrics.counter(
                "prefix_cache_hits_total",
                "prefills served from the shared-prefix KV cache")
            self._m_miss = metrics.counter(
                "prefix_cache_misses_total",
                "prefills with no usable cached prefix")
            metrics.gauge("prefix_cache_pages",
                          "KV pool pages the prefix cache holds",
                          fn=self.cached_pages)
        else:
            self._m_hits = self._m_miss = None

    # -------------------------------------------------------------- lookup
    def cached_pages(self) -> int:
        return sum(len(e.pages) for e in self._entries.values())

    def cached_tokens(self) -> int:
        return sum(e.n_tokens for e in self._entries.values())

    def _usable_prefix(self, n_prompt: int) -> int:
        """Longest cacheable prefix of an n-token prompt: page-aligned and
        strictly shorter than the prompt."""
        return ((n_prompt - 1) // self.page_tokens) * self.page_tokens

    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` -> (n_tokens, pages), (0, [])
        on a miss. Counts the hit or miss."""
        n = self._usable_prefix(len(tokens))
        while n >= self.page_tokens:
            key = _digest(tokens[:n])
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                if self._m_hits is not None:
                    self._m_hits.inc()
                return ent.n_tokens, list(ent.pages)
            n -= self.page_tokens
        self.misses += 1
        if self._m_miss is not None:
            self._m_miss.inc()
        return 0, []

    # -------------------------------------------------------------- insert
    def insertable_prefix(self, tokens) -> int:
        """How many leading tokens an insert would cache (0: nothing new)."""
        n = self._usable_prefix(len(tokens))
        if n < self.page_tokens or _digest(tokens[:n]) in self._entries:
            return 0
        return n

    def prepare_insert(self, tokens) -> Optional[Tuple[bytes, List[int]]]:
        """Pages for caching ``tokens``' usable prefix, evicting LRU entries
        as needed: (key, dst_pages), which the caller fills by a page copy
        and then commits (:meth:`commit_insert`) or returns
        (:meth:`abort_insert`); None when nothing should be cached (too
        short, already cached, or no room even after eviction)."""
        n = self.insertable_prefix(tokens)
        if n == 0:
            return None
        need = n // self.page_tokens
        if need > self.max_pages:
            return None
        while (self.cached_pages() + need > self.max_pages
               or self.kv.alloc.free_pages < need):
            if not self._entries:
                break
            self._evict_one()
        pages = self.kv.alloc.alloc(need)
        if pages is None:
            return None
        return _digest(tokens[:n]), pages

    def commit_insert(self, key: bytes, pages: List[int],
                      n_tokens: int) -> None:
        self._entries[key] = _Entry(pages, n_tokens)
        self.inserts += 1

    def abort_insert(self, pages: List[int]) -> None:
        self.kv.alloc.free(pages)

    # ------------------------------------------------------------ eviction
    def _evict_one(self) -> None:
        _, ent = self._entries.popitem(last=False)
        self.kv.alloc.free(ent.pages)
        self.evictions += 1

    def clear(self) -> None:
        while self._entries:
            self._evict_one()
