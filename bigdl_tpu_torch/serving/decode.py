"""Continuous-batching KV-cache decoding for ``transformer_lm``
(counterpart of ``bigdl_tpu/serving/decode.py``).

* **prefill** — a prompt is right-padded to its length bucket
  (``ops.serving_prefill_buckets``) and run once through
  ``model.prefill_logits`` into a static one-slot cache, then copied into
  its slot: a row of the dense cache, or (paged) the slot's pages. Exact,
  because causal attention never reads past the true last position and
  decode overwrites pad positions before it attends them.
* **decode** — one batched step over all ``slots`` with one position per
  slot, so requests of different lengths and arrival times share the
  batch. Sampling runs in the step (``serving.sampling``): the greedy and
  temperature-only traffic takes the sort-free program, top-k/top-p
  traffic the warping one, and both draw the same tokens when the filters
  are off. A finishing request frees its slot for the next waiting one.
* **paged KV** (``kv_page_tokens``) — the K/V live in pools of pages with
  per-slot page tables (``serving.kv_pages``); a slot reserves the pages
  of prompt + max_new tokens at admission, and a request that cannot
  reserve waits in the queue.
* **shared-prefix cache** (``prefix_cache``, needs paging) — a prompt
  whose page-aligned prefix is cached copies those pages and prefills
  only its suffix (``serving.prefix_cache``).

On the card every prefill bucket, every suffix bucket and both decode
programs are CUDA graphs over static buffers (``serving.graphs``),
captured when the engine is built. A step then is one replay and one
device-to-host copy, of the sampled tokens; ``pos`` advances inside the
graph, and the host keeps a mirror of it. ``graphs=False`` runs the same
code eagerly, as it always runs on the CPU.

Greedy decoding equals the offline ``TransformerLM.generate``: both run
``prefill_logits`` and then ``decode_logits``, and paged decode runs the
dense arithmetic on each layer's gathered view. Speculative decoding and
quantization come in later slices.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device
from bigdl_tpu_torch.ops import serving_prefill_buckets
from bigdl_tpu_torch.serving import kv_pages as _kvp
from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             WorkerDied, _Future)
from bigdl_tpu_torch.serving.graphs import GraphPool, GraphSet
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.sampling import sample_tokens

logger = logging.getLogger(__name__)

__all__ = ["DecodeEngine", "DecodeRequest"]


class DecodeRequest:
    __slots__ = ("tokens", "max_new_tokens", "temperature", "stop_token",
                 "top_k", "top_p", "seed", "future", "out", "deadline", "rid")

    def __init__(self, tokens, max_new_tokens, temperature=0.0,
                 stop_token=None, deadline=None, top_k=0, top_p=1.0,
                 seed=0, rid=None):
        self.tokens = [int(t) for t in tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.stop_token = stop_token
        self.deadline = deadline
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF
        self.future = _Future()
        self.out: list = []
        self.rid = rid


def _later(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported yet (a later slice "
                               f"of the PyTorch port)")


class DecodeEngine:
    """Continuous-batching decoder over ``slots`` on ``device`` (CUDA
    unless the caller asks for the CPU).

    The KV cache is dense (slots x layers x kv_heads x max_len x head_dim
    x 2) or, with ``kv_page_tokens``, paged: pools of ``pool_pages`` pages
    (default: the dense footprint, plus one request's pages of headroom
    with ``prefix_cache``); the prefix cache may hold half the pool.

    ``submit`` prefills into a free slot or queues up to ``max_waiting``
    requests, rejecting beyond that (:class:`AdmissionError`, HTTP 429).
    ``step`` advances every active slot by one token. Without a worker
    thread the caller drives ``step``; ``start()`` runs the decode loop
    for the HTTP server. ``graphs``: True (the engine's own
    :class:`~bigdl_tpu_torch.serving.graphs.GraphPool`), False (eager), or
    a pool shared with an
    :class:`~bigdl_tpu_torch.serving.engine.InferenceEngine`."""

    def __init__(self, model, *, slots: int = 4, cache_dtype=None,
                 max_waiting: int = 64, metrics=None, clock=None,
                 device="cuda", kv_page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 speculate: int = 0, quantize: Optional[str] = None,
                 graphs: Union[bool, GraphPool] = True):
        for flag, name in ((speculate, "speculative decoding (speculate)"),
                           (quantize not in (None, "off"), "quantize")):
            if flag:
                raise _later(name)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.page_tokens = int(kv_page_tokens) if kv_page_tokens else None
        self.paged = self.page_tokens is not None
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires kv_page_tokens "
                             "(prefix sharing is a page copy)")
        self.device = dev = resolve_device(device)
        self.clock = clock or time.monotonic
        self._worker_error: Optional[BaseException] = None
        self._last_beat = self.clock()
        self.model = model.to(dev).eval()
        self.slots = S = int(slots)
        self.max_len = int(model.max_len)
        self.cache_dtype = cache_dtype or model.compute_dtype or torch.float32
        self.max_waiting = int(max_waiting)
        self.prompt_buckets = serving_prefill_buckets(self.max_len)

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._reqs: list = [None] * S
        self._waiting: collections.deque = collections.deque()
        self._pos = np.zeros(S, np.int64)  # host mirror of _pos_d
        self._thread = None
        self._closed = False

        # ---- KV: dense rows or page pools; the static one-slot prefill
        # cache the prefill graphs write before copying into a slot
        if self.paged:
            extra = (self.max_len // self.page_tokens
                     if prefix_cache and pool_pages is None else 0)
            self._kv = _kvp.PagedKvCache(
                model.encoder, slots=S, max_len=self.max_len,
                page_tokens=self.page_tokens, dtype=self.cache_dtype,
                device=dev, pool_pages=pool_pages, extra_pages=extra)
            self._cache = None
        else:
            self._kv = None
            self._cache = model.init_cache(S, self.max_len, self.cache_dtype)
        self._cache1 = model.init_cache(1, self.max_len, self.cache_dtype)
        self._pfx = (PrefixCache(self._kv, metrics=metrics)
                     if prefix_cache else None)
        self.suffix_buckets = self._suffix_buckets() if prefix_cache else ()

        # ---- the graphs' static buffers: per-slot state and knobs, the
        # installing slot, a prompt's last index and offset, token rows
        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._logits = zeros(S, model.vocab, dtype=torch.float32)
        self._toks, self._pos_d, self._live = zeros(S), zeros(S), zeros(S)
        self._temp = zeros(S, dtype=torch.float32)
        self._topk, self._seed = zeros(S), zeros(S)
        self._topp = torch.ones(S, dtype=torch.float32, device=dev)
        self._slot, self._last, self._pos0 = zeros(1), zeros(1), zeros(1)
        self._rows = {n: zeros(1, n) for n in
                      set(self.prompt_buckets) | set(self.suffix_buckets)}

        self._pool = (graphs if isinstance(graphs, GraphPool)
                      else GraphPool(dev, enabled=graphs))
        self.graphs = GraphSet(self._pool)
        self._init_metrics(metrics)
        self.capture()

    # -------------------------------------------------------------- metrics
    def _init_metrics(self, metrics) -> None:
        self.metrics = metrics
        if metrics is None:
            self._m_tokens = self._m_steps = self._m_prefills = None
            self._m_prompt_tokens = self._m_rejected = None
            self._m_expired = self._m_dead = self._m_cancelled = None
            return
        self._m_tokens = metrics.counter(
            "generated_tokens_total", "decode tokens emitted")
        self._m_steps = metrics.counter(
            "decode_steps_total", "batched decode steps executed")
        self._m_prefills = metrics.counter(
            "prefills_total", "prompt prefills executed (prefix hits too)")
        self._m_prompt_tokens = metrics.counter(
            "prompt_tokens_total", "prompt tokens prefilled")
        self._m_rejected = metrics.counter(
            "decode_rejected_total",
            "generate requests fast-rejected (waiting queue full)")
        self._m_expired = metrics.counter(
            "decode_expired_total",
            "generate requests dropped on deadline expiry")
        self._m_dead = metrics.counter(
            "decode_dead_submit_total",
            "generate submits fast-failed (decode worker dead)")
        self._m_cancelled = metrics.counter(
            "decode_cancelled_total", "generate requests cancelled")
        metrics.gauge("decode_worker_up",
                      "1 while the decode loop is healthy",
                      fn=lambda: 0.0 if self._worker_error else 1.0)
        metrics.gauge("decode_slots_active", "occupied decode slots",
                      fn=lambda: sum(r is not None for r in self._reqs))
        metrics.gauge(
            "decode_tokens_per_second",
            "lifetime generated_tokens_total / uptime",
            fn=lambda: (self._m_tokens.value
                        / max(metrics.uptime_s(), 1e-9)))
        what = ("allocated KV page bytes (slots and prefix cache)"
                if self.paged else
                "resident KV cache bytes (all slots, max_len)")
        metrics.gauge("kv_cache_bytes", what, fn=self.kv_bytes)
        metrics.gauge("kv_cache_bytes_per_slot", what + " / slots",
                      fn=lambda: self.kv_bytes() / self.slots)
        if self.paged:
            metrics.gauge("kv_pages_in_use", "KV pool pages handed out",
                          fn=self.kv_pages_in_use)
            logger.info("decode KV pages: %d-token pages, pool %d pages "
                        "(%d bytes; the dense bound is %d bytes)",
                        self.page_tokens, self._kv.pool_pages,
                        self._kv.pool_bytes(),
                        self.slots * self._kv.max_pages
                        * self._kv.bytes_per_page)

    def kv_bytes(self) -> int:
        """Resident KV bytes: the allocated pages when paged, the dense
        cache otherwise."""
        if self.paged:
            return self._kv.allocated_bytes()
        return sum(t.numel() * t.element_size()
                   for layer in self._cache for t in layer.values())

    def kv_pages_in_use(self) -> int:
        return self._kv.alloc.pages_in_use if self.paged else 0

    # ---------------------------------------------------------------- graphs
    def _suffix_buckets(self) -> tuple:
        """Chunk lengths of a prefix hit's suffix prefill: its prompt
        bucket, cut to what is left of the cache after an aligned
        prefix (the JAX package's ``min(bucket, max_len - n_pfx)``)."""
        pt = self.page_tokens
        return tuple(sorted({min(b, self.max_len - n)
                             for n in range(pt, self.max_len, pt)
                             for b in self.prompt_buckets}))

    def _prefill_fn(self, b: int):
        """Prefill of a ``b``-token row into the static one-slot cache,
        then its copy into slot ``_slot``: logits, and the cache's first
        ``b`` positions (dense) or first pages (paged)."""
        model, row, cache1 = self.model, self._rows[b], self._cache1

        def fn():
            lg = model.prefill_logits(row, cache1, last=self._last)
            self._logits.index_copy_(0, self._slot, lg.float())
            if self.paged:
                n = _kvp.pages_needed(b, self.page_tokens)
                pages = self._kv.page_table.index_select(0, self._slot)[0]
                head = [{k: c[k][:, :, :n * self.page_tokens] for k in c}
                        for c in cache1]
                _kvp.scatter_pages(self._kv.pools, head, pages[:n])
            else:
                for full, one in zip(self._cache, cache1):
                    for k in full:
                        full[k][:, :, :b].index_copy_(0, self._slot,
                                                      one[k][:, :, :b])
        return fn

    def _suffix_fn(self, m: int):
        """A prefix hit's suffix prefill: ``m`` tokens at ``_pos0`` into
        slot ``_slot``'s pages, the logits at suffix index ``_last``."""
        model, row = self.model, self._rows[m]

        def fn():
            pages = self._kv.page_table.index_select(0, self._slot)
            lgs = _kvp.paged_verify_logits(model, row, self._kv.pools,
                                           pages, self._pos0)
            self._logits.index_copy_(0, self._slot,
                                     lgs[0].index_select(0, self._last)
                                     .float())
        return fn

    def _step_fn(self, warp: bool):
        """One decode step over every slot: sample from ``_logits``, feed
        the tokens at ``_pos_d``, keep the new logits and tokens, advance
        the live slots' positions."""
        model = self.model

        def fn():
            toks = sample_tokens(self._logits, self._pos_d, self._temp,
                                 self._topk, self._topp, self._seed, warp)
            if self.paged:
                lg = _kvp.paged_verify_logits(
                    model, toks[:, None], self._kv.pools,
                    self._kv.page_table, self._pos_d)[:, 0]
            else:
                lg = model.decode_logits(toks[:, None], self._cache,
                                         self._pos_d)
            self._logits.copy_(lg.float())
            self._toks.copy_(toks)
            self._pos_d.add_(self._live)
        return fn

    def _programs(self) -> dict:
        progs = {("prefill", b): self._prefill_fn(b)
                 for b in self.prompt_buckets}
        progs.update({("suffix", m): self._suffix_fn(m)
                      for m in self.suffix_buckets})
        progs.update({("step", w): self._step_fn(w) for w in (False, True)})
        return progs

    @torch.no_grad()
    def capture(self) -> None:
        """Warm up and capture every program while no slot is active (the
        warm-ups write only free slots' rows, the null page and the
        logits, which an install overwrites); a no-op without graphs."""
        self._progs = self._programs()
        if not self.graphs.enabled:
            return
        with self._lock, self._pool.work():
            if any(r is not None for r in self._reqs):
                raise RuntimeError("capture needs an idle engine")
            for key, fn in self._progs.items():
                if key not in self.graphs:
                    self.graphs.capture(key, fn)
            self._logits.zero_()
            self._pos_d.zero_()

    @torch.no_grad()
    def _run(self, key) -> None:
        self.graphs.run(key, self._progs[key])

    # ------------------------------------------------------------ admission
    def prompt_bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def submit(self, tokens, max_new_tokens: int, temperature: float = 0.0,
               stop_token=None, deadline: Optional[float] = None,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               rid: Optional[str] = None) -> _Future:
        """Queue one generation request; the future resolves to the list
        of generated token ids. Fast-rejects when the waiting queue is
        full, when the decode worker is dead (:class:`WorkerDied`) or when
        ``deadline`` (absolute, on the engine's clock) has passed
        (:class:`DeadlineExceeded`). Paged, a request waits until its
        pages can be reserved."""
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if len(tokens) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt ({len(tokens)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}")
        if any(t < 0 or t >= self.model.vocab for t in tokens):
            raise ValueError(f"token ids must be in [0, {self.model.vocab})")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if self.paged and _kvp.pages_needed(
                len(tokens) + max_new_tokens, self.page_tokens) \
                > self._kv.pool_pages - 1:
            raise ValueError(f"the request needs more KV pages than the "
                             f"pool's {self._kv.pool_pages - 1}")
        req = DecodeRequest(tokens, max_new_tokens, temperature, stop_token,
                            deadline, top_k, top_p, seed, rid=rid)
        with self._lock:
            if self._closed:
                raise RuntimeError("decode engine is closed")
            if self._worker_error is not None or (
                    self._thread is not None
                    and not self._thread.is_alive()):
                if self._m_dead is not None:
                    self._m_dead.inc()
                raise WorkerDied(
                    "decode worker is dead: "
                    f"{self._worker_error or 'thread exited'}")
            if deadline is not None and self.clock() >= deadline:
                if self._m_expired is not None:
                    self._m_expired.inc()
                raise DeadlineExceeded("deadline expired before submit")
            slot = self._free_slot()
            if slot is not None and self._install(req, slot):
                pass
            elif len(self._waiting) >= self.max_waiting:
                if self._m_rejected is not None:
                    self._m_rejected.inc()
                raise AdmissionError(
                    f"decode queue at capacity ({self.max_waiting} waiting)")
            else:
                self._waiting.append(req)
            self._work.notify()
        return req.future

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._reqs):
            if r is None:
                return i
        return None

    def _release_slot(self, slot: int) -> None:
        """Free ``slot`` and its pages (lock held)."""
        self._reqs[slot] = None
        self._pos[slot] = 0
        with self._pool.work():
            self._live[slot].fill_(0)
            self._pos_d[slot].fill_(0)
            if self.paged:
                self._kv.release(slot)

    def _admit(self) -> None:
        """Install waiting requests into free slots in FIFO order (lock
        held). A paged reservation that fails leaves the request at the
        head of the queue, to retry when a slot frees its pages."""
        while self._waiting:
            slot = self._free_slot()
            if slot is None or not self._install(self._waiting[0], slot):
                return
            self._waiting.popleft()

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def _install(self, req: DecodeRequest, slot: int) -> bool:
        """Prefill ``req``'s prompt into ``slot`` (lock held). False iff
        the paged pool cannot serve the request's reservation yet."""
        s = len(req.tokens)
        with self._pool.work():
            if self.paged and not self._kv.reserve(
                    slot, s + req.max_new_tokens):
                return False
            n_pfx, src = (self._pfx.match(req.tokens)
                          if self._pfx is not None else (0, []))
            self._slot.fill_(slot)
            if n_pfx:
                self._prefill_from_prefix(req, slot, n_pfx, src)
            else:
                b = self.prompt_bucket_for(s)
                self._stage(b, req.tokens)
                self._last.fill_(s - 1)
                self._run(("prefill", b))
            if self._pfx is not None:
                self._maybe_insert_prefix(req, slot)
            self._pos_d[slot].fill_(s)
            self._live[slot].fill_(1)
            self._temp[slot].fill_(req.temperature)
            self._topk[slot].fill_(req.top_k)
            self._topp[slot].fill_(req.top_p)
            self._seed[slot].fill_(req.seed)
        self._pos[slot] = s
        self._reqs[slot] = req
        if self._m_prefills is not None:
            self._m_prefills.inc()
            self._m_prompt_tokens.inc(s - n_pfx)
        return True

    def _stage(self, n: int, tokens) -> None:
        """Right-pad ``tokens`` to ``n`` into the static row of length n."""
        row = torch.zeros((1, n), dtype=torch.int64)
        row[0, :len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        self._rows[n].copy_(row)

    def _pages(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)

    def _prefill_from_prefix(self, req, slot: int, n_pfx: int, src) -> None:
        """Prefix-cache hit: copy the entry's pages into the slot, then
        prefill only the suffix at offset ``n_pfx``."""
        pt = self.page_tokens
        _kvp.copy_pages(self._kv.pools, self._pages(src),
                        self._pages(self._kv.table[slot, :n_pfx // pt]))
        suffix = req.tokens[n_pfx:]
        m = min(self.prompt_bucket_for(len(suffix)), self.max_len - n_pfx)
        self._stage(m, suffix)
        self._pos0.fill_(n_pfx)
        self._last.fill_(len(suffix) - 1)
        self._run(("suffix", m))

    def _maybe_insert_prefix(self, req, slot: int) -> None:
        ins = self._pfx.prepare_insert(req.tokens)
        if ins is None:
            return
        key, dst = ins
        _kvp.copy_pages(self._kv.pools,
                        self._pages(self._kv.table[slot, :len(dst)]),
                        self._pages(dst))
        self._pfx.commit_insert(key, dst, len(dst) * self.page_tokens)

    # ------------------------------------------------------------- emission
    def _emit(self, req, slot: int, tok: int) -> None:
        """Append one generated token to ``req`` (lock held); a finished
        request resolves and hands its slot to the next waiting one."""
        req.out.append(int(tok))
        if self._m_tokens is not None:
            self._m_tokens.inc()
        if (len(req.out) >= req.max_new_tokens
                or (req.stop_token is not None
                    and int(tok) == req.stop_token)):
            self._release_slot(slot)
            req.future.set_result(list(req.out))
            self._admit()

    # ------------------------------------------------------------ deadlines
    def _expire(self, now: float) -> None:
        """Drop expired requests before compute is spent on them (lock
        held): waiting ones resolve with :class:`DeadlineExceeded`, active
        ones free their slot for the next live waiting request."""
        if self._waiting:
            live = collections.deque()
            for req in self._waiting:
                if req.deadline is not None and now >= req.deadline:
                    if self._m_expired is not None:
                        self._m_expired.inc()
                    req.future.set_exception(DeadlineExceeded(
                        "deadline expired while waiting for a decode "
                        "slot"))
                else:
                    live.append(req)
            self._waiting = live
        for i, req in enumerate(self._reqs):
            if (req is not None and req.deadline is not None
                    and now >= req.deadline):
                self._release_slot(i)
                if self._m_expired is not None:
                    self._m_expired.inc()
                req.future.set_exception(DeadlineExceeded(
                    f"deadline expired after {len(req.out)} of "
                    f"{req.max_new_tokens} tokens"))
                self._admit()

    def cancel(self, rid: str, reason: str = "client disconnected") -> bool:
        """Drop the request ``rid`` wherever it is (waiting or in a slot),
        freeing its slot and pages for the next waiting request. True iff
        found."""
        if rid is None:
            return False
        with self._lock:
            req = next((r for r in self._waiting if r.rid == rid), None)
            if req is not None:
                self._waiting.remove(req)
            else:
                for i, r in enumerate(self._reqs):
                    if r is not None and r.rid == rid:
                        req = r
                        self._release_slot(i)
                        self._admit()
                        break
            if req is None:
                return False
            if self._m_cancelled is not None:
                self._m_cancelled.inc()
            self._work.notify()
        req.future.set_exception(
            RuntimeError(f"request {rid} cancelled: {reason}"))
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> int:
        """One batched decode step: every active slot emits one token.
        Returns the number of slots advanced (0 = idle)."""
        with self._lock:
            self._last_beat = self.clock()
            self._expire(self.clock())
            active = [i for i, r in enumerate(self._reqs) if r is not None]
            if not active:
                return 0
            return self._step_plain(active)

    def _needs_warp(self, active) -> bool:
        return any(self._reqs[i].top_k > 0 or self._reqs[i].top_p < 1.0
                   for i in active)

    def _step_plain(self, active) -> int:
        with self._pool.work():
            self._run(("step", self._needs_warp(active)))
            toks = self._toks.tolist()  # the step's one device-to-host copy
        if self._m_steps is not None:
            self._m_steps.inc()
        for i in active:
            self._pos[i] += 1
            self._emit(self._reqs[i], i, toks[i])
        return len(active)

    def generate(self, tokens, max_new_tokens: int, temperature: float = 0.0,
                 stop_token=None, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> list:
        """Submit one request and, without a worker thread, drive the
        decode loop until it resolves."""
        fut = self.submit(tokens, max_new_tokens, temperature, stop_token,
                          top_k=top_k, top_p=top_p, seed=seed)
        if self._thread is None:
            while not fut.done():
                if self.step() == 0 and not fut.done():
                    raise RuntimeError(
                        "decode engine idle with unresolved request")
        return fut.result()

    # ------------------------------------------------------ watchdog surface
    def alive(self) -> bool:
        if self._worker_error is not None:
            return False
        return self._thread is None or self._thread.is_alive()

    def busy(self) -> bool:
        return (any(r is not None for r in self._reqs)
                or bool(self._waiting))

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        return (self.clock() if now is None else now) - self._last_beat

    @property
    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error

    def declare_dead(self, exc: BaseException) -> None:
        """Fail every in-flight and waiting request with
        :class:`WorkerDied`; later submits fail at once."""
        with self._lock:
            if self._worker_error is None:
                self._worker_error = exc
            dead = list(self._waiting)
            self._waiting.clear()
            for i, req in enumerate(self._reqs):
                if req is not None:
                    self._reqs[i] = None
                    dead.append(req)
            self._work.notify_all()
        err = (exc if isinstance(exc, WorkerDied)
               else WorkerDied(f"decode worker died: {exc}"))
        for req in dead:
            req.future.set_exception(err)

    # --------------------------------------------------------------- worker
    def start(self) -> None:
        """Launch the decode loop thread (server mode); the graphs were
        captured when the engine was built."""
        if self._thread is not None:
            return

        def _loop():
            try:
                while True:
                    with self._lock:
                        self._last_beat = self.clock()
                        while (not self._closed
                               and not any(r is not None
                                           for r in self._reqs)):
                            self._work.wait()
                            self._last_beat = self.clock()
                        if self._closed:
                            return
                    self.step()
            except BaseException as e:
                logger.exception("decode loop died")
                self.declare_dead(e)

        self._thread = threading.Thread(target=_loop, name="decode-loop",
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        """Fail what is queued or in flight, stop the loop and drop the
        graphs."""
        with self._lock:
            self._closed = True
            for req in self._waiting:
                req.future.set_exception(RuntimeError("decode engine closed"))
            self._waiting.clear()
            for i, req in enumerate(self._reqs):
                if req is not None:
                    self._reqs[i] = None
                    req.future.set_exception(
                        RuntimeError("decode engine closed mid-request"))
            self._work.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        self.graphs.clear()
