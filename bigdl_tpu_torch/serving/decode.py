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
* **speculative decoding** (``speculate=K``) — a draft LM (the target
  itself by default, "self-draft") proposes up to K tokens a round with
  single-token steps over its own dense cache; the target scores them and
  the position after them in one chunked verify, and
  ``spec_decode.accept_chunk`` keeps greedy output token for token that
  of plain decoding and sampled output distributed as the target's. Each
  slot emits 1 to K+1 tokens a round; the first token is sampled at
  install.
* **quantized serving** (``quantize``) — int8 or fp8 weights
  (``serving.quant``, the dequant folded into each product), and ``kv8``
  page pools of int8 rows with f32 scales (``serving.kv_pages``; needs
  paging).

On the card every prefill bucket, every suffix bucket and the decode
programs are CUDA graphs over static buffers (``serving.graphs``),
captured when the engine is built: the two plain steps, or, speculative,
the draft's prefill buckets, its step and the verify-and-accept program
of every chunk length 1..K+1. A plain step is one replay and one
device-to-host copy, of the sampled tokens; a speculative round is m
draft replays, one verify-and-accept replay and one copy, of the emitted
tokens and counts. ``pos`` advances inside the graphs, and the host keeps
a mirror of it. ``graphs=False`` runs the same code eagerly, as it always
runs on the CPU.

Greedy decoding equals the offline ``TransformerLM.generate``: both run
``prefill_logits`` and then ``decode_logits``, and paged decode runs the
dense arithmetic on each layer's gathered view.

Streaming: ``submit(..., emit=fn)`` calls ``fn(new_tokens, done)`` from
the decode loop for every round that emits (speculative: the round's
accepted tokens, each once), with the tokens the step already copied to
the host; it runs under the engine lock and must only hand them off.
With ``--reqTrace`` on, the request's lifecycle record notes its
queueing, prefill, every emitting round and how it ended.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import warnings
from typing import Optional, Union

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device
from bigdl_tpu_torch.obs import memory as _obs_mem
from bigdl_tpu_torch.ops import serving_prefill_buckets
from bigdl_tpu_torch.serving import kv_pages as _kvp
from bigdl_tpu_torch.serving import quant as _q
from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             WorkerDied, _Future)
from bigdl_tpu_torch.serving.graphs import GraphPool, GraphSet
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.reqtrace import get as _get_reqtracer
from bigdl_tpu_torch.serving.sampling import sample_token, sample_tokens
from bigdl_tpu_torch.serving.spec_decode import accept_chunk, draft_propose

logger = logging.getLogger(__name__)

__all__ = ["DecodeEngine", "DecodeRequest"]


class DecodeRequest:
    __slots__ = ("tokens", "max_new_tokens", "temperature", "stop_token",
                 "top_k", "top_p", "seed", "future", "out", "deadline", "rid",
                 "emit")

    def __init__(self, tokens, max_new_tokens, temperature=0.0,
                 stop_token=None, deadline=None, top_k=0, top_p=1.0,
                 seed=0, rid=None, emit=None):
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
        # the streaming sink: emit(new_tokens, done) per emitting round
        self.emit = emit


class DecodeEngine:
    """Continuous-batching decoder over ``slots`` on ``device`` (CUDA
    unless the caller asks for the CPU).

    The KV cache is dense (slots x layers x kv_heads x max_len x head_dim
    x 2) or, with ``kv_page_tokens``, paged: pools of ``pool_pages`` pages
    (default: the dense footprint, plus one request's pages of headroom
    with ``prefix_cache``); the prefix cache may hold half the pool.

    ``submit`` prefills into a free slot or queues up to ``max_waiting``
    requests, rejecting beyond that (:class:`AdmissionError`, HTTP 429).
    ``step`` advances every active slot by one token, or, speculative, by
    one round of 1 to ``speculate + 1`` tokens. Without a worker thread
    the caller drives ``step``; ``start()`` runs the decode loop for the
    HTTP server. ``graphs``: True (the engine's own
    :class:`~bigdl_tpu_torch.serving.graphs.GraphPool`), False (eager), or
    a pool shared with an
    :class:`~bigdl_tpu_torch.serving.engine.InferenceEngine`.

    ``speculate``: the draft's chunk length K (0: plain decoding);
    ``draft_model`` the proposer, by default the target itself. The
    draft keeps its own dense cache in its own compute dtype, also when
    the target's is paged. ``quantize``: a ``--quantize`` mode
    (``serving.quant.QUANTIZE_CHOICES``); the engine serves a quantized
    copy of the model (and of a distinct draft), and ``kv8`` needs
    ``kv_page_tokens``. ``off`` or None serves the model as it is.

    ``tp``: a :class:`~bigdl_tpu_torch.serving.sharding.TPLink` of a tp:K
    engine whose model is placed on this rank
    (``ServingSharding.place_params``). Every rank builds the same engine;
    rank 0 drives it, and each call of a device program (a prefill, a
    step, a verify, a draft step, a page copy) is broadcast with its host
    inputs (the slot knobs, the staged row, the page table), so ranks
    1..K-1 (``tp.serve()``) run it on their shards. The programs run
    eagerly under tp."""

    def __init__(self, model, *, slots: int = 4, cache_dtype=None,
                 max_waiting: int = 64, metrics=None, clock=None,
                 device="cuda", kv_page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 speculate: int = 0, draft_model=None,
                 quantize: Optional[str] = None,
                 graphs: Union[bool, GraphPool] = True, tp=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        self.page_tokens = int(kv_page_tokens) if kv_page_tokens else None
        self.paged = self.page_tokens is not None
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires kv_page_tokens "
                             "(prefix sharing is a page copy)")
        self.quantize = quantize or "off"
        wfmt, kv8 = _q.parse_quantize(quantize)
        if kv8 and not self.paged:
            raise ValueError("--quantize kv8 requires kv_page_tokens "
                             "(8-bit KV is a page-pool layout)")
        self.device = dev = resolve_device(device)
        self.clock = clock or time.monotonic
        self._worker_error: Optional[BaseException] = None
        self._last_beat = self.clock()
        model = _q.quantize_params(model.to(dev), wfmt)
        self.model = model.eval()
        self.speculate = K = int(speculate)
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
        # cancels handed to the loop: (rid, reason, done event, [result])
        self._cancels: collections.deque = collections.deque()

        # ---- KV: dense rows or page pools; the static one-slot prefill
        # cache the prefill graphs write before copying into a slot
        if self.paged:
            extra = (self.max_len // self.page_tokens
                     if prefix_cache and pool_pages is None else 0)
            self._kv = _kvp.PagedKvCache(
                model.encoder, slots=S, max_len=self.max_len,
                page_tokens=self.page_tokens, dtype=self.cache_dtype,
                device=dev, pool_pages=pool_pages, extra_pages=extra,
                quantized=kv8)
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

        # ---- speculative: the draft, its dense cache (and one-slot
        # prefill cache), and the round's buffers: each slot's pending
        # feed, the round's draft step j, the proposals and their q rows,
        # and the round's output (emitted tokens, then n_emit and
        # n_accept)
        self.draft_model = self._dcache = None
        if K:
            draft = (self.model if draft_model is None else
                     _q.quantize_params(draft_model.to(dev), wfmt).eval())
            if draft.vocab != model.vocab or draft.max_len < self.max_len:
                raise ValueError(
                    f"the draft (vocab {draft.vocab}, max_len "
                    f"{draft.max_len}) must share the target's vocabulary "
                    f"({model.vocab}) and cover its max_len "
                    f"({self.max_len})")
            self.draft_model = draft
            ddt = draft.compute_dtype or torch.float32
            self._dcache = draft.init_cache(S, self.max_len, ddt)
            self._dcache1 = draft.init_cache(1, self.max_len, ddt)
            self._pending, self._j = zeros(S), zeros(1)
            self._props = zeros(S, K + 1)
            self._q = zeros(S, K + 1, model.vocab, dtype=torch.float32)
            self._round = zeros(S, K + 3)

        self._tp = tp if tp is not None and tp.size > 1 else None
        if self._tp is not None:
            if isinstance(graphs, GraphPool) and graphs.enabled:
                raise ValueError("a tp engine runs its programs eagerly: "
                                 "pass graphs=False or an eager pool")
            graphs = graphs if isinstance(graphs, GraphPool) else False
            self._tp.register("decode.run", self._tp_run)
            self._tp.register("decode.copy", self._tp_copy)
        self._pool = (graphs if isinstance(graphs, GraphPool)
                      else GraphPool(dev, enabled=graphs))
        self.graphs = GraphSet(self._pool)
        self._init_metrics(metrics)
        self.capture()

    # -------------------------------------------------------------- metrics
    def _init_metrics(self, metrics) -> None:
        self.metrics = metrics
        self._m_spec_prop = self._m_spec_acc = self._m_draft_steps = None
        if metrics is None:
            self._m_tokens = self._m_steps = self._m_prefills = None
            self._m_prompt_tokens = self._m_rejected = None
            self._m_expired = self._m_dead = self._m_cancelled = None
            return
        self._m_tokens = metrics.counter(
            "generated_tokens_total", "decode tokens emitted")
        self._m_steps = metrics.counter(
            "decode_steps_total",
            "batched target decode steps or verify rounds executed")
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
        if self.speculate:
            self._m_spec_prop = metrics.counter(
                "spec_proposed_total", "draft tokens proposed")
            self._m_spec_acc = metrics.counter(
                "spec_accepted_total", "draft tokens accepted by verify")
            self._m_draft_steps = metrics.counter(
                "spec_draft_steps_total", "draft-model decode steps")
            metrics.gauge("spec_accept_rate",
                          "accepted / proposed draft tokens",
                          fn=lambda: (self._m_spec_acc.value
                                      / max(self._m_spec_prop.value, 1)))
            metrics.gauge("spec_accepted_tokens_per_step",
                          "tokens emitted per target verify step",
                          fn=lambda: (self._m_tokens.value
                                      / max(self._m_steps.value, 1)))
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

    def queue_load(self) -> int:
        """Active slots plus waiting requests: the routing and drain
        signal (a lock-free read; callers that need it exact hold the
        engine lock)."""
        return (sum(r is not None for r in self._reqs)
                + len(self._waiting))

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

    def _draft_prefill_fn(self, b: int):
        """The draft's prefill of the ``b``-token row into its one-slot
        cache (its logits are not needed), then the copy of the first
        ``b`` positions into slot ``_slot`` of its dense cache."""
        draft, row, cache1 = self.draft_model, self._rows[b], self._dcache1

        def fn():
            draft.encoder.prefill(draft.embed_at(row, 0), cache1)
            for full, one in zip(self._dcache, cache1):
                for k in full:
                    full[k][:, :, :b].index_copy_(0, self._slot,
                                                  one[k][:, :, :b])
        return fn

    def _draft_step_fn(self):
        """Draft step j of a round over every slot: feed the pending token
        (j = 0) or proposal j-1 at ``_pos_d + j``, propose, and keep the
        proposal and its q row in column j."""
        draft, last = self.draft_model, self.speculate

        def fn():
            j = self._j.clamp(max=last)
            feed = torch.cat([self._pending[:, None], self._props],
                             dim=1).index_select(1, j)
            pos = self._pos_d + j
            lg = draft.decode_logits(feed, self._dcache, pos).float()
            prop, q = draft_propose(lg, self._temp, self._topk, self._topp,
                                    self._seed, pos)
            self._props.index_copy_(1, j, prop[:, None])
            self._q.index_copy_(1, j, q[:, None])
            self._j.add_(1)
        return fn

    def _verify_fn(self, m: int):
        """A round's end for chunk length ``m``: the target verifies the
        pending feeds and the first m-1 proposals at ``_pos_d``, the
        acceptance rule picks what each slot emits, the live slots advance
        by it, and the next round's pending token and draft step are
        set."""
        model, K = self.model, self.speculate

        def fn():
            props, q = self._props[:, :m - 1], self._q[:, :m - 1]
            chunk = torch.cat([self._pending[:, None], props], dim=1)
            if self.paged:
                lg = _kvp.paged_verify_logits(model, chunk, self._kv.pools,
                                              self._kv.page_table,
                                              self._pos_d)
            else:
                lg = model.verify_logits(chunk, self._cache, self._pos_d)
            emitted, n_emit, n_acc = accept_chunk(
                lg.float(), q, props, self._temp, self._topk, self._topp,
                self._seed, self._pos_d)
            self._round[:, :m].copy_(emitted)
            self._round[:, K + 1].copy_(n_emit)
            self._round[:, K + 2].copy_(n_acc)
            self._pos_d.add_(n_emit * self._live)
            self._pending.copy_(emitted.gather(1, (n_emit - 1)[:, None])[:, 0])
            self._j.zero_()
        return fn

    def _programs(self) -> dict:
        progs = {("prefill", b): self._prefill_fn(b)
                 for b in self.prompt_buckets}
        progs.update({("suffix", m): self._suffix_fn(m)
                      for m in self.suffix_buckets})
        if not self.speculate:
            progs.update({("step", w): self._step_fn(w)
                          for w in (False, True)})
            return progs
        progs.update({("draft prefill", b): self._draft_prefill_fn(b)
                      for b in self.prompt_buckets})
        progs[("draft",)] = self._draft_step_fn()
        progs.update({("verify", m): self._verify_fn(m) for m in
                      range(1, min(self.speculate + 1, self.max_len) + 1)})
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
            if self.speculate:
                self._pending.zero_()
                self._j.zero_()

    @torch.no_grad()
    def _run(self, key) -> None:
        if self._tp is not None:
            self._tp.call("decode.run", key, self._host_inputs(key))
            return
        self.graphs.run(key, self._progs[key])

    # ------------------------------------------------------ tensor parallel
    # the small device buffers a program reads, mirrored from the leader
    _TP_STATE = ("_slot", "_last", "_pos0", "_pos_d", "_live", "_temp",
                 "_topk", "_topp", "_seed")

    def _host_inputs(self, key) -> dict:
        """The host copies of what program ``key`` reads besides the
        weights, the caches and its own outputs."""
        names = self._TP_STATE + (("_pending", "_j") if self.speculate
                                  else ())
        out = {n: getattr(self, n).cpu().numpy() for n in names}
        if key[0] in ("prefill", "suffix", "draft prefill"):
            out["row"] = self._rows[key[1]].cpu().numpy()
        if self.paged:
            out["table"] = self._kv.table.copy()
        return out

    @torch.no_grad()
    def _tp_run(self, key, inputs: dict) -> None:
        """Run program ``key`` on this rank's shards (a follower first
        takes the leader's host inputs)."""
        if not self._tp.leader:
            for n, v in inputs.items():
                if n == "row":
                    self._rows[key[1]].copy_(torch.from_numpy(v))
                elif n == "table":
                    self._kv.table[:] = v
                    self._kv.page_table.copy_(torch.from_numpy(v))
                else:
                    getattr(self, n).copy_(torch.from_numpy(v))
        self.graphs.run(key, self._progs[key])

    @torch.no_grad()
    def _tp_copy(self, src, dst) -> None:
        _kvp.copy_pages(self._kv.pools, self._pages(src), self._pages(dst))

    def _copy_pages(self, src, dst) -> None:
        """Copy pool pages ``src`` to ``dst`` (every rank's, under tp)."""
        src, dst = [int(p) for p in src], [int(p) for p in dst]
        if self._tp is not None:
            self._tp.call("decode.copy", src, dst)
        else:
            self._tp_copy(src, dst)

    # ------------------------------------------------------------ admission
    def trace_step_graph(self):
        """The FX graph of the full-sampling decode step (the warping
        program: what the decode lint rules read,
        ``bigdl_tpu_torch.analysis.run_decode_rules``), traced on fake
        tensors: nothing runs on the device and no state changes."""
        from bigdl_tpu_torch.analysis.fx_walk import trace_graph

        fn = self._step_fn(True)
        with torch.no_grad():
            return trace_graph(fn, mode=getattr(self, "_fake_mode", None))

    def prompt_bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def submit(self, tokens, max_new_tokens: int, temperature: float = 0.0,
               stop_token=None, deadline: Optional[float] = None,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               rid: Optional[str] = None, emit=None) -> _Future:
        """Queue one generation request; the future resolves to the list
        of generated token ids. Fast-rejects when the waiting queue is
        full, when the decode worker is dead (:class:`WorkerDied`) or when
        ``deadline`` (absolute, on the engine's clock) has passed
        (:class:`DeadlineExceeded`). Paged, a request waits until its
        pages can be reserved. ``rid`` tags the request for lifecycle
        tracing and :meth:`cancel`; ``emit`` is the streaming sink,
        called as ``emit(new_tokens, done)`` under the engine lock (it
        must only hand the tokens off, e.g. ``queue.put_nowait``)."""
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
                            deadline, top_k, top_p, seed, rid=rid, emit=emit)
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
            if not self.busy():
                # the loop last beat when it went idle: the stall clock
                # starts with this request (its prefill runs under the
                # lock, where the loop cannot beat)
                self._last_beat = self.clock()
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
                if rid is not None:
                    rt = _get_reqtracer()
                    if rt is not None:
                        rt.note_queued(rid)
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
        head of the queue, to retry when a slot frees its pages. (An
        install may finish its request at once, speculative, and admit
        the next itself.)"""
        while self._waiting:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._waiting.popleft()
            if not self._install(req, slot):
                self._waiting.appendleft(req)
                return

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def _install(self, req: DecodeRequest, slot: int) -> bool:
        """Prefill ``req``'s prompt into ``slot`` (lock held). False iff
        the paged pool cannot serve the request's reservation yet."""
        s = len(req.tokens)
        rt = _get_reqtracer() if req.rid is not None else None
        t0_pf = rt.clock() if rt is not None else 0.0
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
            if self.speculate:
                tok0 = self._install_draft(req, slot)
        self._pos[slot] = s
        self._reqs[slot] = req
        if self._m_prefills is not None:
            self._m_prefills.inc()
            self._m_prompt_tokens.inc(s - n_pfx)
        if rt is not None:
            rt.note_prefill(req.rid, t0_pf, rt.clock(), slot=slot,
                            prefix_hit_tokens=n_pfx,
                            pages=(len(self._kv.slot_pages[slot])
                                   if self.paged else None))
        if self.speculate:
            # the first token is emitted now and fed as the first round's
            # pending token: the plain step's first draw (seed, pos s)
            self._emit(req, slot, [tok0])
        return True

    def _install_draft(self, req, slot: int) -> int:
        """Speculative install (lock and pool held): the draft prefills the
        whole prompt into its cache (a prefix hit too); the first token is
        drawn from the target's logits and becomes the slot's pending feed.
        Returns it."""
        s = len(req.tokens)
        b = self.prompt_bucket_for(s)
        self._stage(b, req.tokens)
        self._run(("draft prefill", b))
        tok0 = sample_token(self._logits[slot], req.temperature, req.top_k,
                            req.top_p, req.seed, s)
        self._pending[slot].fill_(tok0)
        return tok0

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
        self._copy_pages(src, self._kv.table[slot, :n_pfx // pt])
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
        self._copy_pages(self._kv.table[slot, :len(dst)], dst)
        self._pfx.commit_insert(key, dst, len(dst) * self.page_tokens)

    # ------------------------------------------------------------- emission
    def _emit(self, req, slot: int, toks, accepted=None) -> None:
        """Append generated tokens to ``req`` up to its budget or stop
        token (lock held), note the round and hand the new tokens to the
        request's sink; a finished request resolves and hands its slot
        to the next waiting one. ``accepted``: the draft tokens the
        verify kept this round (None on the plain path)."""
        done, n = False, 0
        for tok in toks:
            req.out.append(int(tok))
            n += 1
            if (len(req.out) >= req.max_new_tokens
                    or (req.stop_token is not None
                        and int(tok) == req.stop_token)):
                done = True
                break
        if self._m_tokens is not None:
            self._m_tokens.inc(n)
        rt = _get_reqtracer() if req.rid is not None else None
        if rt is not None and n:
            rt.note_round(req.rid, n, accepted=accepted,
                          pages=(len(self._kv.slot_pages[slot])
                                 if self.paged else None),
                          pos=int(self._pos[slot]))
        if req.emit is not None and n:
            # a broken sink must not take the decode loop (and every
            # other slot) down: a disconnect is cancel(), not an error
            try:
                req.emit(req.out[-n:], done)
            except Exception:
                logger.exception("streaming emit sink failed (rid=%s)",
                                 req.rid)
        if done:
            self._release_slot(slot)
            req.future.set_result(list(req.out))
            if rt is not None:
                rt.finish(req.rid, "finished")
            self._admit()

    # ------------------------------------------------------------ deadlines
    def _expire(self, now: float) -> None:
        """Drop expired requests before compute is spent on them (lock
        held): waiting ones resolve with :class:`DeadlineExceeded`, active
        ones free their slot for the next live waiting request."""
        rt = _get_reqtracer()
        if self._waiting:
            live = collections.deque()
            for req in self._waiting:
                if req.deadline is not None and now >= req.deadline:
                    if self._m_expired is not None:
                        self._m_expired.inc()
                    req.future.set_exception(DeadlineExceeded(
                        "deadline expired while waiting for a decode "
                        "slot"))
                    if rt is not None and req.rid is not None:
                        rt.finish(req.rid, "expired",
                                  error="expired in decode queue")
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
                if rt is not None and req.rid is not None:
                    rt.finish(req.rid, "expired",
                              error=f"expired mid-decode after "
                                    f"{len(req.out)} tokens")
                self._admit()

    def cancel(self, rid: str, reason: str = "client disconnected") -> bool:
        """Drop the request ``rid`` wherever it is (waiting or in a slot),
        freeing its slot and pages for the next waiting request. True iff
        found. ``step`` holds the engine lock for a whole round (draft
        feeds, verify, acceptance and emission), so a cancel never frees
        pages a verify still writes. A running decode loop takes the lock
        back between rounds before a waiting thread can, so the cancel is
        handed to it and applied at the start of its next round; without
        a busy loop it is applied here."""
        if rid is None:
            return False
        done, box = threading.Event(), []
        self._cancels.append((rid, reason, done, box))
        while not done.wait(0.005):
            if self._lock.acquire(blocking=False):
                try:
                    self._apply_cancels()
                finally:
                    self._lock.release()
        return box[0]

    def _apply_cancels(self) -> None:
        """Apply the cancels handed over (lock held)."""
        while self._cancels:
            rid, reason, done, box = self._cancels.popleft()
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
            if req is not None:
                if self._m_cancelled is not None:
                    self._m_cancelled.inc()
                self._work.notify()
                req.future.set_exception(
                    RuntimeError(f"request {rid} cancelled: {reason}"))
                rt = _get_reqtracer()
                if rt is not None:
                    rt.finish(rid, "closed", error=reason)
            box.append(req is not None)
            done.set()

    # ---------------------------------------------------------------- step
    def step(self) -> int:
        """One batched decode step: every active slot emits one token, or,
        speculative, one round of 1 to K+1. Returns the number of slots
        advanced (0 = idle)."""
        with self._lock:
            self._last_beat = self.clock()
            self._apply_cancels()
            self._expire(self.clock())
            active = [i for i, r in enumerate(self._reqs) if r is not None]
            if not active:
                return 0
            if self.speculate:
                return self._step_spec(active)
            return self._step_plain(active)

    def _needs_warp(self, active) -> bool:
        return any(self._reqs[i].top_k > 0 or self._reqs[i].top_p < 1.0
                   for i in active)

    def _step_plain(self, active) -> int:
        with self._pool.work():
            # a device OOM (the KV cache, as a rule) writes its memory
            # report, then the step fails as before
            with _obs_mem.oom_guard("decode_step"):
                self._run(("step", self._needs_warp(active)))
            toks = self._toks.tolist()  # the step's one device-to-host copy
        if self._m_steps is not None:
            self._m_steps.inc()
        for i in active:
            self._pos[i] += 1
            self._emit(self._reqs[i], i, [toks[i]])
        return len(active)

    def _step_spec(self, active) -> int:
        """One speculative round: m draft steps (the pending feed, then
        m-1 proposals), one chunked verify with acceptance, and 1..m
        tokens emitted a slot; m = K+1 cut to the cache's tail."""
        K = self.speculate
        m = min(K + 1, self.max_len - max(int(self._pos[i]) for i in active))
        with self._pool.work():
            with _obs_mem.oom_guard("decode_step"):
                for _ in range(m):
                    self._run(("draft",))
                self._run(("verify", m))
            out = self._round.tolist()  # the round's one device-to-host copy
        if self._m_steps is not None:
            self._m_steps.inc()
            self._m_spec_prop.inc((m - 1) * len(active))
            self._m_spec_acc.inc(sum(out[i][K + 2] for i in active))
            self._m_draft_steps.inc(m * len(active))
        for i in active:
            n = out[i][K + 1]
            self._pos[i] += n
            self._emit(self._reqs[i], i, out[i][:n], accepted=out[i][K + 2])
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

    def _page_occupancy(self) -> float:
        """Live tokens (slots' positions and cached prefixes) over the
        tokens of the pages handed out."""
        live = int(sum(int(self._pos[i])
                       for i, r in enumerate(self._reqs) if r is not None))
        if self._pfx is not None:
            live += self._pfx.cached_tokens()
        cap = self._kv.alloc.pages_in_use * self.page_tokens
        return live / cap if cap else 0.0

    def debug_snapshot(self) -> dict:
        """The /debug/slots body: the slot table, the waiting queue's
        depth, ``speculate`` and, paged, the page pool's occupancy (the
        JAX package's keys, and ``quantize``; ``tp`` is 1)."""
        with self._lock:
            slots = [{"slot": i, "state": "free"} if req is None else
                     {"slot": i, "state": "active", "rid": req.rid,
                      "pos": int(self._pos[i]),
                      "prompt_tokens": len(req.tokens),
                      "tokens_out": len(req.out),
                      "max_new": req.max_new_tokens,
                      "pages": (len(self._kv.slot_pages[i]) if self.paged
                                else None)}
                     for i, req in enumerate(self._reqs)]
            out = {"slots": slots, "slots_total": self.slots,
                   "slots_active": sum(r is not None for r in self._reqs),
                   "waiting": len(self._waiting),
                   "max_waiting": self.max_waiting,
                   "speculate": self.speculate, "quantize": self.quantize,
                   "worker_up": self._worker_error is None, "tp": 1,
                   "kv": {"paged": self.paged}}
            if self.paged:
                out["kv"].update({
                    "page_tokens": self.page_tokens,
                    "pool_pages": self._kv.pool_pages,
                    "pages_in_use": self._kv.alloc.pages_in_use,
                    "free_pages": self._kv.alloc.free_pages,
                    "occupancy_frac": round(self._page_occupancy(), 4),
                    "allocated_bytes": self._kv.allocated_bytes(),
                    "bytes_per_page": self._kv.bytes_per_page})
        return out

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
        rt = _get_reqtracer()
        for req in dead:
            req.future.set_exception(err)
            if rt is not None and req.rid is not None:
                rt.finish(req.rid, "worker_dead", error=str(err))

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
        rt = _get_reqtracer()
        with self._lock:
            self._closed = True
            for req in self._waiting:
                req.future.set_exception(RuntimeError("decode engine closed"))
                if rt is not None and req.rid is not None:
                    rt.finish(req.rid, "closed")
            self._waiting.clear()
            for i, req in enumerate(self._reqs):
                if req is not None:
                    self._reqs[i] = None
                    req.future.set_exception(
                        RuntimeError("decode engine closed mid-request"))
                    if rt is not None and req.rid is not None:
                        rt.finish(req.rid, "closed")
            self._work.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        self.graphs.clear()


def abstract_decode_engine(model, *, slots: int = 4,
                           max_len: Optional[int] = None, cache_dtype=None,
                           kv_page_tokens: Optional[int] = None,
                           pool_pages: Optional[int] = None,
                           speculate: int = 0, tp: int = 1,
                           model_axis: str = "model",
                           quantize: Optional[str] = None, mesh=None):
    """A lintable :class:`DecodeEngine`: built, as the serving engine is,
    over a copy of ``model`` whose weights, caches and buffers are fake
    tensors (nothing allocated, no card), placed for tp over ``mesh`` (a
    ``model``-axis mesh; default the job's ranks, a fake process group in
    a lint) when ``tp`` > 1. ``whole_kv`` is the unsharded model's KV
    layout (meta tensors), for the head-split rule. Call
    ``trace_step_graph()`` on it; do not ``start()`` or ``submit()``: no
    state stands behind it."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.serving.sharding import (ServingSharding, TPLink,
                                                  serving_mesh)

    clone = fx_walk.meta_clone(model).eval()
    if max_len:
        clone.max_len = int(max_len)
    _, kv8 = _q.parse_quantize(quantize)
    link = None
    if int(tp) > 1:
        mesh = mesh if mesh is not None else serving_mesh(axis=model_axis)
        ServingSharding(mesh, axis=model_axis).place_params(clone)
        link = TPLink(mesh)
    mode = fx_walk.fake_mode()
    with mode, warnings.catch_warnings():
        # the engine's model.to() makes the meta weights fake; copying a
        # quantized model reads fake data pointers (never dereferenced)
        warnings.filterwarnings("ignore", "Accessing the data pointer")
        eng = DecodeEngine(clone, slots=slots, cache_dtype=cache_dtype,
                           device="cpu", kv_page_tokens=kv_page_tokens,
                           pool_pages=pool_pages, speculate=speculate,
                           quantize=quantize, graphs=False, tp=link)
    eng._fake_mode = mode
    whole = fx_walk.meta_clone(model)
    rows = eng._kv.pool_pages if eng.paged else eng.slots
    tokens = eng.page_tokens if eng.paged else eng.max_len
    eng.whole_kv = whole.encoder.init_cache(
        rows, tokens, torch.int8 if kv8 else eng.cache_dtype, "meta")
    return eng
