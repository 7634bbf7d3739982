"""Per-request serving observability (counterpart of
``bigdl_tpu/serving/reqtrace.py``): lifecycle tracing, server-side
TTFT/TPOT, SLO accounting, and a decode flight recorder.

A request id minted at admission (or a client's sanitized
``x-request-id``) is threaded through the micro-batcher, the bucketed
engine and the continuous-batching decoder, accumulating a lifecycle
record::

    admitted -> queued -> prefill -> decode round* -> finished
                                                   |  expired
                                                   |  shed / rejected
                                                   |  worker_dead ...

Each decode round notes the tokens emitted, speculative tokens accepted,
KV pages held and position; prefill notes the prefix-cache hit length
and slot. Completed records land in a bounded ring (the flight recorder)
with drop counting; derived latencies (TTFT, TPOT, per-token ITL, queue
wait, prefill, decode) publish into the metrics registry as histograms,
and each record joins the ``obs.spans`` timeline as back-dated ``req:*``
spans (category ``request``).

Policy hooks:

* :class:`SloPolicy` — ``--slo ttft=200,tpot=30``: per-request SLO
  evaluation into goodput / ``slo_violations_total`` counters plus a
  windowed burn rate the tiered shedder consults;
* :class:`AccessLog` — ``--accessLog`` / ``--logSample``: a sampled JSONL
  access log, one line per completed request, sampled by a hash of the
  request id, so reruns (and the JAX package) select the same requests.

With no tracer installed every hook is one global load and one ``None``
check. One lock guards the live table and the ring; hooks touch a few
scalars under it, never an engine call. The clock is injectable; when an
``obs`` tracer is installed the default clock is its clock, so joined
spans share its timebase.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from bigdl_tpu_torch.obs import spans as _spans
from bigdl_tpu_torch.obs.metrics import ITL_BUCKETS_MS

__all__ = ["RequestRecord", "RequestTracer", "SloPolicy", "AccessLog",
           "mint_rid", "sanitize_rid", "get_request_tracer",
           "set_request_tracer", "get"]

# terminal lifecycle states and the HTTP status each implies when the
# server layer never got to annotate one (decode-side terminations)
TERMINAL_STATES: Dict[str, int] = {
    "finished": 200,      # all tokens emitted / scores returned
    "expired": 504,       # deadline passed (queue or mid-decode)
    "shed": 429,          # tiered overload shed or SLO burn
    "rejected": 429,      # admission fast-reject (queue at capacity)
    "worker_dead": 503,   # batcher/decode worker died under the request
    "bad_request": 400,   # malformed payload
    "error": 500,         # engine raised
    "closed": 503,        # engine shut down with the request in flight
}

LIVE_STATES = ("admitted", "queued", "prefill", "decode")


# ------------------------------------------------------------- request ids
_RID_SEQ = itertools.count(1)
# pid-stamped prefix: ids stay unique across server restarts sharing an
# access log, without any randomness in the hot path
_RID_PREFIX = f"r{os.getpid() & 0xffff:04x}"


def mint_rid() -> str:
    """Mint a fresh request id (``r<pid16><seq>``); works with no tracer
    installed so ``x-request-id`` is echoed even with ``--reqTrace off``."""
    return f"{_RID_PREFIX}-{next(_RID_SEQ):06d}"


def sanitize_rid(raw) -> Optional[str]:
    """Validate a client-supplied ``x-request-id``: printable ASCII, no
    whitespace, at most 64 chars — anything else is discarded (a minted
    id replaces it) so ids are safe in headers, JSONL, and trace args."""
    if not isinstance(raw, str):
        return None
    rid = raw.strip()
    if not rid or len(rid) > 64:
        return None
    if any(c <= " " or c > "~" for c in rid):
        return None
    return rid


class RequestRecord:
    """One request's lifecycle: timestamps (seconds on the tracer's
    clock), decode-round ring, and terminal state.

    ``t_prefill0``/``t_prefill1`` bound the compute window — prefill for
    ``/generate``, the (possibly multi-flush) engine forward for
    ``/predict``."""

    __slots__ = ("rid", "endpoint", "state", "status",
                 "t_admit", "t_queue", "t_dequeue",
                 "t_prefill0", "t_prefill1",
                 "t_first_token", "t_first_byte", "t_last_token",
                 "t_finish",
                 "prompt_tokens", "max_new", "tokens_out",
                 "rounds", "round_count", "accepted_total",
                 "prefix_hit_tokens", "pages_held", "slot", "replica",
                 "error")

    def __init__(self, rid: str, endpoint: str, t_admit: float,
                 max_rounds: int = 64):
        self.rid = rid
        self.endpoint = endpoint
        self.state = "admitted"
        self.status: Optional[int] = None
        self.t_admit = t_admit
        self.t_queue: Optional[float] = None
        self.t_dequeue: Optional[float] = None
        self.t_prefill0: Optional[float] = None
        self.t_prefill1: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_first_byte: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.prompt_tokens: Optional[int] = None
        self.max_new: Optional[int] = None
        self.tokens_out = 0
        # last max_rounds decode rounds: (t, emitted, accepted, pages, pos)
        self.rounds: collections.deque = collections.deque(
            maxlen=max_rounds)
        self.round_count = 0
        self.accepted_total = 0
        self.prefix_hit_tokens = 0
        self.pages_held: Optional[int] = None
        self.slot: Optional[int] = None
        self.replica: Optional[int] = None
        self.error: Optional[str] = None

    # ------------------------------------------------- derived latencies
    def queue_wait_ms(self) -> Optional[float]:
        t0 = self.t_queue if self.t_queue is not None else self.t_admit
        t1 = self.t_dequeue
        if t1 is None:
            return None
        return max(t1 - t0, 0.0) * 1000.0

    def prefill_ms(self) -> Optional[float]:
        if self.t_prefill0 is None or self.t_prefill1 is None:
            return None
        return max(self.t_prefill1 - self.t_prefill0, 0.0) * 1000.0

    def decode_ms(self) -> Optional[float]:
        """Prefill end -> last token (0 for single-token / predict)."""
        if self.t_prefill1 is None or self.t_last_token is None:
            return None
        return max(self.t_last_token - self.t_prefill1, 0.0) * 1000.0

    def ttft_ms(self) -> Optional[float]:
        """Admission -> first token as FELT by the client: when the
        streaming handler stamped a first-byte-out time (``--stream``)
        that wins over the engine-side first-emit time, so SLO judgment
        covers the wire, not just the decode loop. For ``/predict``
        (scores, not tokens) the response-ready time stands in for
        token one."""
        t1 = self.t_first_byte
        if t1 is None:
            t1 = self.t_first_token
        if t1 is None and self.endpoint == "predict" \
                and self.state == "finished":
            t1 = self.t_finish
        if t1 is None:
            return None
        return max(t1 - self.t_admit, 0.0) * 1000.0

    def tpot_ms(self) -> Optional[float]:
        """Mean time per output token AFTER the first:
        ``(t_last - t_first) / (n - 1)``. None below two tokens."""
        if (self.t_first_token is None or self.t_last_token is None
                or self.tokens_out < 2):
            return None
        return max(self.t_last_token - self.t_first_token, 0.0) \
            * 1000.0 / (self.tokens_out - 1)

    def total_ms(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return max(self.t_finish - self.t_admit, 0.0) * 1000.0

    def to_dict(self, now: Optional[float] = None) -> dict:
        """JSON-safe rendering for /debug/requests and the access log."""
        d = {"rid": self.rid, "endpoint": self.endpoint,
             "state": self.state, "status": self.status,
             "prompt_tokens": self.prompt_tokens, "max_new": self.max_new,
             "tokens_out": self.tokens_out,
             "rounds": self.round_count,
             "accepted_tokens": self.accepted_total,
             "prefix_hit_tokens": self.prefix_hit_tokens,
             "pages_held": self.pages_held, "slot": self.slot,
             "queue_wait_ms": self.queue_wait_ms(),
             "prefill_ms": self.prefill_ms(),
             "decode_ms": self.decode_ms(),
             "ttft_ms": self.ttft_ms(), "tpot_ms": self.tpot_ms(),
             "total_ms": self.total_ms()}
        if self.replica is not None:
            d["replica"] = self.replica
        if self.error:
            d["error"] = self.error
        if now is not None and self.t_finish is None:
            d["age_ms"] = max(now - self.t_admit, 0.0) * 1000.0
        for k, v in list(d.items()):
            if isinstance(v, float):
                d[k] = round(v, 3)
        return d


class SloPolicy:
    """Server-side SLO targets and burn accounting.

    Spec grammar (``--slo``): comma-separated ``dim=value`` with latency
    dims in ms (``ttft``, ``tpot``) plus two policy knobs —
    ``burn=<frac>`` (windowed violation fraction above which the tiered
    shedder treats the server as overloaded; default 0.9) and
    ``window=<n>`` (requests in the burn window, default 32). A request
    is GOOD when every configured dim it exposes meets its target;
    requests that never produced a dim (e.g. a one-token generate has no
    TPOT) are judged on the dims they have."""

    DIMS = ("ttft", "tpot")
    MIN_BURN_SAMPLES = 8

    def __init__(self, targets: Dict[str, float], burn: float = 0.9,
                 window: int = 32):
        for k in targets:
            if k not in self.DIMS:
                raise ValueError(
                    f"unknown SLO dim {k!r} (have {self.DIMS})")
        if not targets:
            raise ValueError("SLO spec configured no dims")
        if not 0.0 < burn <= 1.0:
            raise ValueError(f"burn must be in (0, 1], got {burn}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.targets = dict(targets)
        self.burn = float(burn)
        self.window = int(window)
        self._lock = threading.Lock()
        self._recent: collections.deque = collections.deque(maxlen=window)
        self._evaluated = 0
        self._good = 0

    @classmethod
    def parse(cls, spec: str) -> "SloPolicy":
        targets: Dict[str, float] = {}
        burn, window = 0.9, 32
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad SLO term {part!r} (want dim=value)")
            k, v = part.split("=", 1)
            k = k.strip().lower()
            if k == "burn":
                burn = float(v)
            elif k == "window":
                window = int(v)
            else:
                ms = float(v)
                if ms <= 0:
                    raise ValueError(f"SLO target must be > 0: {part!r}")
                targets[k] = ms
        return cls(targets, burn=burn, window=window)

    def evaluate(self, rec: RequestRecord) -> List[str]:
        """Violated dims for one completed record (empty = good)."""
        violated = []
        for dim, target in self.targets.items():
            v = rec.ttft_ms() if dim == "ttft" else rec.tpot_ms()
            if v is not None and v > target:
                violated.append(dim)
        return violated

    def account(self, good: bool) -> None:
        with self._lock:
            self._recent.append(bool(good))
            self._evaluated += 1
            if good:
                self._good += 1

    def burn_rate(self) -> float:
        """Violation fraction over the sliding window (0 when empty)."""
        with self._lock:
            if not self._recent:
                return 0.0
            return 1.0 - sum(self._recent) / len(self._recent)

    def goodput_frac(self) -> float:
        with self._lock:
            return self._good / self._evaluated if self._evaluated else 1.0

    def should_shed(self) -> bool:
        """True when the windowed burn rate says the server is missing
        its SLOs badly enough that admitting more work only makes every
        in-flight request later — the tiered shedder (server.py)
        consults this alongside queue depth."""
        with self._lock:
            if len(self._recent) < self.MIN_BURN_SAMPLES:
                return False
            rate = 1.0 - sum(self._recent) / len(self._recent)
        return rate >= self.burn

    def describe(self) -> dict:
        return {"targets": dict(self.targets), "burn": self.burn,
                "window": self.window}


class AccessLog:
    """Sampled structured JSONL access log, one line per completed
    request.

    Sampling is DETERMINISTIC in the request id: a request is logged iff
    ``sha256(rid) / 2^64 < sample`` — reruns pick the same subset, and
    N replicas sharing id space log disjoint-free consistent samples
    (sampling keyed by the request id, not by a per-process RNG)."""

    def __init__(self, path: str, sample: float = 1.0):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.path = path
        self.sample = float(sample)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self.lines = 0
        self.sampled_out = 0

    def sampled(self, rid: str) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = hashlib.sha256(rid.encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < self.sample

    def write(self, rec_dict: dict) -> bool:
        rid = rec_dict.get("rid", "")
        if not self.sampled(rid):
            with self._lock:
                self.sampled_out += 1
            return False
        line = json.dumps(rec_dict, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self.lines += 1
        return True

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:
                pass


class RequestTracer:
    """The flight recorder: live in-flight table + bounded ring of
    completed :class:`RequestRecord`, metric derivation on completion,
    optional SLO/access-log policies, and Chrome-trace join.

    Hot-loop hooks (``note_*``) tolerate unknown rids (a request
    admitted before the tracer was installed, or a None rid threaded
    through) by doing nothing — instrumentation must never fail a
    request."""

    def __init__(self, capacity: int = 1024,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, slo: Optional[SloPolicy] = None,
                 access_log: Optional[AccessLog] = None,
                 max_rounds: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if clock is None:
            obs = _spans.get_tracer()
            clock = obs.clock if obs is not None else time.perf_counter
        self.clock = clock
        self.capacity = int(capacity)
        self.max_rounds = int(max_rounds)
        self.slo = slo
        self.access_log = access_log
        self._lock = threading.Lock()
        self._live: Dict[str, RequestRecord] = {}
        # completed records, oldest first; _done_index mirrors it so a
        # late status annotation (server thread, after the decode loop
        # already finished the record) still finds its record
        self._done: collections.deque = collections.deque()
        self._done_index: Dict[str, RequestRecord] = {}
        self.dropped = 0

        if metrics is not None:
            self._h_ttft = metrics.histogram(
                "ttft_ms", "server-side time to first token",
                bounds=ITL_BUCKETS_MS)
            self._h_tpot = metrics.histogram(
                "tpot_ms", "server-side mean time per output token",
                bounds=ITL_BUCKETS_MS)
            self._h_itl = metrics.histogram(
                "itl_ms", "server-side inter-token latency",
                bounds=ITL_BUCKETS_MS)
            self._h_queue = metrics.histogram(
                "request_queue_wait_ms", "per-request queue wait")
            self._h_prefill = metrics.histogram(
                "request_prefill_ms", "per-request prefill/compute time")
            self._h_decode = metrics.histogram(
                "request_decode_ms", "per-request decode time")
            self._h_total = metrics.histogram(
                "request_total_ms", "per-request admission -> terminal")
            # "requests_state_*" (not "requests_*"): the server already
            # owns requests_expired_total / requests_shed_total /
            # requests_worker_dead_total and the registry dedups by
            # name, so reusing those names would double-count
            self._c_finished = {
                st: metrics.counter(
                    f"requests_state_{st}_total",
                    f"requests that terminated {st} (lifecycle tracer)")
                for st in TERMINAL_STATES}
            self._c_dropped = metrics.counter(
                "reqtrace_records_dropped_total",
                "completed lifecycle records evicted from the ring")
            metrics.gauge("reqtrace_in_flight",
                          "requests currently holding a live record",
                          fn=lambda: len(self._live))
            if slo is not None:
                self._c_slo_req = metrics.counter(
                    "slo_requests_total", "requests evaluated against SLO")
                self._c_slo_good = metrics.counter(
                    "slo_good_total", "requests that met every SLO dim")
                self._c_slo_viol = metrics.counter(
                    "slo_violations_total",
                    "requests that missed at least one SLO dim")
                self._c_slo_dim = {
                    dim: metrics.counter(
                        f"slo_{dim}_violations_total",
                        f"requests that missed the {dim} target")
                    for dim in slo.targets}
                metrics.gauge("slo_goodput_frac",
                              "lifetime fraction of requests meeting SLO",
                              fn=slo.goodput_frac)
                metrics.gauge("slo_burn_rate",
                              "windowed SLO violation fraction",
                              fn=slo.burn_rate)
            if access_log is not None:
                metrics.gauge("access_log_lines",
                              "access-log lines written",
                              fn=lambda: self.access_log.lines)
                metrics.gauge("access_log_sampled_out",
                              "completed requests the sampler skipped",
                              fn=lambda: self.access_log.sampled_out)
        else:
            self._h_ttft = self._h_tpot = self._h_itl = None
            self._h_queue = self._h_prefill = self._h_decode = None
            self._h_total = None
            self._c_finished = {}
            self._c_dropped = None
        if slo is None or metrics is None:
            self._c_slo_req = self._c_slo_good = self._c_slo_viol = None
            self._c_slo_dim = {}

    # -------------------------------------------------------- lifecycle
    def admit(self, endpoint: str, rid: Optional[str] = None,
              prompt_tokens: Optional[int] = None,
              max_new: Optional[int] = None) -> str:
        """Open a lifecycle record; returns the (possibly minted) rid."""
        if rid is None:
            rid = mint_rid()
        rec = RequestRecord(rid, endpoint, self.clock(),
                            max_rounds=self.max_rounds)
        rec.prompt_tokens = prompt_tokens
        rec.max_new = max_new
        with self._lock:
            self._live[rid] = rec
        return rid

    def _rec(self, rid: Optional[str]) -> Optional[RequestRecord]:
        if rid is None:
            return None
        return self._live.get(rid)

    def note_replica(self, rid: Optional[str], replica: int) -> None:
        """Which engine replica serves this request (a dp routing
        decision, stamped before submit)."""
        with self._lock:
            rec = self._rec(rid)
            if rec is not None:
                rec.replica = int(replica)

    def note_queued(self, rid: Optional[str]) -> None:
        """Request entered a queue (batcher pending / decode waiting).
        First call wins: a /predict fanned out over N rows queues once."""
        with self._lock:
            rec = self._rec(rid)
            if rec is not None and rec.t_queue is None:
                rec.t_queue = self.clock()
                if rec.state == "admitted":
                    rec.state = "queued"

    def note_dequeued(self, rid: Optional[str]) -> None:
        """Request left the queue toward compute (batch drain / slot
        install). Last call wins: queue wait covers the slowest row."""
        with self._lock:
            rec = self._rec(rid)
            if rec is not None:
                rec.t_dequeue = self.clock()

    def note_compute(self, rid: Optional[str], t0: float,
                     t1: float) -> None:
        """An engine forward covered this request (possibly one of
        several chunks): widen the compute window."""
        with self._lock:
            rec = self._rec(rid)
            if rec is None:
                return
            if rec.t_prefill0 is None or t0 < rec.t_prefill0:
                rec.t_prefill0 = t0
            if rec.t_prefill1 is None or t1 > rec.t_prefill1:
                rec.t_prefill1 = t1
            if rec.state in ("admitted", "queued"):
                rec.state = "prefill"

    def note_prefill(self, rid: Optional[str], t0: float, t1: float,
                     slot: Optional[int] = None,
                     prefix_hit_tokens: int = 0,
                     pages: Optional[int] = None) -> None:
        """Decode-path prefill finished: the request owns a slot."""
        with self._lock:
            rec = self._rec(rid)
            if rec is None:
                return
            if rec.t_dequeue is None:
                rec.t_dequeue = t0
            rec.t_prefill0, rec.t_prefill1 = t0, t1
            rec.slot = slot
            rec.prefix_hit_tokens = int(prefix_hit_tokens)
            if pages is not None:
                rec.pages_held = int(pages)
            rec.state = "decode"

    def note_first_byte(self, rid: Optional[str]) -> None:
        """Streaming handler wrote the first response byte for this
        request (chunked ``/generate``). First call wins; the derived
        TTFT prefers this over the engine-emit time so ``--slo`` judges
        streamed traffic on felt latency."""
        with self._lock:
            rec = self._rec(rid)
            if rec is not None and rec.t_first_byte is None:
                rec.t_first_byte = self.clock()

    def note_round(self, rid: Optional[str], emitted: int,
                   accepted: Optional[int] = None,
                   pages: Optional[int] = None,
                   pos: Optional[int] = None) -> None:
        """One decode round emitted ``emitted`` tokens for this request
        (1 on the plain path; up to k+1 speculative). ``accepted`` is
        the draft tokens the target kept this round."""
        if emitted <= 0:
            return
        itl_obs = None
        with self._lock:
            rec = self._rec(rid)
            if rec is None:
                return
            t = self.clock()
            prev = rec.t_last_token
            if rec.t_first_token is None:
                rec.t_first_token = t
            rec.t_last_token = t
            rec.tokens_out += emitted
            rec.round_count += 1
            if accepted is not None:
                rec.accepted_total += accepted
            if pages is not None:
                rec.pages_held = int(pages)
            rec.rounds.append((t, int(emitted), accepted, pages, pos))
            rec.state = "decode"
            if prev is not None and self._h_itl is not None:
                # a k-token round contributes k samples of the mean
                # inter-token gap it realized — per-token ITL, not
                # per-round latency
                itl_obs = ((t - prev) * 1000.0 / emitted, emitted)
        if itl_obs is not None:
            gap, n = itl_obs
            for _ in range(n):
                self._h_itl.observe(gap)

    # -------------------------------------------------------- completion
    def finish(self, rid: Optional[str], state: str,
               status: Optional[int] = None,
               error: Optional[str] = None) -> None:
        """Terminalize the record: stamp ``t_finish``, publish derived
        histograms, evaluate SLO, write the access log, join the obs
        timeline, and move the record into the ring. Idempotent — a
        second finish (server annotating HTTP status after the decode
        loop already finished the record) only fills in ``status``."""
        if rid is None or state not in TERMINAL_STATES:
            return
        with self._lock:
            rec = self._live.pop(rid, None)
            if rec is None:
                done = self._done_index.get(rid)
                if done is not None and status is not None \
                        and done.status is None:
                    done.status = int(status)
                return
            rec.state = state
            rec.status = int(status) if status is not None \
                else TERMINAL_STATES[state]
            rec.error = error
            rec.t_finish = self.clock()
            self._done.append(rec)
            self._done_index[rid] = rec
            while len(self._done) > self.capacity:
                old = self._done.popleft()
                self._done_index.pop(old.rid, None)
                self.dropped += 1
                if self._c_dropped is not None:
                    self._c_dropped.inc()
        self._publish(rec)

    def _publish(self, rec: RequestRecord) -> None:
        c = self._c_finished.get(rec.state)
        if c is not None:
            c.inc()
        if self._h_total is not None:
            for h, v in ((self._h_ttft, rec.ttft_ms()),
                         (self._h_tpot, rec.tpot_ms()),
                         (self._h_queue, rec.queue_wait_ms()),
                         (self._h_prefill, rec.prefill_ms()),
                         (self._h_decode, rec.decode_ms()),
                         (self._h_total, rec.total_ms())):
                if v is not None:
                    h.observe(v)
        if self.slo is not None and rec.state == "finished":
            violated = self.slo.evaluate(rec)
            self.slo.account(not violated)
            if self._c_slo_req is not None:
                self._c_slo_req.inc()
                if violated:
                    self._c_slo_viol.inc()
                    for dim in violated:
                        d = self._c_slo_dim.get(dim)
                        if d is not None:
                            d.inc()
                else:
                    self._c_slo_good.inc()
        if self.access_log is not None:
            self.access_log.write(rec.to_dict())
        self._join_obs(rec)

    def _join_obs(self, rec: RequestRecord) -> None:
        """Back-date the record's phases onto the obs.spans timeline as
        ``req:*`` spans (category ``request``) keyed by rid — one slow
        request renders against the batcher/engine spans that served
        it. Skipped when the obs tracer runs a different clock (the
        timebases would not line up)."""
        tr = _spans.get_tracer()
        if tr is None or tr.clock is not self.clock:
            return
        args = {"rid": rec.rid, "state": rec.state}
        t_q0 = rec.t_queue if rec.t_queue is not None else rec.t_admit
        phases = (("req:queue_wait", t_q0, rec.t_dequeue),
                  ("req:prefill", rec.t_prefill0, rec.t_prefill1),
                  ("req:decode", rec.t_prefill1, rec.t_last_token))
        tr.record(f"req:{rec.endpoint}", rec.t_admit,
                  rec.t_finish, depth=0,
                  args={**args, "tokens_out": rec.tokens_out},
                  cat="request")
        for name, t0, t1 in phases:
            if t0 is not None and t1 is not None and t1 > t0:
                tr.record(name, t0, t1, depth=1, args=args,
                          cat="request")

    # --------------------------------------------------------- inspection
    def in_flight(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._live.values())

    def recent(self, n: Optional[int] = None) -> List[RequestRecord]:
        """Most-recent-last completed records (up to ``n``)."""
        with self._lock:
            recs = list(self._done)
        return recs if n is None else recs[-n:]

    def snapshot(self, recent: int = 32) -> dict:
        """The /debug/requests JSON."""
        now = self.clock()
        with self._lock:
            live = [r.to_dict(now) for r in self._live.values()]
            done = [r.to_dict() for r in
                    list(self._done)[-max(recent, 0):]]
            dropped = self.dropped
        live.sort(key=lambda d: d["rid"])
        out = {"enabled": True, "now": round(now, 6),
               "in_flight": live, "recent": done,
               "completed_retained": len(done), "dropped": dropped,
               "capacity": self.capacity}
        if self.slo is not None:
            out["slo"] = {**self.slo.describe(),
                          "burn_rate": round(self.slo.burn_rate(), 4),
                          "goodput_frac":
                              round(self.slo.goodput_frac(), 4),
                          "shedding": self.slo.should_shed()}
        return out

    def close(self) -> None:
        if self.access_log is not None:
            self.access_log.close()


# ------------------------------------------------------------ module global
_TRACER: Optional[RequestTracer] = None


def get() -> Optional[RequestTracer]:
    """The hot-path hook: one global load. ``None`` means ``--reqTrace
    off`` — callers do their single ``None`` check and touch nothing."""
    return _TRACER


get_request_tracer = get


def set_request_tracer(tracer: Optional[RequestTracer]) -> None:
    """Install (or clear, with None) the process-global request
    tracer."""
    global _TRACER
    _TRACER = tracer
