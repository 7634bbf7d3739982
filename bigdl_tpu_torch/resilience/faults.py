"""Deterministic, seeded fault injection (counterpart of
``bigdl_tpu/resilience/faults.py``): a fault *plan*, parsed from a
``--faultPlan`` spec string or JSON file, fires simulated faults at
instrumented sites.

Sites (each instrumented call is one *visit*; counters are per-process):

* ``data``, ``step``, ``ckpt_save``, ``ckpt_restore`` — the training
  sites; their kinds parse, and the port's training loop does not call
  them yet;
* ``infer``        — one per serving engine forward
  (``InferenceEngine.predict_scores``);
* ``request``      — one per HTTP request dispatched
  (``ServingApp.dispatch_post`` and a streamed ``/generate``'s
  admission);
* ``worker_boot``  — one per fleet worker process start.

Kinds:

* ``preempt``      — process-fatal: logs the event, then
  ``os._exit(75)`` (EX_TEMPFAIL); only a supervising parent (the fleet
  router, ``supervise_command``) recovers;
* ``preempt_soft`` — raises :class:`SimulatedPreemption`;
* ``dispatch``     — raises :class:`TransientFault` (HTTP 503 on the
  request path);
* ``io``           — raises ``OSError``;
* ``corrupt``      — after an artifact and its checksum sidecar are
  written, flips bytes in the blob (:func:`post_write_hook`);
* ``stall``        — sleeps ``arg`` seconds;
* ``worker_kill``  — raises :class:`WorkerKillFault`
  (``worker_fatal=True``): serving worker threads die of it, which the
  watchdog turns into fast 503s;
* ``kill_device``  — marks ``arg`` CUDA devices (default 1, from the
  tail of the healthy roster) lost process-wide and raises
  :class:`DeviceLossFault`.

Everything is a no-op unless a plan is installed (``install_plan``): the
inactive hook is one global load and a ``None`` check.

Determinism: probabilistic rules (``p0.05``) decide per visit by a
SHA-256 hash of ``(seed, site, visit)`` (:func:`_u01`), so one seed
gives the JAX package's schedule, with no shared RNG.

Stated difference: :func:`healthy_devices` and
:func:`lost_device_ids` count CUDA device indices
(``range(torch.cuda.device_count())``) where the JAX package counts
``jax.devices()`` ids.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "FAULT_SITES", "FAULT_KINDS", "PREEMPT_RC", "ChecksumError",
    "DeviceLossFault", "FaultPlan", "FaultRule", "FaultInjector",
    "SimulatedPreemption", "TransientFault", "WorkerKillFault", "active",
    "clear_plan", "healthy_devices", "hook", "injected_events",
    "install_plan", "lost_device_ids", "parse_plan", "post_write_hook",
    "restore_devices",
]

FAULT_SITES = ("data", "step", "ckpt_save", "ckpt_restore", "infer",
               "request", "worker_boot")
FAULT_KINDS = ("preempt", "preempt_soft", "dispatch", "io", "corrupt",
               "stall", "worker_kill", "kill_device")

# EX_TEMPFAIL: the rc a simulated preemption dies with — supervising
# parents treat exactly this as "retry with resume" (a real crash keeps
# its own rc and is NOT retried blindly)
PREEMPT_RC = 75


class TransientFault(RuntimeError):
    """Retryable transient failure (simulated dispatch/device_put error)."""


class SimulatedPreemption(RuntimeError):
    """In-process stand-in for a preemption: retryable under
    supervision, fatal without (the ``preempt`` kind skips even this and
    ``os._exit``\\ s — only a parent process can catch that one)."""


class WorkerKillFault(RuntimeError):
    """Fatal-to-the-worker-thread failure: serving workers propagate it
    (after failing the in-flight batch) instead of swallowing it, so the
    dead-worker detection path can be exercised end to end."""

    worker_fatal = True


class ChecksumError(ValueError):
    """Checkpoint blob does not match its checksum sidecar (torn write
    or bit-rot). Defined here — next to the fault that causes it — so
    ``utils/file`` and the supervisor's retryable set share one type
    without an import cycle."""


class DeviceLossFault(RuntimeError):
    """Simulated loss of one or more devices. Retryable only under an
    elastic supervisor (the plain supervisor would rebuild the same
    topology and trip over the missing devices again, so it does not
    list this type). The injector marks the victims in
    :data:`_LOST_DEVICE_IDS` before raising; :func:`healthy_devices` is
    the survivors' roster."""


# CUDA device indices the kill_device fault has "lost" in this process;
# clear_plan() heals them: no plan, no simulated losses
_LOST_DEVICE_IDS: set = set()


def _device_ids() -> list:
    import torch

    return list(range(torch.cuda.device_count()))


def lost_device_ids() -> set:
    return set(_LOST_DEVICE_IDS)


def healthy_devices() -> list:
    """The CUDA device indices still usable after injected losses, in
    order."""
    return [d for d in _device_ids() if d not in _LOST_DEVICE_IDS]


def restore_devices() -> None:
    """Forget all simulated device losses (tests; also part of
    :func:`clear_plan`)."""
    _LOST_DEVICE_IDS.clear()


def _u01(seed: int, tag: str, n: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, tag, n) — a pure
    function, so fault schedules and backoff jitter never depend on
    draw order or anyone else's RNG use."""
    h = hashlib.sha256(f"{seed}:{tag}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultRule:
    """One line of a plan: fire ``kind`` at ``site`` on explicit visit
    numbers (``at``) or per-visit with probability ``rate``."""

    __slots__ = ("kind", "site", "at", "rate", "arg")

    def __init__(self, kind: str, site: str,
                 at: Optional[Sequence[int]] = None,
                 rate: Optional[float] = None, arg: Optional[str] = None):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(kinds: {', '.join(FAULT_KINDS)})")
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(sites: {', '.join(FAULT_SITES)})")
        if (at is None) == (rate is None):
            raise ValueError(f"{kind}@{site}: exactly one of explicit "
                             f"visits or a pNNN rate is required")
        self.kind, self.site, self.arg = kind, site, arg
        self.at = frozenset(int(n) for n in at) if at is not None else None
        self.rate = float(rate) if rate is not None else None

    def fires(self, n: int, seed: int) -> bool:
        if self.at is not None:
            return n in self.at
        return _u01(seed, f"{self.kind}@{self.site}", n) < self.rate

    def __repr__(self):
        tgt = (",".join(str(n) for n in sorted(self.at))
               if self.at is not None else f"p{self.rate}")
        a = f":{self.arg}" if self.arg is not None else ""
        return f"{self.kind}@{self.site}:{tgt}{a}"


class FaultPlan:
    """An ordered rule list + the seed that fixes probabilistic rules."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)

    def rules_for(self, site: str) -> List[FaultRule]:
        return [r for r in self.rules if r.site == site]

    def schedule(self, site: str, horizon: int) -> List[tuple]:
        """The (visit, kind) pairs that would fire over ``horizon``
        visits of ``site``: a pure preview of what a plan injects."""
        out = []
        for n in range(1, horizon + 1):
            for r in self.rules_for(site):
                if r.fires(n, self.seed):
                    out.append((n, r.kind))
        return out

    def __repr__(self):
        return ";".join(repr(r) for r in self.rules) + f";seed={self.seed}"


def parse_plan(spec: str) -> FaultPlan:
    """Parse ``--faultPlan``. Two spellings:

    * inline spec — ``;``-separated entries
      ``kind@site:VISITS[:ARG]`` where VISITS is ``3`` / ``3,7`` /
      ``p0.05`` (per-visit probability), plus an optional ``seed=N``
      entry: ``"preempt@step:7"``,
      ``"dispatch@step:p0.1;stall@step:4:0.25;seed=3"``;
    * a path to a JSON file: ``{"seed": 3, "rules": [{"kind": ...,
      "site": ..., "at": [3, 7] | "rate": 0.05, "arg": ...}]}``.
    """
    spec = spec.strip()
    if os.path.isfile(spec):
        with open(spec) as f:
            doc = json.load(f)
        rules = [FaultRule(r["kind"], r["site"], at=r.get("at"),
                           rate=r.get("rate"), arg=r.get("arg"))
                 for r in doc.get("rules", [])]
        return FaultPlan(rules, seed=doc.get("seed", 0))
    rules, seed = [], 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        try:
            kind, rest = entry.split("@", 1)
            site, _, tail = rest.partition(":")
            if not tail:
                raise ValueError("missing visit spec")
            visits, _, arg = tail.partition(":")
            at, rate = None, None
            if visits.startswith("p"):
                rate = float(visits[1:])
            else:
                at = [int(t) for t in visits.split(",") if t]
            rules.append(FaultRule(kind.strip(), site.strip(), at=at,
                                   rate=rate, arg=arg or None))
        except ValueError as e:
            raise ValueError(
                f"bad --faultPlan entry {entry!r}: {e} (expected "
                f"kind@site:VISITS[:ARG], e.g. preempt@step:7 or "
                f"dispatch@step:p0.05)") from None
    return FaultPlan(rules, seed=seed)


def corrupt_file(path: str, seed: int = 0) -> None:
    """Flip a run of bytes in the middle of ``path`` in place (local
    files only — the simulated bit-rot target). Deterministic per
    (path basename, seed)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    off = int(_u01(seed, os.path.basename(path), 1) * max(size - 8, 1))
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(8)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


class FaultInjector:
    """Counts visits per site, fires matching rules, records every
    fired fault as a structured event (and optionally appends it as a
    JSON line to ``log_path`` — written BEFORE process-fatal kinds act,
    so even an ``os._exit`` preemption leaves its evidence)."""

    def __init__(self, plan: FaultPlan, *, log_path: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 exit_fn: Callable[[int], None] = os._exit):
        self.plan = plan
        self.log_path = log_path
        self.events: List[dict] = []
        self.counts: Dict[str, int] = {}
        self._sleep = sleep
        self._exit = exit_fn

    # ------------------------------------------------------------ recording
    def _record(self, site: str, visit: int, rule: FaultRule,
                action: str) -> dict:
        ev = {"fault": rule.kind, "site": site, "visit": visit,
              "action": action}
        if rule.arg is not None:
            ev["arg"] = rule.arg
        self.events.append(ev)
        try:  # the process registry's fault counter, scrapable live
            from bigdl_tpu_torch.obs.metrics import get_registry
            get_registry().counter(
                "faults_injected_total",
                "faults fired by the installed --faultPlan").inc()
        except Exception:
            pass  # observability must never change fault semantics
        try:  # a marker at the injection's position on the span timeline
            from bigdl_tpu_torch.obs.spans import instant
            instant(f"fault:{rule.kind}", site=site, visit=visit,
                    action=action)
        except Exception:
            pass
        if self.log_path:
            # append + close per event: survives os._exit on the next line
            with open(self.log_path, "a") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return ev

    # --------------------------------------------------------------- firing
    def fire(self, site: str) -> None:
        """One visit of ``site``: bump the counter, act on every
        matching rule (``corrupt`` is deferred to :meth:`post_write` —
        there is nothing to corrupt before the artifact exists)."""
        n = self.counts[site] = self.counts.get(site, 0) + 1
        for rule in self.plan.rules_for(site):
            if rule.kind == "corrupt" or not rule.fires(n, self.plan.seed):
                continue
            self._act(rule, site, n)

    def _act(self, rule: FaultRule, site: str, n: int) -> None:
        kind = rule.kind
        if kind == "preempt":
            self._record(site, n, rule, f"os._exit({PREEMPT_RC})")
            self._exit(PREEMPT_RC)
            return  # only reached with an injected exit_fn (tests)
        if kind == "preempt_soft":
            self._record(site, n, rule, "raise SimulatedPreemption")
            raise SimulatedPreemption(
                f"injected preemption at {site} visit {n}")
        if kind == "dispatch":
            self._record(site, n, rule, "raise TransientFault")
            raise TransientFault(
                f"injected transient dispatch failure at {site} visit {n}")
        if kind == "io":
            self._record(site, n, rule, "raise OSError")
            raise OSError(f"injected I/O failure at {site} visit {n}")
        if kind == "worker_kill":
            self._record(site, n, rule, "raise WorkerKillFault")
            raise WorkerKillFault(
                f"injected worker-fatal failure at {site} visit {n}")
        if kind == "kill_device":
            k = int(rule.arg or 1)
            alive = healthy_devices()
            victims = alive[-k:] if 0 < k < len(alive) else alive[1:]
            for d in victims:
                _LOST_DEVICE_IDS.add(d)
            survivors = len(alive) - len(victims)
            self._record(site, n, rule,
                         f"kill {len(victims)} device(s) -> "
                         f"{survivors} healthy")
            raise DeviceLossFault(
                f"injected loss of {len(victims)} device(s) at {site} "
                f"visit {n}; {survivors} healthy device(s) remain")
        if kind == "stall":
            secs = float(rule.arg or 0.1)
            self._record(site, n, rule, f"stall {secs}s")
            self._sleep(secs)

    def post_write(self, site: str, path: str) -> None:
        """Corruption pass for the artifact just written at the CURRENT
        visit of ``site`` (the checksum sidecar is already on disk, so
        the damage is detectable — exactly the bit-rot scenario)."""
        n = self.counts.get(site, 0)
        for rule in self.plan.rules_for(site):
            if rule.kind != "corrupt" or not rule.fires(n, self.plan.seed):
                continue
            if "://" in path or not os.path.isfile(path):
                continue  # local blobs only
            corrupt_file(path, self.plan.seed)
            self._record(site, n, rule, f"corrupted {path}")


# ------------------------------------------------------------- global hook
_ACTIVE: Optional[FaultInjector] = None


def install_plan(plan: FaultPlan, *, log_path: Optional[str] = None
                 ) -> FaultInjector:
    """Activate a plan process-wide; returns the injector (its
    ``events`` list is what supervisors stamp into result JSON)."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan, log_path=log_path)
    return _ACTIVE


def clear_plan() -> None:
    global _ACTIVE
    _ACTIVE = None
    restore_devices()  # no plan, no simulated device losses


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def hook(site: str) -> None:
    """The instrumented-site entry point: a no-op (one global load, one
    ``None`` check) unless a plan is installed."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site)


def post_write_hook(site: str, path: str) -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.post_write(site, path)


def injected_events() -> List[dict]:
    """Snapshot of every fault fired so far in this process (empty when
    no plan is active) — merged into supervisor annotations."""
    inj = _ACTIVE
    return list(inj.events) if inj is not None else []
