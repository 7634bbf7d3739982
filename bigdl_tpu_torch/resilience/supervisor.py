"""Supervised recovery: retry with backoff (counterpart of
``bigdl_tpu/resilience/supervisor.py``).

:class:`RetryPolicy` is exponential backoff with deterministic jitter
and a bounded budget; the fleet router restarts dead workers under it.
A :class:`Supervisor` wraps one attempt callable: it catches retryable
faults (transient dispatch errors, I/O errors, checksum mismatches, soft
preemptions; anything else propagates), sleeps the policy's backoff
(clock and sleep are injectable, so the sequence is a pure function of
(seed, attempt)), gives up past the budget (:class:`SupervisorGaveUp`),
and records every fault and recovery as structured events.

For process-fatal faults (the ``preempt`` kind ``os._exit``) there is
:func:`supervise_command`: the same policy applied to a child process,
restarted while it dies with ``PREEMPT_RC``. The training loop's
wiring (``--supervise``) is not ported yet.
"""

from __future__ import annotations

import logging
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.obs.spans import span as _obs_span
from bigdl_tpu_torch.resilience.faults import (ChecksumError, PREEMPT_RC,
                                         SimulatedPreemption,
                                         TransientFault, _u01,
                                         injected_events)

logger = logging.getLogger(__name__)

__all__ = ["RETRYABLE_EXCEPTIONS", "RetryPolicy", "Supervisor",
           "SupervisorGaveUp", "supervise_command"]

# What a supervisor may retry: simulated/infrastructure failures, never
# program bugs. OSError covers checkpoint I/O (including the injected
# `io` kind); ChecksumError is a corrupt snapshot discovered at restore
# (the NEXT attempt's latest_valid_checkpoint_pair skips it).
RETRYABLE_EXCEPTIONS = (TransientFault, SimulatedPreemption, OSError,
                        ChecksumError)


class SupervisorGaveUp(RuntimeError):
    """Retry budget exhausted; ``events`` carries the full fault log."""

    def __init__(self, msg: str, events: List[dict]):
        super().__init__(msg)
        self.events = events


class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``delay(attempt)`` = ``min(base * multiplier**(attempt-1), max)``
    scaled by ``1 + jitter * u`` where ``u`` is the hash-uniform of
    (seed, attempt) — reproducible under test, decorrelated across
    supervisors with different seeds (the thundering-herd fix real
    preemption storms need)."""

    def __init__(self, budget: int = 5, base_s: float = 0.5,
                 multiplier: float = 2.0, max_s: float = 30.0,
                 jitter: float = 0.5, seed: int = 0):
        if budget < 0:
            raise ValueError(f"retry budget must be >= 0, got {budget}")
        self.budget = int(budget)
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_s * self.multiplier ** (attempt - 1), self.max_s)
        return d * (1.0 + self.jitter * _u01(self.seed, "backoff", attempt))


class Supervisor:
    """Run an attempt callable under the retry policy.

    ``attempt_fn(attempt)`` is called with the 0-based attempt number
    (0 = first try; > 0 means "you are a retry — resume"). ``clock``
    and ``sleep`` are injectable for deterministic tests.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None, *,
                 retryable: Tuple = RETRYABLE_EXCEPTIONS,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 name: str = "train"):
        self.policy = policy or RetryPolicy()
        self.retryable = retryable
        self.clock = clock
        self.sleep = sleep
        self.name = name
        self.events: List[dict] = []
        self.attempts = 0
        self._t0: Optional[float] = None

    # ----------------------------------------------------------------- run
    def run(self, attempt_fn: Callable[[int], object]):
        self._t0 = self.clock()
        retries = 0
        while True:
            self.attempts += 1
            try:
                with _obs_span("supervisor_attempt",
                               attempt=self.attempts):
                    result = attempt_fn(self.attempts - 1)
            except self.retryable as e:
                retries += 1
                self.events.append({
                    "event": "fault", "attempt": self.attempts,
                    "error": f"{type(e).__name__}: {e}"[:300],
                    "t_s": round(self.clock() - self._t0, 3)})
                if retries > self.policy.budget:
                    self.events.append({"event": "gave_up",
                                        "retries": retries - 1})
                    logger.error(
                        "supervisor[%s]: retry budget (%d) exhausted "
                        "after %s", self.name, self.policy.budget, e)
                    raise SupervisorGaveUp(
                        f"retry budget ({self.policy.budget}) exhausted; "
                        f"last fault: {type(e).__name__}: {e}",
                        self.annotation()["events"]) from e
                d = self.policy.delay(retries)
                self.events.append({"event": "retry", "attempt": retries,
                                    "backoff_s": round(d, 3),
                                    "action": "resume from newest valid "
                                              "checkpoint"})
                try:  # the process registry's retry counter
                    from bigdl_tpu_torch.obs.metrics import get_registry
                    get_registry().counter(
                        "supervisor_retries_total",
                        "supervised retries after retryable "
                        "faults").inc()
                except Exception:
                    pass  # never let observability break recovery
                logger.warning(
                    "supervisor[%s]: %s: %s — retry %d/%d in %.2fs",
                    self.name, type(e).__name__, e, retries,
                    self.policy.budget, d)
                self.sleep(d)
                continue
            if retries:
                self.events.append({"event": "recovered",
                                    "after_retries": retries})
                logger.info("supervisor[%s]: recovered after %d "
                            "retr%s", self.name, retries,
                            "y" if retries == 1 else "ies")
            return result

    # ------------------------------------------------------------ reporting
    def annotation(self) -> dict:
        """The structured fault/recovery log for result JSON: supervisor
        events interleaved with everything the injector fired in this
        process (one list, chronologically grouped by source)."""
        retries = sum(1 for e in self.events if e.get("event") == "retry")
        return {
            "attempts": self.attempts,
            "retries": retries,
            "budget": self.policy.budget,
            "gave_up": any(e.get("event") == "gave_up"
                           for e in self.events),
            "events": injected_events() + self.events,
        }


def supervise_command(make_argv: Callable[[int], Sequence[str]], *,
                      policy: Optional[RetryPolicy] = None,
                      retryable_rcs: Tuple[int, ...] = (PREEMPT_RC,),
                      sleep: Callable[[float], None] = time.sleep,
                      env: Optional[dict] = None,
                      cwd: Optional[str] = None) -> Tuple[int, List[dict]]:
    """Cross-process supervision: run ``make_argv(attempt)`` as a child,
    restarting (with the same backoff policy) while it exits with a
    retryable rc — by default exactly ``PREEMPT_RC``, the code the
    ``preempt`` fault kind dies with. Any other nonzero rc is a real
    failure and is returned immediately. Returns ``(rc, events)``."""
    policy = policy or RetryPolicy()
    events: List[dict] = []
    restarts = 0
    while True:
        argv = list(make_argv(restarts))
        rc = subprocess.call(argv, env=env, cwd=cwd)
        if rc == 0:
            if restarts:
                events.append({"event": "recovered",
                               "after_restarts": restarts})
            return 0, events
        events.append({"event": "process_exit", "rc": rc,
                       "attempt": restarts + 1,
                       "retryable": rc in retryable_rcs})
        if rc not in retryable_rcs:
            return rc, events
        restarts += 1
        if restarts > policy.budget:
            events.append({"event": "gave_up", "restarts": restarts - 1})
            return rc, events
        d = policy.delay(restarts)
        events.append({"event": "restart", "attempt": restarts,
                       "backoff_s": round(d, 3),
                       "action": "restart + resume from newest valid "
                                 "checkpoint"})
        logger.warning("supervise_command: child exited rc=%d — restart "
                       "%d/%d in %.2fs", rc, restarts, policy.budget, d)
        sleep(d)
