"""Fault injection and supervised recovery (counterpart of
``bigdl_tpu/resilience``): :mod:`faults` fires seeded simulated faults at
instrumented sites (no-ops unless a plan is installed), and
:mod:`supervisor` retries under exponential backoff with deterministic
jitter. The serving-side hardening (deadlines, dead-worker fast-fail,
the watchdog, tiered shedding) lives in :mod:`bigdl_tpu_torch.serving`.
Elastic data parallelism is not ported yet."""

from bigdl_tpu_torch.resilience.faults import (PREEMPT_RC, ChecksumError,
                                               DeviceLossFault, FaultInjector,
                                               FaultPlan, FaultRule,
                                               SimulatedPreemption,
                                               TransientFault,
                                               WorkerKillFault, clear_plan,
                                               healthy_devices, hook,
                                               injected_events, install_plan,
                                               parse_plan, restore_devices)
from bigdl_tpu_torch.resilience.supervisor import (RETRYABLE_EXCEPTIONS,
                                                   RetryPolicy, Supervisor,
                                                   SupervisorGaveUp,
                                                   supervise_command)

__all__ = [
    "ChecksumError", "DeviceLossFault", "FaultInjector", "FaultPlan",
    "FaultRule", "PREEMPT_RC", "RETRYABLE_EXCEPTIONS", "RetryPolicy",
    "SimulatedPreemption", "Supervisor", "SupervisorGaveUp",
    "TransientFault", "WorkerKillFault", "clear_plan", "healthy_devices",
    "hook", "injected_events", "install_plan", "parse_plan",
    "restore_devices", "supervise_command",
]
