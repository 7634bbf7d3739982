"""Fault injection and supervised recovery (counterpart of
``bigdl_tpu/resilience``): :mod:`faults` fires seeded simulated faults at
instrumented sites (no-ops unless a plan is installed), :mod:`supervisor`
retries under exponential backoff with deterministic jitter and resumes
from the newest checksum-valid checkpoint (``cli.common.run_optimize``),
with :func:`~supervisor.supervise_command` for process-fatal preemptions,
and :mod:`elastic` re-forms data parallelism at the surviving rank count
after a ``kill_device`` fault. The serving-side hardening (deadlines,
dead-worker fast-fail, the watchdog, tiered shedding) lives in
:mod:`bigdl_tpu_torch.serving`."""

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
    "ChecksumError", "DeviceLossFault", "ElasticDataParallel",
    "ElasticSupervisor", "FaultInjector", "FaultPlan", "FaultRule",
    "PREEMPT_RC", "RETRYABLE_EXCEPTIONS", "RetryPolicy",
    "SimulatedPreemption", "Supervisor", "SupervisorGaveUp",
    "TransientFault", "WorkerKillFault", "clear_plan", "healthy_devices",
    "hook", "injected_events", "install_plan", "parse_plan",
    "restore_devices", "supervise_command",
]


def __getattr__(name):
    # elastic pulls in the parallel layer: load it only when the elastic
    # classes are asked for, keeping `resilience.faults.hook` cheap for
    # the training loop and the checkpoint files that import it
    if name in ("ElasticDataParallel", "ElasticSupervisor",
                "ELASTIC_POLICIES"):
        from bigdl_tpu_torch.resilience import elastic
        return getattr(elastic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
