"""Resilience layer: fault injection, retry/backoff, quarantine, event log.

Copies of the JAX package's ``resilience`` modules, with the same event
kinds and injection-point names:

- :mod:`faults` — deterministic seed-driven fault injection at named points;
- :mod:`retry` — exponential-backoff retry policy for transient failures;
- :mod:`quarantine` — exclusion + probationary re-admission of clients that
  produce non-finite updates;
- :mod:`policy` — operator-level failure policies (fail_task / skip_round /
  retry) and the runner's resilience configuration;
- :mod:`events` — counters + structured events.

The process-global injector and log are the port's own: a chaos plan armed
through the JAX package does not reach a port runner.
"""

from olearning_sim_tpu_torch.resilience.events import (
    ADMISSION_REJECTED,
    CHECKPOINT_FALLBACK,
    CLIENT_FLAGGED,
    CLIENT_QUARANTINED,
    CLIENT_READMITTED,
    CRASH_LOOP,
    DEADLINE_MISS,
    FAULT_INJECTED,
    LEASE_EXPIRED,
    OUTBOUND_DEGRADED,
    QUARANTINE,
    READMIT,
    RETRY,
    RETRY_EXHAUSTED,
    ROLLBACK,
    SKIP_ROUND,
    TASK_MIGRATED,
    TASK_PREEMPTED,
    TASK_RESUMED,
    ResilienceEvent,
    ResilienceLog,
    global_log,
)
from olearning_sim_tpu_torch.resilience.faults import (
    ChaosClock,
    FaultError,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    HostPreemption,
    active_injector,
    chaos,
    fire,
    inject,
    install,
)
from olearning_sim_tpu_torch.resilience.policy import FailurePolicy, ResilienceConfig
from olearning_sim_tpu_torch.resilience.quarantine import (
    QuarantineManager,
    parse_quarantine_params,
)
from olearning_sim_tpu_torch.resilience.retry import NO_RETRY, NON_RETRYABLE, RetryPolicy

__all__ = [
    "ADMISSION_REJECTED",
    "CHECKPOINT_FALLBACK",
    "CLIENT_FLAGGED",
    "CLIENT_QUARANTINED",
    "CLIENT_READMITTED",
    "CRASH_LOOP",
    "DEADLINE_MISS",
    "FAULT_INJECTED",
    "LEASE_EXPIRED",
    "OUTBOUND_DEGRADED",
    "QUARANTINE",
    "READMIT",
    "RETRY",
    "RETRY_EXHAUSTED",
    "ROLLBACK",
    "SKIP_ROUND",
    "TASK_MIGRATED",
    "TASK_PREEMPTED",
    "TASK_RESUMED",
    "ChaosClock",
    "FailurePolicy",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "HostPreemption",
    "NO_RETRY",
    "NON_RETRYABLE",
    "QuarantineManager",
    "ResilienceConfig",
    "ResilienceEvent",
    "ResilienceLog",
    "RetryPolicy",
    "active_injector",
    "chaos",
    "fire",
    "global_log",
    "inject",
    "install",
    "parse_quarantine_params",
]
