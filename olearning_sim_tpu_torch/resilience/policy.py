"""Operator-level failure policies + the runner's resilience configuration."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

from olearning_sim_tpu_torch.resilience.events import ResilienceLog
from olearning_sim_tpu_torch.resilience.retry import RetryPolicy


class FailurePolicy(str, enum.Enum):
    """What the runner does when a round fails after call-site retries.

    - ``FAIL_TASK``: re-raise — the task fails (the pre-resilience behavior
      and the default when no ResilienceConfig is supplied).
    - ``SKIP_ROUND``: log + count, abandon the round's remaining work, move
      on to the next round (best-effort semantics: some traffic is better
      than no traffic).
    - ``RETRY``: roll back to the last good state (checkpoint when available,
      in-memory snapshot otherwise) and re-execute the round, up to
      ``max_round_retries`` times per round; then degrade to FAIL_TASK.
    """

    FAIL_TASK = "fail_task"
    SKIP_ROUND = "skip_round"
    RETRY = "retry"


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for resilient round execution (engine params ``resilience``).

    ``rpc_retry`` covers deviceflow NotifyStart/NotifyComplete from the
    runner; ``round_backoff_s`` is slept between round retries (scaled by
    attempt). ``snapshot_rounds`` keeps an on-device copy of every state
    tree per round so rollback works without a checkpointer — it costs one
    extra copy of the state in device memory, so at scale prefer a
    checkpointer (rollback then replays from the last retained round).
    """

    failure_policy: FailurePolicy = FailurePolicy.RETRY
    max_round_retries: int = 2
    round_backoff_s: float = 0.0
    rpc_retry: Optional[RetryPolicy] = None
    # Quarantine: None disables (non-finite clients are still excluded from
    # aggregation by the engine, but keep re-running every round).
    quarantine_after: Optional[int] = 1
    readmit_after: int = 3
    snapshot_rounds: bool = True
    log: Optional[ResilienceLog] = None

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ResilienceConfig":
        """Engine-params JSON shape::

            {"failure_policy": "retry", "max_round_retries": 2,
             "quarantine_after": 1, "readmit_after": 3,
             "rpc_retry": {"max_attempts": 3, "base_delay": 0.05}}
        """
        kw: Dict[str, Any] = {}
        if "failure_policy" in obj:
            kw["failure_policy"] = FailurePolicy(obj["failure_policy"])
        for k in ("max_round_retries", "readmit_after"):
            if k in obj:
                kw[k] = int(obj[k])
        if "round_backoff_s" in obj:
            kw["round_backoff_s"] = float(obj["round_backoff_s"])
        if "quarantine_after" in obj:
            q = obj["quarantine_after"]
            kw["quarantine_after"] = None if q is None else int(q)
        if "snapshot_rounds" in obj:
            kw["snapshot_rounds"] = bool(obj["snapshot_rounds"])
        if "rpc_retry" in obj and obj["rpc_retry"] is not None:
            kw["rpc_retry"] = RetryPolicy(**obj["rpc_retry"])
        return cls(**kw)
