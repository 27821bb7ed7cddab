"""Resilience event log: counters + structured events.

One log instance is the sink for every resilience-relevant occurrence in the
stack — injected faults, retries, rollbacks, quarantines, degraded outbound
sinks — so a single query answers "what did the platform absorb while this
task ran". The reference has no equivalent (failures there surface as Ray
actor restarts and subprocess exit codes scattered over logs); centralizing
them is what lets the task status API and bench records carry a robustness
trajectory.

Most components default to the process-global log (:func:`global_log`) so
deep call sites (a file repo three layers under the runner) need no plumbing;
anything that wants isolation passes its own instance.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional

# Event kinds of record (free-form kinds are allowed; these are the ones the
# port emits, with the JAX package's names).
FAULT_INJECTED = "fault_injected"
RETRY = "retry"
RETRY_EXHAUSTED = "retry_exhausted"
ROLLBACK = "rollback"
QUARANTINE = "quarantine"
READMIT = "readmit"
SKIP_ROUND = "skip_round"
CHECKPOINT_FALLBACK = "checkpoint_fallback"
# Crash-recovery supervision (supervisor/): a RUNNING task's lease outlived
# its owner process and was reclaimed...
LEASE_EXPIRED = "lease_expired"
# ...and relaunched through the checkpoint resume path...
TASK_RESUMED = "task_resumed"
# ...or died so many consecutive times its resume budget ran out and it was
# quarantined to FAILED instead of livelocking the supervisor.
CRASH_LOOP = "crash_loop"
# A round closed below its quorum of on-time completions (deadline-aware
# rounds, engine/pacing.py) and was routed through the failure policy.
DEADLINE_MISS = "deadline_miss"
# Adversarial-client defense (engine/defense.py + the runner's anomaly
# feedback loop): a participating client's Krum-style anomaly score crossed
# the flag threshold this round...
CLIENT_FLAGGED = "client_flagged"
# ...a client crossed its strike budget (non-finite updates and/or anomaly
# flags) — or was blocklisted up-front via quarantine.preseed — and was
# quarantined out of participation...
CLIENT_QUARANTINED = "client_quarantined"
# ...or finished its quarantine term and was re-admitted on probation.
CLIENT_READMITTED = "client_readmitted"


@dataclasses.dataclass
class ResilienceEvent:
    kind: str
    point: str = ""          # injection/retry point, e.g. "storage.upload"
    task_id: str = ""
    round_idx: Optional[int] = None
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "point": self.point,
            "task_id": self.task_id,
            "round_idx": self.round_idx,
            "detail": self.detail,
            "ts": self.ts,
        }


class ResilienceLog:
    """Thread-safe counters + bounded structured event window.

    Counters are kept globally and per task id; the event list keeps the last
    ``keep_last`` entries (structured forensics), while counters are exact
    over the log's lifetime.

    Every record is mirrored into the telemetry metrics registry as a
    labeled ``ols_resilience_events_total{kind, task_id}`` increment, so the
    Prometheus render of a run carries the same counters this log answers —
    ``registry`` pins a specific :class:`MetricsRegistry`; None resolves the
    process default at record time (so a test-swapped default is honored).
    """

    def __init__(self, keep_last: int = 4096, registry=None):
        self.keep_last = keep_last
        self.registry = registry
        self._lock = threading.RLock()
        self._counters: Counter = Counter()
        self._task_counters: Dict[str, Counter] = {}
        self._events: List[ResilienceEvent] = []

    def record(self, kind: str, point: str = "", task_id: str = "",
               round_idx: Optional[int] = None, **detail: Any) -> ResilienceEvent:
        ev = ResilienceEvent(kind=kind, point=point, task_id=task_id,
                             round_idx=round_idx, detail=detail)
        with self._lock:
            self._counters[kind] += 1
            if task_id:
                self._task_counters.setdefault(task_id, Counter())[kind] += 1
            self._events.append(ev)
            if len(self._events) > self.keep_last:
                del self._events[: len(self._events) - self.keep_last]
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_resilience_events_total", self.registry).labels(
            kind=kind, task_id=task_id
        ).inc()
        return ev

    def counters(self, task_id: Optional[str] = None) -> Dict[str, int]:
        with self._lock:
            src = (self._task_counters.get(task_id, Counter())
                   if task_id else self._counters)
            return dict(src)

    def count(self, kind: str, task_id: Optional[str] = None) -> int:
        return self.counters(task_id).get(kind, 0)

    def events(self, kind: Optional[str] = None,
               task_id: Optional[str] = None) -> List[ResilienceEvent]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if task_id is not None:
            out = [e for e in out if e.task_id == task_id]
        return out

    def summary(self, task_id: Optional[str] = None) -> Dict[str, Any]:
        """JSON-ready digest for the task status API / bench records."""
        with self._lock:
            events = [e for e in self._events
                      if task_id is None or e.task_id == task_id]
            return {
                "counters": self.counters(task_id),
                "recent_events": [e.to_dict() for e in events[-20:]],
            }


_GLOBAL = ResilienceLog()


def global_log() -> ResilienceLog:
    """The process-wide default sink (bench.py reads its counters)."""
    return _GLOBAL
