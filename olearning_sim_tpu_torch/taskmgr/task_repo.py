"""Task table: the control-plane state row per task.

Reference: ``taskmgr_table`` accessed via TaskTableRepo
(``ols_core/taskMgr/utils/utils.py:29-267``); columns inferred from call
sites across task_manager.py / run_task.py. Same narrow get/set-by-task_id
interface over a pluggable TableRepo backend. A copy of the JAX package's
``taskmgr/task_repo.py``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, SqliteTableRepo, TableRepo


def parse_supervision(value: Any) -> Dict[str, Any]:
    """Decode a row's durable ``supervision`` blob ({"resumes": n,
    "last_resume_ts": t}). THE shared resume-budget ledger: supervisor
    crash recovery and the chip-pool scheduler's planned migrations both
    read and charge it, so a migration storm and a crash loop drain one
    budget and degrade to FAIL_TASK together."""
    try:
        return json.loads(value or "{}")
    except (TypeError, ValueError):
        return {}


def make_owner_id(prefix: str = "") -> str:
    """Lease identity: host:pid plus a random token, so two owners in one
    process (tests, embedded deployments) are still distinct. The single
    recipe shared by TaskManager and TaskSupervisor — identity semantics
    must never diverge between the two sides of the lease protocol."""
    import os
    import socket
    import uuid

    base = f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"
    return f"{prefix}:{base}" if prefix else base


TASK_COLUMNS = [
    "task_id",
    "user_id",
    "task_status",
    "task_params",        # full task JSON
    "total_simulation",   # {"max_round", "operator_name_list", "data_name_list", "total_simulation"}
    "logical_target",     # {"logical_target": [...]}  per-data device classes + nums
    "logical_round",      # completed rounds (int)
    "logical_operator",   # last finished operator name
    "logical_result",     # {"logical_result": [...]} per-data success/failed counts
    "device_target",
    "device_round",
    "device_operator",
    "device_result",
    "job_id",
    "worker_id",          # chip-pool placement: which pool worker/mesh runs it
    "resilience",         # JSON digest of resilience counters/events (runner)
    "resource_occupied",
    "owner_id",           # lease: process owning the task's engine job
    "lease_expires",      # lease: epoch seconds (repr(float)) the lease dies
    "supervision",        # JSON {"resumes": n, "last_resume_ts": t} (supervisor)
    "in_queue_time",
    "submit_task_time",
    "task_finished_time",
    "job_error",          # the failed engine job's exception (port manager)
]


class TaskTableRepo:
    """get/set items keyed by task_id (reference ``utils.py:29-267``)."""

    def __init__(self, backend: Optional[TableRepo] = None, sqlite_path: Optional[str] = None):
        if backend is not None:
            self.backend = backend
        elif sqlite_path is not None:
            self.backend = SqliteTableRepo(sqlite_path, "taskmgr_table", TASK_COLUMNS)
        else:
            self.backend = MemoryTableRepo(TASK_COLUMNS)

    def has_task(self, task_id: str) -> bool:
        return self.backend.has_item("task_id", task_id)

    def add_task(self, task_id: str, **fields: Any) -> bool:
        item = {"task_id": [task_id]}
        for k, v in fields.items():
            item[k] = [v]
        ok = self.backend.add_item(item)
        if ok and "task_status" in fields:
            self._count_transition(fields["task_status"])
        return ok

    def get_item_value(self, task_id: str, item: str) -> Any:
        return self.backend.get_item_value("task_id", task_id, item)

    def set_item_value(self, task_id: str, item: str, value: Any) -> bool:
        # The single seam every task_status write goes through (submit,
        # schedule, stop, release, recover, watchdog) — counted here, and
        # only for writes the backend actually landed (a write racing a
        # deleted row must not count as a transition).
        ok = self.backend.set_item_value("task_id", task_id, item, value)
        if ok and item == "task_status":
            self._count_transition(value)
        return ok

    @staticmethod
    def _count_transition(status: Any) -> None:
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_taskmgr_state_transitions_total").labels(
            status=str(status)
        ).inc()

    def delete_task(self, task_id: str) -> bool:
        return self.backend.delete_items(task_id=task_id)

    # ------------------------------------------------------------------ leases
    # Lease-based ownership: exactly one process may own a task's engine job
    # at a time. The claim/renew CAS lives in the backend (TableRepo.claim_row)
    # so two managers racing on one sqlite/MySQL file cannot both win.
    def claim_lease(self, task_id: str, owner_id: str, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        """Take (or extend) the task's lease. Succeeds when the task is
        unowned, already ours, or its lease expired before ``now``."""
        # lint: allow-wall-clock — lease_expires is persisted and compared
        # by OTHER processes; monotonic clocks have per-process epochs.
        now = time.time() if now is None else now
        return self.backend.claim_row(
            "task_id", task_id, "owner_id", owner_id,
            "lease_expires", now + ttl_s, now, steal=True,
        )

    def renew_lease(self, task_id: str, owner_id: str, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        """Extend the lease iff we still own it. A False answer means
        another process reclaimed the task — the caller must fence itself
        (stop its job), not keep running a task it no longer owns."""
        # lint: allow-wall-clock — renewals extend the same cross-process
        # persisted wall-clock lease timestamp claim_lease wrote.
        now = time.time() if now is None else now
        return self.backend.claim_row(
            "task_id", task_id, "owner_id", owner_id,
            "lease_expires", now + ttl_s, now, steal=False,
        )

    def release_lease(self, task_id: str, owner_id: str) -> bool:
        """Drop the lease iff we still own it (task finished or handed off).
        Atomic in the backend: a release racing a steal must never wipe the
        new owner's live lease."""
        return self.backend.release_row(
            "task_id", task_id, "owner_id", owner_id, "lease_expires"
        )

    def lease_info(self, task_id: str) -> Tuple[str, Optional[float]]:
        """(owner_id, lease_expires) — expires None when unset/unparseable."""
        owner = self.get_item_value(task_id, "owner_id") or ""
        raw = self.get_item_value(task_id, "lease_expires")
        try:
            expires: Optional[float] = float(raw)
        except (TypeError, ValueError):
            expires = None
        return owner, expires

    @staticmethod
    def lease_expired(row: dict, now: float) -> bool:
        """Row-level expiry check (query_all scans). A RUNNING row with no
        parseable lease is a legacy/torn record and counts as expired."""
        try:
            return float(row.get("lease_expires")) < now
        except (TypeError, ValueError):
            return True

    def get_task_ids_by_status(self, status: Any) -> List[str]:
        return self.backend.get_values_by_conditions("task_id", task_status=status)

    def query_all(self):
        return self.backend.query_all()
