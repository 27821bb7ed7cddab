"""Task table: the control-plane state row per task.

Reference: ``taskmgr_table`` accessed via TaskTableRepo
(``ols_core/taskMgr/utils/utils.py:29-267``); columns inferred from call
sites across task_manager.py / run_task.py. Same narrow get/set-by-task_id
interface over a pluggable TableRepo backend. A copy of the JAX package's
``taskmgr/task_repo.py`` with what the runner and the multi-task
dispatcher call (the row items and the leases), over the in-memory
backend; a control plane passes its own repo in (both use it
duck-typed), and with it the task-status writes and queries.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo


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
]


class TaskTableRepo:
    """get/set items keyed by task_id (reference ``utils.py:29-267``)."""

    def __init__(self, backend: Optional[TableRepo] = None):
        self.backend = backend if backend is not None else MemoryTableRepo(TASK_COLUMNS)

    def has_task(self, task_id: str) -> bool:
        return self.backend.has_item("task_id", task_id)

    def add_task(self, task_id: str, **fields: Any) -> bool:
        item = {"task_id": [task_id]}
        for k, v in fields.items():
            item[k] = [v]
        return self.backend.add_item(item)

    def get_item_value(self, task_id: str, item: str) -> Any:
        return self.backend.get_item_value("task_id", task_id, item)

    def set_item_value(self, task_id: str, item: str, value: Any) -> bool:
        return self.backend.set_item_value("task_id", task_id, item, value)

    # ------------------------------------------------------------------ leases
    # Lease-based ownership: exactly one process may own a task's engine job
    # at a time. The claim/renew CAS lives in the backend (its claim_row).
    def claim_lease(self, task_id: str, owner_id: str, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        """Take (or extend) the task's lease. Succeeds when the task is
        unowned, already ours, or its lease expired before ``now``."""
        # Wall clock: lease_expires is persisted and compared by other
        # processes; monotonic clocks have per-process epochs.
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
