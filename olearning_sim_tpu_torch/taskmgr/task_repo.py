"""Task table: the control-plane state row per task.

Reference: ``taskmgr_table`` accessed via TaskTableRepo
(``ols_core/taskMgr/utils/utils.py:29-267``); columns inferred from call
sites across task_manager.py / run_task.py. Same narrow get/set-by-task_id
interface over a pluggable TableRepo backend. A copy of the JAX package's
``taskmgr/task_repo.py`` with what the runner calls, over the in-memory
backend; a control plane passes its own repo in (the runner uses it
duck-typed), and with it the task-status writes, leases and queries.
"""

from __future__ import annotations

from typing import Any, Optional

from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo


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
