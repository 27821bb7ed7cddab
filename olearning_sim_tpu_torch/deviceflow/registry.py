"""Task -> compute-resources registry.

Reference: ``ols_core/deviceflow/non_grpc/registry.py:14-112``
(TaskOrientedDeviceFlowRegistry): before any flow runs, the task runner
registers which compute resources (logical_simulation and/or
device_simulation) will participate; flow completion requires NotifyComplete
from every registered resource.

A copy of the JAX package's ``deviceflow/registry.py``.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo

REGISTRY_COLUMNS = ["task_id", "registry"]


class TaskRegistry:
    def __init__(self, repo: Optional[TableRepo] = None, logger: Optional[Logger] = None):
        self.repo = repo if repo is not None else MemoryTableRepo(REGISTRY_COLUMNS)
        self.logger = logger if logger is not None else Logger()
        self._lock = threading.RLock()
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._recover()

    def _recover(self):
        for row in self.repo.query_all():
            try:
                self._tasks[row["task_id"]] = json.loads(row["registry"])
            except (TypeError, KeyError, json.JSONDecodeError):
                continue

    def register_task(self, task_id: str, total_compute_resources: List[str]) -> bool:
        with self._lock:
            entry = {"total_compute_resources": list(total_compute_resources)}
            if task_id in self._tasks:
                # Idempotent on identical registration, error on conflict.
                if self._tasks[task_id] == entry:
                    return True
                self.logger.error(
                    task_id=task_id, system_name="Deviceflow", module_name="registry",
                    message=f"conflicting re-registration of {task_id}",
                )
                return False
            if not self.repo.add_item(
                {"task_id": [task_id], "registry": [json.dumps(entry)]}
            ):
                return False
            self._tasks[task_id] = entry
            return True

    def unregister_task(self, task_id: str) -> bool:
        with self._lock:
            self._tasks.pop(task_id, None)
            self.repo.delete_items(task_id=task_id)
            return True

    def get(self, task_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._tasks.get(task_id)

    def is_registered(self, task_id: str) -> bool:
        with self._lock:
            return task_id in self._tasks
