"""FIFO task queue (reference ``ols_core/taskMgr/task_queue.py:16-49``).

In-memory list of TaskConfig records; the task table is the durable source of
truth for boot recovery (``task_manager.py:89-155``).

A copy of the JAX package's ``taskmgr/task_queue.py`` over the port's
``TaskConfig`` dataclasses.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig


class TaskQueue:
    def __init__(self):
        self._queue: List[TaskConfig] = []
        self._lock = threading.RLock()

    def add(self, task: TaskConfig) -> bool:
        with self._lock:
            if any(t.taskID.taskID == task.taskID.taskID for t in self._queue):
                return False
            self._queue.append(task)
            return True

    def delete(self, task_id: str) -> bool:
        with self._lock:
            for i, t in enumerate(self._queue):
                if t.taskID.taskID == task_id:
                    del self._queue[i]
                    return True
            return False

    def get(self, task_id: str) -> Optional[TaskConfig]:
        with self._lock:
            for t in self._queue:
                if t.taskID.taskID == task_id:
                    return t
            return None

    def get_task_queue(self) -> List[TaskConfig]:
        with self._lock:
            return list(self._queue)

    def get_task_ids(self) -> List[str]:
        with self._lock:
            return [t.taskID.taskID for t in self._queue]

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def __contains__(self, task_id: str) -> bool:
        with self._lock:
            return any(t.taskID.taskID == task_id for t in self._queue)
