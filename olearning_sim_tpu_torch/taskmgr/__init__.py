"""The port's control plane, copied from the JAX package's ``taskmgr``: the
task-JSON codec (into plain dataclasses; the port imports no protobuf),
submit validation, the task queue and the alternate intake queues, the
scheduler strategies, the status calculus, the local engine jobs, the
hybrid allocator, the task table, operator-flow barriers, and the
:class:`~olearning_sim_tpu_torch.taskmgr.task_manager.TaskManager` that
drives the port's runners (``task_manager``; with the supervisor in
:mod:`olearning_sim_tpu_torch.supervisor`). Not ported yet (ROADMAP A17b):
the chip-pool scheduler (``pool.py``)."""

from olearning_sim_tpu_torch.taskmgr.codecs import (
    TaskConfig,
    json2taskconfig,
    taskconfig2json,
)
from olearning_sim_tpu_torch.taskmgr.operator_flow import (
    OperatorFlowController,
    register_flow_strategy,
)
from olearning_sim_tpu_torch.taskmgr.queue_repo import (
    MemoryQueueRepo,
    QueueRepo,
    RedisQueueRepo,
    SqliteQueueRepo,
)
from olearning_sim_tpu_torch.taskmgr.status import (
    TaskStatus,
    calculate_conditions,
    combine_task_status,
)
from olearning_sim_tpu_torch.taskmgr.task_repo import TASK_COLUMNS, TaskTableRepo

__all__ = [
    "MemoryQueueRepo",
    "OperatorFlowController",
    "QueueRepo",
    "RedisQueueRepo",
    "SqliteQueueRepo",
    "TASK_COLUMNS",
    "TaskConfig",
    "TaskStatus",
    "TaskTableRepo",
    "calculate_conditions",
    "combine_task_status",
    "json2taskconfig",
    "register_flow_strategy",
    "taskconfig2json",
]
