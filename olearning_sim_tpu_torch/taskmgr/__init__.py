"""The task-side host modules a runner needs, copied from the JAX package's
``taskmgr``: operator-flow barriers, the task table and the task-JSON codec
(into plain dataclasses; the port imports no protobuf). The control plane
itself (task manager, scheduler, supervisor) is the JAX package's and
drives a port runner through its ``runner_factory``."""

from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig, json2taskconfig
from olearning_sim_tpu_torch.taskmgr.operator_flow import (
    OperatorFlowController,
    register_flow_strategy,
)
from olearning_sim_tpu_torch.taskmgr.task_repo import TASK_COLUMNS, TaskTableRepo

__all__ = [
    "OperatorFlowController",
    "TASK_COLUMNS",
    "TaskConfig",
    "TaskTableRepo",
    "json2taskconfig",
    "register_flow_strategy",
]
