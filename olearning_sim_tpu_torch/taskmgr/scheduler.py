"""Task scheduling: demand calculation, availability filtering, scoring.

Reference: ``ols_core/taskMgr/task_scheduler.py`` + pluggable strategy
(``taskMgr/utils/scheduler_strategy.py:36-193``). The resource vocabulary
changes for the accelerator — the logical-simulation demand is expressed in
*computation units* (reference: Ray-actor CPUs; here: cards via the resource
manager's unit mapping, ``DeviceTopology.detect(units_per_core=...)``) — but demand shape, availability filtering, and the
queue-position + priority/10 scoring are preserved.

A copy of the JAX package's ``taskmgr/scheduler.py`` over the port's
``TaskConfig`` dataclasses (:mod:`olearning_sim_tpu_torch.taskmgr.codecs`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig


@dataclasses.dataclass
class ScheduleResult:
    task: TaskConfig
    task_request: Dict[str, Any]
    # Chip-pool strategies also choose WHERE: the pool worker/mesh the
    # launch should land on (None for pool-less strategies).
    worker: Optional[str] = None


def get_task_request_resource(task: TaskConfig) -> Dict[str, Any]:
    """Demand from computation units x requested device counts
    (reference ``DefaultStrategy.get_task_request_resource``,
    ``scheduler_strategy.py:37-99``)."""
    logical_requirement: Dict[str, int] = {}
    for rr in task.logicalSimulation.resourceRequestLogicalSimulation:
        for device, num in zip(rr.deviceResourceRequest, rr.numResourceRequest):
            logical_requirement[device] = logical_requirement.get(device, 0) + int(num)

    unit_cfg = task.logicalSimulation.computationUnit
    unit_map = {
        device: {"num_cpus": setting.numCpus}
        for device, setting in zip(unit_cfg.devicesUnit, unit_cfg.unitSetting)
    }
    cpu_request, mem_request = 0.0, 0.0
    for device, count in logical_requirement.items():
        cpu_request += unit_map.get(device, {}).get("num_cpus", 0) * count
        mem_request += unit_map.get(device, {}).get("num_mems", 1.0) * count

    device_requirement: Dict[str, int] = {}
    for rr in task.deviceSimulation.resourceRequestDeviceSimulation:
        for device, num in zip(rr.deviceResourceRequest, rr.numResourceRequest):
            device_requirement[device] = device_requirement.get(device, 0) + int(num)

    return {
        "logical_simulation": {"cpu": cpu_request, "mem": mem_request},
        "device_simulation": {task.userID: device_requirement} if device_requirement else {},
    }


def check_resource_availability(task_request: Dict[str, Any],
                                available: Dict[str, Any]) -> bool:
    """Reference ``check_resource_availability`` (``scheduler_strategy.py:101-148``)."""
    req = task_request.get("logical_simulation", {})
    avail = available.get("logical_simulation", {})
    if req.get("cpu", 0.0) > avail.get("cpu", 0.0):
        return False
    if req.get("mem", 0.0) > avail.get("mem", 0.0):
        return False
    device_req = task_request.get("device_simulation", {})
    for user_id, phones in device_req.items():
        have = available.get("device_simulation", {}).get(user_id, {})
        for phone_type, n in phones.items():
            if n > have.get(phone_type, 0):
                return False
    return True


class SchedulerStrategy:
    def schedule_next_task(self, task_queue: List[TaskConfig],
                           available_resources: Dict[str, Any]) -> Optional[ScheduleResult]:
        raise NotImplementedError


class DefaultStrategy(SchedulerStrategy):
    """Queue-position + priority scoring (reference ``scheduler_strategy.py:150-188``)."""

    def schedule_task(self, waiting: List[Dict[str, Any]]) -> int:
        n = len(waiting)
        time_scores = [(n - i) / n for i in range(n)]
        priority_scores = [w["task_priority"] / 10 for w in waiting]
        scores = [t + p for t, p in zip(time_scores, priority_scores)]
        return scores.index(max(scores))

    def schedule_next_task(self, task_queue, available_resources):
        waiting = []
        for task in task_queue:
            request = get_task_request_resource(task)
            if check_resource_availability(request, available_resources):
                waiting.append({
                    "task": task,
                    "task_priority": task.target.priority,
                    "task_request": request,
                })
        if not waiting:
            return None
        idx = self.schedule_task(waiting)
        return ScheduleResult(task=waiting[idx]["task"], task_request=waiting[idx]["task_request"])


class FifoPopStrategy(SchedulerStrategy):
    """Strict FIFO pop — the reference's durable-queue semantics (and this
    repo's pre-chip-pool behavior): the HEAD of the queue launches when it
    fits and nothing overtakes it. The scheduler bench's baseline; the
    cost-model pool scheduler (taskmgr/pool.py) is measured against it."""

    def schedule_next_task(self, task_queue, available_resources):
        if not task_queue:
            return None
        task = task_queue[0]
        request = get_task_request_resource(task)
        if not check_resource_availability(request, available_resources):
            return None  # head-of-line blocking: wait for room
        return ScheduleResult(task=task, task_request=request)


class StrategyFactory:
    """Reference ``StrategyFactory`` (``scheduler_strategy.py:190-193``)."""

    _registry = {"default": DefaultStrategy, "fifo": FifoPopStrategy}

    @classmethod
    def register(cls, name: str, strategy_cls) -> None:
        cls._registry[name] = strategy_cls

    @classmethod
    def create_strategy(cls, name: Optional[str] = None) -> SchedulerStrategy:
        return cls._registry.get(name or "default", DefaultStrategy)()
