"""Task status calculus.

Behavior-compatible port of the reference's status fusion — the subtlest piece
of its control plane (``ols_core/taskMgr/task_manager.py:610-889``): a task's
final status combines the logical-simulation half (the engine) and the
device-simulation half (real phones), each with per-(data, device-class)
success/failed counts, a per-class *dynamic_nums* failure allowance, round
progress, and early-success / early-fail rules. 90 reachable state
combinations (documented at ``task_manager.py:634-663``).

Unlike the reference (which reads MySQL mid-calculation), these are pure
functions over explicit inputs — directly table-testable.

A copy of the JAX package's ``taskmgr/status.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence


class TaskStatus(enum.IntEnum):
    """Mirrors ``taskService.proto:138-147`` TaskStatusEnum."""

    SUCCEEDED = 0
    PENDING = 1
    RUNNING = 2
    STOPPED = 3
    FAILED = 4
    MISSING = 5
    UNDONE = 6
    QUEUED = 7


@dataclasses.dataclass
class SimHalfState:
    """Progress of one simulation half (logical on the engine, or device on phones).

    ``target``: per-data {"name", "simulation_target": {"devices", "nums"}}
    ``result``: per-data {"name", "simulation_target": {"devices",
                "success_num", "failed_num"}}
    ``current_round`` / ``operator_name``: last finished round (1-based, i.e.
    the count of completed rounds) and last finished operator.
    ``present``: whether this half exists for the task at all.
    """

    present: bool = False
    target: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    result: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    current_round: Optional[int] = None
    operator_name: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Conditions:
    logical_success: bool
    logical_round_failed: bool
    device_success: bool
    device_round_failed: bool


def _sim_nums(entries: List[Dict[str, Any]], name: str, key: str) -> Optional[List[int]]:
    for e in entries:
        if e.get("name", "") == name:
            return list(e.get("simulation_target", {}).get(key, []))
    return None


def _half_success(
    half: SimHalfState,
    max_round: int,
    last_operator: str,
    data_name_list: Sequence[str],
    total_simulation: List[Dict[str, Any]],
) -> bool:
    """Final-success check for one half alone (reference
    ``task_manager.py:737-754`` / ``:785-801``): at the last round and last
    operator, every data's per-class success count must reach
    nums - dynamic_nums against the half's own target."""
    if half.current_round is None or half.operator_name is None:
        return False
    if not (int(half.current_round) >= max_round and half.operator_name == last_operator):
        return False
    comparisons = []
    for data_index, data_total in enumerate(total_simulation):
        name = data_name_list[data_index]
        half_nums = _sim_nums(half.target, name, "nums")
        dynamic = list(data_total.get("simulation_target", {}).get("dynamic_nums", []))
        success = _sim_nums(half.result, name, "success_num")
        if half_nums is None or success is None:
            continue
        if not dynamic:
            dynamic = [0] * len(half_nums)
        comparisons.append(
            all(s >= n - d for s, n, d in zip(success, half_nums, dynamic))
        )
    return bool(comparisons) and all(comparisons)


def calculate_conditions(
    task_params: Dict[str, Any],
    logical: SimHalfState,
    device: SimHalfState,
) -> Conditions:
    """Reference ``calculate_conditions`` (``task_manager.py:699-889``).

    task_params: {"max_round", "operator_name_list", "data_name_list",
                  "total_simulation"} (the persisted ``total_simulation``
                  column).
    """
    max_round = int(task_params.get("max_round", 0))
    operator_name_list = task_params.get("operator_name_list", [])
    data_name_list = task_params.get("data_name_list", [])
    total_simulation = task_params.get("total_simulation", [])
    last_operator = operator_name_list[-1] if operator_name_list else ""

    # A missing half counts as vacuously successful (reference
    # ``task_manager.py:755-756,802-803``).
    if logical.present:
        logical_success = _half_success(
            logical, max_round, last_operator, data_name_list, total_simulation
        ) if logical.result else False
        logical_round_failed = False
    else:
        logical_success, logical_round_failed = True, False

    if device.present:
        device_success = _half_success(
            device, max_round, last_operator, data_name_list, total_simulation
        ) if device.result else False
        device_round_failed = False
    else:
        device_success, device_round_failed = True, False

    # Combined per-data early-fail / combined-success pass
    # (reference ``task_manager.py:805-887``).
    logical_names = [d.get("name", "") for d in logical.result]
    device_names = [d.get("name", "") for d in device.result]
    rounds_comparable = (
        logical.current_round is not None
        and device.current_round is not None
        and logical.current_round == device.current_round
    )
    operators_match = logical.operator_name == device.operator_name

    combine_data_status: List[bool] = []
    for data_index, data_total in enumerate(total_simulation):
        name = data_name_list[data_index]
        sim = data_total.get("simulation_target", {})
        nums = list(sim.get("nums", []))
        dynamic = list(sim.get("dynamic_nums", []))
        if not dynamic:
            dynamic = [0] * len(nums)

        l_failed = _sim_nums(logical.result, name, "failed_num") if name in logical_names else None
        l_success = _sim_nums(logical.result, name, "success_num") if name in logical_names else None
        d_failed = _sim_nums(device.result, name, "failed_num") if name in device_names else None
        d_success = _sim_nums(device.result, name, "success_num") if name in device_names else None
        l_failed = l_failed if l_failed is not None else [0] * len(dynamic)
        l_success = l_success if l_success is not None else [0] * len(nums)
        d_failed = d_failed if d_failed is not None else [0] * len(dynamic)
        d_success = d_success if d_success is not None else [0] * len(nums)

        # Early-fail: combined failures exceed the dynamic allowance. Only
        # comparable when a single half runs, or both halves are at the same
        # round & operator (reference ``task_manager.py:836-858``).
        failed_cmp: List[bool] = []
        if not logical.result or not device.result:
            failed_cmp = [dy < lf + df for dy, lf, df in zip(dynamic, l_failed, d_failed)]
        if rounds_comparable and operators_match:
            failed_cmp = [dy < lf + df for dy, lf, df in zip(dynamic, l_failed, d_failed)]
        if failed_cmp and any(failed_cmp):
            if not logical.result and device.result:
                logical_round_failed, device_round_failed = False, True
            elif logical.result and not device.result:
                logical_round_failed, device_round_failed = True, False
            else:
                logical_round_failed, device_round_failed = True, True
            break

        # Combined success: logical + device successes together reach
        # nums - dynamic (reference ``task_manager.py:860-873``).
        success_cmp: List[bool] = []
        if not logical.result or not device.result:
            success_cmp = [
                ls + ds >= n - dy
                for ls, ds, n, dy in zip(l_success, d_success, nums, dynamic)
            ]
        if rounds_comparable:
            success_cmp = [
                ls + ds >= n - dy
                for ls, ds, n, dy in zip(l_success, d_success, nums, dynamic)
            ]
        if success_cmp:
            combine_data_status.append(all(success_cmp))

    # Early-success promotion (reference ``task_manager.py:875-887``).
    if logical.result and logical.current_round is not None:
        if (
            int(logical.current_round) >= max_round
            and logical.operator_name == last_operator
            and combine_data_status
            and all(combine_data_status)
        ):
            logical_success = True
    if device.result and device.current_round is not None:
        if (
            int(device.current_round) >= max_round
            and device.operator_name == last_operator
            and combine_data_status
            and all(combine_data_status)
        ):
            device_success = True

    return Conditions(
        logical_success=logical_success,
        logical_round_failed=logical_round_failed,
        device_success=device_success,
        device_round_failed=device_round_failed,
    )


def combine_task_status(
    conditions: Conditions,
    logical_task_status: TaskStatus,
    device_task_finished: bool,
) -> TaskStatus:
    """Reference ``combine_task_status`` decision table
    (``task_manager.py:670-697``); ``logical_task_status`` is the engine/Ray
    job status, ``device_task_finished`` the phone-side is_finished flag."""
    c = conditions
    # Contradictory states collapse to FAILED (``:671-678``).
    if c.logical_success and c.logical_round_failed:
        return TaskStatus.FAILED
    if c.device_success and c.device_round_failed:
        return TaskStatus.FAILED
    if c.logical_success and c.device_success:
        return TaskStatus.SUCCEEDED
    if (
        not c.logical_success
        and not c.logical_round_failed
        and logical_task_status == TaskStatus.STOPPED
        and not c.device_round_failed
        and device_task_finished
    ):
        return TaskStatus.STOPPED
    if not c.logical_success and logical_task_status in (
        TaskStatus.SUCCEEDED,
        TaskStatus.FAILED,
        TaskStatus.STOPPED,
    ):
        return TaskStatus.FAILED
    if not c.logical_success and c.logical_round_failed:
        return TaskStatus.FAILED
    if not c.device_success and device_task_finished:
        return TaskStatus.FAILED
    if not c.device_success and c.device_round_failed:
        return TaskStatus.FAILED
    return TaskStatus.RUNNING
