"""Full-platform flow: boot a session from a config, submit a
reference-schema task JSON and poll it to completion (the reference's
submitTask -> schedule -> run -> getTaskStatus loop).

The port of the JAX package's ``examples/platform_submit.py``. The port
serves no gRPC (its services are reached in process), so the task goes in
through ``TaskManager.submit_task`` and its status comes from
``TaskManager.get_task_status``: the two calls the JAX package's gRPC
``TaskMgr`` handlers (``submitTask``, ``getTaskStatus``) make. The task
table is a SQLite file in a temporary directory, read back once the task
is released::

    python -m olearning_sim_tpu_torch.examples.platform_submit [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Optional

from olearning_sim_tpu_torch.examples._common import cli

TASK_ID = "example-task"
TIMEOUT_S = 120.0
POLL_S = 0.2


def make_task(task_id: str) -> dict:
    """The example's task: mlp2 (hidden 32, 4 classes) FedAvg over 32
    synthetic clients, 3 rounds, the JAX example's task JSON."""
    engine_params = {
        "model": {"name": "mlp2", "overrides": {"hidden": [32], "num_classes": 4},
                  "input_shape": [16]},
        "algorithm": {"name": "fedavg", "local_lr": 0.1},
        "fedcore": {"batch_size": 8, "max_local_steps": 3, "block_clients": 4},
        "data": {"synthetic": {"seed": 1, "n_local": 12, "num_classes": 4,
                               "class_sep": 3.0}, "eval_n": 128},
    }
    return {
        "user_id": "example_user",
        "task_id": task_id,
        "target": {
            "priority": 1,
            "data": [{
                "name": "data_0", "data_path": "", "data_split_type": False,
                "data_transfer_type": "FILE", "task_type": "classification",
                "total_simulation": {"devices": ["high"], "nums": [32],
                                     "dynamic_nums": [0]},
                "allocation": {"optimization": False,
                               "logical_simulation": [32],
                               "device_simulation": [0],
                               "running_response": {"devices": [], "nums": []}},
            }],
        },
        "operatorflow": {
            "flow_setting": {"round": 3,
                "start": {"logical_simulation": {"strategy": "", "wait_interval": 0,
                                                 "total_timeout": 0},
                          "device_simulation": {"strategy": "", "wait_interval": 0,
                                                "total_timeout": 0}},
                "stop": {"logical_simulation": {"strategy": "", "wait_interval": 0,
                                                "total_timeout": 0},
                         "device_simulation": {"strategy": "", "wait_interval": 0,
                                               "total_timeout": 0}}},
            "operators": [{
                "name": "train", "input": [],
                "logical_simulation": {
                    "simulation_num": 32,
                    "operator_code_path": "builtin:train",
                    "operator_entry_file": "",
                    "operator_transfer_type": "FILE",
                    "operator_params": json.dumps(engine_params)},
                "device_simulation": {},
                "operation_behavior_controller": {
                    "use_gradient_house": False,
                    "strategy_gradient_house": ""},
            }],
        },
        "logical_simulation": {
            "computation_unit": {"devices": ["high"],
                                 "setting": [{"num_cpus": 1}]},
            "resource_request": [{"name": "data_0", "devices": ["high"],
                                  "num_request": [1]}]},
        "device_simulation": {"resource_request": [{"name": "data_0",
                                                    "devices": [],
                                                    "num_request": []}]},
    }


def session_config(workdir: str, services=("taskmgr", "resourcemgr", "phonemgr",
                                           "performancemgr")) -> dict:
    """The example's platform: the JAX example's services, intervals and
    phone inventory, with the task table in ``workdir/state.db``."""
    return {
        "session": {"services": list(services)},
        "taskmgr": {"schedule_interval": 0.2, "release_interval": 0.2,
                    "interrupt_interval": 3600},
        "repos": {"sqlite_path": os.path.join(workdir, "state.db")},
        "phonemgr": {"inventory": {"example_user": {"high": 4}},
                     "speedup": 1000.0},
    }


def wait_released(session, rows, task_id: str) -> List[str]:
    """Poll the task's status until it ends, then until the manager has
    released it (its row final). Returns the statuses seen, in order, each
    once."""
    from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
    from olearning_sim_tpu_torch.utils.clocks import Deadline

    # Monotonic countdown: immune to NTP/wall-clock steps (utils.clocks is
    # the platform's one timeout clock).
    deadline = Deadline(TIMEOUT_S)
    seen: List[str] = []
    st = None
    while not deadline.expired():
        st = session.task_manager.get_task_status(task_id)
        if not seen or seen[-1] != st.name:
            seen.append(st.name)
        if st in (TaskStatus.SUCCEEDED, TaskStatus.FAILED) and \
                str(rows.get_item_value(task_id, "resource_occupied")) == "0":
            break
        time.sleep(POLL_S)
    assert st == TaskStatus.SUCCEEDED, st
    return seen


def run(device="cuda") -> dict:
    """Whether the submit was accepted, the statuses polled, and the task's
    final row."""
    from olearning_sim_tpu_torch.config import build_session
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    with tempfile.TemporaryDirectory() as workdir:
        cfg = session_config(workdir)
        session = build_session(cfg, device=device)
        rows = TaskTableRepo(sqlite_path=cfg["repos"]["sqlite_path"])
        with session:
            platform = f"{session.device} (services: {', '.join(session.services)})"
            tc = json2taskconfig(json.dumps(make_task(TASK_ID)))
            submitted = session.task_manager.submit_task(tc)
            statuses = wait_released(session, rows, TASK_ID)
        row = next(r for r in rows.query_all() if r["task_id"] == TASK_ID)
    return {"platform": platform, "submitted": submitted, "statuses": statuses, "row": row}


def report(result: dict) -> List[str]:
    return ([f"platform up in process on {result['platform']}",
             f"submitTask: {result['submitted']}"]
            + [f"status: {s}" for s in result["statuses"]]
            + [f"task completed successfully: logical_round "
               f"{result['row']['logical_round']}"])


def main(argv: Optional[list] = None) -> int:
    return cli(run, report, "a task submitted to the platform and polled to its end", argv)


if __name__ == "__main__":
    raise SystemExit(main())
