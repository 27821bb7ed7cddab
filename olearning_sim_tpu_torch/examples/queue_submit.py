"""Intake without a service call: push task JSON onto the durable SQLite
FIFO (the reference's Redis-list submit path) and let the scheduler
drain it through the normal validated submit.

The port of the JAX package's ``examples/queue_submit.py``, with the task
of ``platform_submit``::

    python -m olearning_sim_tpu_torch.examples.queue_submit [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

from olearning_sim_tpu_torch.examples._common import cli
from olearning_sim_tpu_torch.examples.platform_submit import (
    make_task,
    session_config,
    wait_released,
)

TASK_ID = "queued-task"


def queue_config(workdir: str) -> dict:
    """``platform_submit``'s platform without the performance manager (as
    the JAX example's), in process (``address`` none: the intake needs no
    server), draining ``workdir/intake.db``."""
    cfg = session_config(workdir, services=("taskmgr", "resourcemgr", "phonemgr"),
                         address="none")
    cfg["repos"]["intake_queue_path"] = os.path.join(workdir, "intake.db")
    return cfg


def run(device="cuda") -> dict:
    """The statuses polled and the task's final row."""
    from olearning_sim_tpu_torch.config import build_session
    from olearning_sim_tpu_torch.taskmgr.queue_repo import SqliteQueueRepo
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    with tempfile.TemporaryDirectory() as workdir:
        cfg = queue_config(workdir)
        intake_path = cfg["repos"]["intake_queue_path"]

        # Producer side: any local process, no service call needed.
        producer = SqliteQueueRepo(intake_path)
        producer.push(json.dumps(make_task(TASK_ID)))
        producer.close()

        # Platform side: the scheduler drains the FIFO each tick.
        session = build_session(cfg, device=device)
        rows = TaskTableRepo(sqlite_path=cfg["repos"]["sqlite_path"])
        with session:
            statuses = wait_released(session.task_manager.get_task_status, rows, TASK_ID)
        row = next(r for r in rows.query_all() if r["task_id"] == TASK_ID)
    return {"intake": os.path.basename(intake_path), "statuses": statuses, "row": row}


def report(result: dict) -> List[str]:
    return ([f"task JSON pushed to the intake queue {result['intake']}"]
            + [f"status: {s}" for s in result["statuses"]]
            + [f"queued task completed successfully: logical_round "
               f"{result['row']['logical_round']}"])


def main(argv: Optional[list] = None) -> int:
    return cli(run, report, "a task pushed onto the intake queue and drained", argv)


if __name__ == "__main__":
    raise SystemExit(main())
