"""Local engine jobs: the Ray-job-submission analogue.

Reference: TaskRunner packs operator code + run_task.py into a working dir
and submits it to a Ray cluster via ``JobSubmissionClient``
(``ols_core/taskMgr/task_runner.py:41-87``), then polls
``get_job_status(job_id)``. In single-host mode the rebuild runs the
SimulationRunner in a daemon thread with the same observable job states;
multi-host mode swaps in a launcher that targets remote hosts behind the same
interface.

A copy of the JAX package's ``taskmgr/jobs.py``.
"""

from __future__ import annotations

import threading
import traceback
import uuid
from typing import Callable, Dict, Optional

from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
from olearning_sim_tpu_torch.utils.logging import Logger


class LocalEngineJob:
    def __init__(self, job_id: str, runner_factory: Callable[[threading.Event], object],
                 logger: Optional[Logger] = None):
        self.job_id = job_id
        self.logger = logger if logger is not None else Logger()
        self._stop_event = threading.Event()
        self._runner_factory = runner_factory
        self._runner = None
        self._status = TaskStatus.PENDING
        self._error: Optional[str] = None
        self._thread = threading.Thread(target=self._run, name=f"job-{job_id}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        self._status = TaskStatus.RUNNING
        try:
            self._runner = self._runner_factory(self._stop_event)
            self._runner.run()
            if getattr(self._runner, "stopped", False):
                self._status = TaskStatus.STOPPED
            else:
                self._status = TaskStatus.SUCCEEDED
        except Exception as e:  # noqa: BLE001 — job boundary
            self._error = f"{e}\n{traceback.format_exc()}"
            self._status = (
                TaskStatus.STOPPED if self._stop_event.is_set() else TaskStatus.FAILED
            )
            self.logger.error(
                task_id=self.job_id, system_name="JobLauncher", module_name="job",
                message=f"job failed: {e}",
            )

    def stop(self) -> None:
        self._stop_event.set()

    def cancel_stop(self) -> None:
        """Withdraw a stop request the runner has not observed yet (the
        planned-preemption fence abort). If the runner already honored
        it, the job still lands STOPPED — callers must re-check status
        after a short join."""
        self._stop_event.clear()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    @property
    def status(self) -> TaskStatus:
        return self._status

    @property
    def error(self) -> Optional[str]:
        return self._error

    @property
    def runner(self):
        return self._runner


class LocalJobLauncher:
    """submit/stop/status keyed by job_id (the ``JobSubmissionClient``
    analogue)."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger if logger is not None else Logger()
        self._jobs: Dict[str, LocalEngineJob] = {}
        self._lock = threading.RLock()

    def submit(self, runner_factory: Callable[[threading.Event], object],
               job_id: Optional[str] = None) -> str:
        job_id = job_id or f"engine-job-{uuid.uuid4().hex[:12]}"
        job = LocalEngineJob(job_id, runner_factory, logger=self.logger)
        with self._lock:
            self._jobs[job_id] = job
        job.start()
        return job_id

    def get_job(self, job_id: str) -> Optional[LocalEngineJob]:
        with self._lock:
            return self._jobs.get(job_id)

    def get_job_status(self, job_id: str) -> TaskStatus:
        job = self.get_job(job_id)
        return job.status if job is not None else TaskStatus.MISSING

    def stop_job(self, job_id: str) -> bool:
        job = self.get_job(job_id)
        if job is None:
            return False
        job.stop()
        return True
