"""TaskManager: task lifecycle orchestration.

Reference: ``ols_core/taskMgr/task_manager.py`` (1200 lines) — validates and
enqueues tasks, runs three daemon threads (schedule loop, resource release,
interrupt watchdog), recovers its queue from the task table on boot, and
fuses logical + device status into the final task state. The rebuild keeps
those semantics with the Ray job layer swapped for the local engine-job
launcher (multi-host launchers slot in behind the same interface) and MySQL
swapped for a TableRepo.

Timer defaults mirror ``ols_core/config/config.conf:39-45``:
schedule 5 s / release 10 s / interrupt-check 300 s, queue timeout 3600 s,
running timeout 172800 s.

A copy of the JAX package's ``taskmgr/task_manager.py`` over the port's
``TaskConfig`` dataclasses, with the port's runners: the default runner
factory builds them with
:func:`~olearning_sim_tpu_torch.engine.task_bridge.build_runner_from_taskconfig`
on the manager's ``device`` (``"cuda"`` unless the caller asks for the
CPU). A runner that fails to build or run there fails its job; it is never
retried on another device, and the job's error lands in the row's
``job_error`` column. ``pool=`` takes the port's chip-pool scheduler
(:class:`~olearning_sim_tpu_torch.taskmgr.pool.PoolScheduler`). A hybrid
task's real dataset is split between its halves before launch
(:mod:`olearning_sim_tpu_torch.data.hybrid_split`).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, Optional

from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig, json2taskconfig, taskconfig2json
from olearning_sim_tpu_torch.taskmgr.jobs import LocalJobLauncher
from olearning_sim_tpu_torch.taskmgr.scheduler import ScheduleResult, StrategyFactory
from olearning_sim_tpu_torch.taskmgr.status import (
    SimHalfState,
    TaskStatus,
    calculate_conditions,
    combine_task_status,
)
from olearning_sim_tpu_torch.taskmgr.task_queue import TaskQueue
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
from olearning_sim_tpu_torch.taskmgr.validation import validate_task_parameters
from olearning_sim_tpu_torch.utils.logging import Logger


def _logical_nums(td) -> list:
    """The logical half's share of device-rounds: the explicit allocation when
    present, else the full totalSimulation nums (reference JobSubmitter
    projection, ``utils_runner.py:498-561``)."""
    alloc = list(td.allocation.allocationLogicalSimulation)
    if alloc and any(a > 0 for a in alloc):
        return alloc
    return list(td.totalSimulation.numTotalSimulation)


def _device_nums(td) -> list:
    """The device (phone) half's share: present only when the allocation
    explicitly routes device-rounds to phones (reference
    ``assemble_info_device_simulation``, ``utils_runner.py:563-628``)."""
    alloc = list(td.allocation.allocationDeviceSimulation)
    if alloc and any(a > 0 for a in alloc):
        return alloc
    return []


def _total_simulation_entry(tc: TaskConfig) -> Dict[str, Any]:
    """The persisted ``total_simulation`` blob consumed by the status
    calculus (reference ``task_manager.py:217-244``)."""
    return {
        "max_round": tc.operatorFlow.flowSetting.round,
        "operator_name_list": [op.name for op in tc.operatorFlow.operator],
        "data_name_list": [td.dataName for td in tc.target.targetData],
        "total_simulation": [
            {
                "simulation_target": {
                    "devices": list(td.totalSimulation.deviceTotalSimulation),
                    "nums": list(td.totalSimulation.numTotalSimulation),
                    "dynamic_nums": list(td.totalSimulation.dynamicNumTotalSimulation),
                }
            }
            for td in tc.target.targetData
        ],
    }


class TaskManager:
    def __init__(
        self,
        task_repo: Optional[TaskTableRepo] = None,
        resource_manager=None,
        launcher: Optional[LocalJobLauncher] = None,
        runner_factory: Optional[Callable] = None,
        deviceflow=None,
        phone_client=None,
        scheduler_strategy: str = "default",
        schedule_interval: float = 5.0,
        release_interval: float = 10.0,
        interrupt_interval: float = 300.0,
        interrupt_queue_time: float = 3600.0,
        interrupt_running_time: float = 172800.0,
        auto_create_rows: bool = True,
        cost_model=None,
        perf=None,
        logger: Optional[Logger] = None,
        intake_queue=None,
        retry_policy=None,
        resilience_log=None,
        owner_id: Optional[str] = None,
        lease_ttl: float = 60.0,
        heartbeat_interval: Optional[float] = None,
        supervise_orphans: bool = False,
        pool=None,
        rebalance_interval: float = 2.0,
        adopt_stranded_after: Optional[float] = None,
        registry=None,
        device="cuda",
    ):
        """``runner_factory(task_config, task_repo, deviceflow, stop_event)``
        builds the engine runner for a scheduled task; defaults to the
        task-bridge builtin-operator path.

        Lease-based ownership (docs/resilience.md "Leases, supervision &
        crash recovery"): every launched task is claimed under ``owner_id``
        with a ``lease_ttl``-second lease the heartbeat daemon renews
        (every ``heartbeat_interval`` seconds, default ``lease_ttl / 3``)
        while the engine job is live. ``supervise_orphans=True`` makes boot
        recovery leave orphaned RUNNING rows for a
        :class:`~olearning_sim_tpu_torch.supervisor.TaskSupervisor` to reclaim
        and resume from checkpoint; False (the standalone default) keeps
        the legacy release-and-fail recovery.

        ``device`` — where the default runner factory builds runners;
        ``"cuda"`` raises here without a card. ``pool`` — a
        :class:`~olearning_sim_tpu_torch.taskmgr.pool.PoolScheduler`: it is
        the strategy, gates submission and, with the daemons started, runs
        ``rebalance_once`` every ``rebalance_interval`` seconds."""
        self._device = resolve_device(device)
        self.logger = logger if logger is not None else Logger()
        self._task_repo = task_repo if task_repo is not None else TaskTableRepo()
        self._resource_manager = resource_manager
        self._launcher = launcher if launcher is not None else LocalJobLauncher()
        self._runner_factory = runner_factory or self._default_runner_factory
        self._deviceflow = deviceflow
        self._phone_client = phone_client
        self._perf = perf
        # Telemetry registry for per-task series retention (None resolves
        # the process default at use time).
        self._registry = registry
        self._task_queue = TaskQueue()
        # Multi-manager rescue: a QUEUED row sitting in a DEAD manager's
        # in-memory queue is invisible to everyone else (boot recovery
        # only runs at boot). With adopt_stranded_after=S, the schedule
        # daemon periodically re-adopts QUEUED rows older than S seconds
        # that are not in the local queue; the pre-launch QUEUED-status
        # check + lease CAS make duplicate adoption race-safe (exactly one
        # launch wins). None (default) keeps single-manager behavior.
        self._adopt_stranded_after = adopt_stranded_after
        self._last_adopt_scan = 0.0
        # Chip-pool control plane (taskmgr/pool.py): when a PoolScheduler
        # is supplied it IS the strategy, and additionally gates submission
        # (admission control) and drives planned preemption/migration from
        # the rebalance daemon.
        self._pool = pool
        self._rebalance_interval = rebalance_interval
        if pool is not None:
            pool.bind(self)
            self._strategy = pool
        else:
            self._strategy = StrategyFactory.create_strategy(scheduler_strategy)
        self._schedule_interval = schedule_interval
        self._release_interval = release_interval
        self._interrupt_interval = interrupt_interval
        self._interrupt_queue_time = interrupt_queue_time
        self._interrupt_running_time = interrupt_running_time
        self._auto_create_rows = auto_create_rows
        from olearning_sim_tpu_torch.taskmgr.task_repo import make_owner_id

        self.owner_id = owner_id if owner_id is not None else make_owner_id()
        self.lease_ttl = float(lease_ttl)
        self._heartbeat_interval = (
            heartbeat_interval if heartbeat_interval is not None
            else self.lease_ttl / 3.0
        )
        self._supervise_orphans = supervise_orphans
        # Transient-failure discipline for job submission and device-half
        # polling (ISSUE: resilience layer). Default: one retry with a short
        # backoff — enough to ride out a scheduler hiccup without changing
        # the failure semantics tests rely on.
        from olearning_sim_tpu_torch.resilience import RetryPolicy
        from olearning_sim_tpu_torch.resilience.events import global_log

        self._retry_policy = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=2, base_delay=0.1, max_delay=1.0)
        self._resilience_log = resilience_log if resilience_log is not None \
            else global_log()
        from olearning_sim_tpu_torch.taskmgr.hybrid import CostModel

        self._cost_model = cost_model if cost_model is not None else CostModel()
        # Optional alternate intake (reference RedisRepo submit path,
        # ``utils_redis.py:16-48``): a QueueRepo of task-JSON payloads
        # drained by the schedule daemon through the normal submit path.
        self._intake_queue = intake_queue
        # task_id -> job_id for jobs THIS manager launched: the heartbeat's
        # scope. The row's job_id column cannot be it — a supervisor
        # reclaiming the task overwrites that column, which is exactly when
        # fencing must still see (and stop) our original job.
        self._own_jobs: Dict[str, str] = {}
        # Tasks fenced away from this manager (lease stolen while our job
        # was live): local resources were released at fencing time and the
        # row now belongs to the reclaimer — our daemons must not write it.
        self._fenced: set = set()
        # task_id -> monotonic submit-accept time: queue-wait measurement
        # for the ols_taskmgr_task_wait_seconds histogram (in_queue_time
        # has only 1 s resolution).
        self._queue_entered: Dict[str, float] = {}
        # Tasks mid-migration (pool scheduler fence window): their job is
        # deliberately stopped between fence and relaunch, and the release
        # loop must not finalize that transient as STOPPED.
        self._migrating: set = set()
        # (task_id, data_name) -> staged device-shard path (hybrid split)
        self._device_paths: dict = {}
        # task_id -> the temporary directories its local halves were staged
        # in, removed at the task's release
        self._staging_dirs: Dict[str, list] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads = []
        self._recover()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        """Boot recovery (reference ``get_taskqueue_from_repo``,
        ``task_manager.py:89-155``): re-queue QUEUED rows ordered by
        in_queue_time. Orphaned RUNNING rows (their engine job died with the
        previous process) are handled by posture:

        - ``supervise_orphans=True`` — resume-first: leave the row RUNNING
          with its (now expiring) lease; the supervisor reclaims it and
          relaunches through the checkpoint resume path;
        - ``supervise_orphans=False`` — legacy fail-fast: release frozen
          resources and mark FAILED (the pre-lease behavior)."""
        rows = sorted(
            (r for r in self._task_repo.query_all() if r.get("task_params")),
            key=lambda r: r.get("in_queue_time") or "",
        )
        for row in rows:
            status = row.get("task_status")
            task_id = row.get("task_id", "")
            if status == TaskStatus.QUEUED.name:
                try:
                    tc = json2taskconfig(row["task_params"])
                    self._task_queue.add(tc)
                except Exception as e:  # noqa: BLE001
                    self.logger.error(
                        task_id=task_id, system_name="TaskMgr",
                        module_name="recover", message=f"requeue failed: {e}",
                    )
            elif self._supervise_orphans and (
                status == TaskStatus.RUNNING.name
                or str(row.get("resource_occupied")) == "1"
            ):
                self.logger.info(
                    task_id=task_id, system_name="TaskMgr",
                    module_name="recover",
                    message="orphaned RUNNING task left for the supervisor "
                            "to reclaim on lease expiry",
                )
            elif str(row.get("resource_occupied")) == "1":
                self.logger.error(
                    task_id=task_id, system_name="TaskMgr", module_name="recover",
                    message="engine job lost across restart; releasing and failing",
                )
                if self._resource_manager is not None:
                    self._resource_manager.release_resource(task_id)
                self._task_repo.set_item_value(task_id, "resource_occupied", "0")
                self._task_repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
                self._task_repo.set_item_value(
                    task_id, "task_finished_time", time.strftime("%Y-%m-%d %H:%M:%S")
                )
            elif status == TaskStatus.RUNNING.name:
                # RUNNING row with no frozen resources: the process died
                # inside the launch window (after the status write, before
                # the resource_occupied flip) or the row was hand-edited.
                # Either way the in-process job is gone — mark it
                # interrupted-and-failed so it is never silently stuck
                # RUNNING forever with no job behind it.
                self.logger.error(
                    task_id=task_id, system_name="TaskMgr", module_name="recover",
                    message="RUNNING task has no engine job across restart; "
                            "marking interrupted (failed)",
                )
                self._task_repo.set_item_value(
                    task_id, "task_status", TaskStatus.FAILED.name
                )
                self._task_repo.set_item_value(
                    task_id, "task_finished_time",
                    time.strftime("%Y-%m-%d %H:%M:%S"),
                )

    def _default_runner_factory(self, tc, stop_event):
        from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

        return build_runner_from_taskconfig(
            tc, task_repo=self._task_repo, deviceflow=self._deviceflow,
            stop_event=stop_event, perf=self._perf,
            # The runner publishes into the same registry this manager
            # retires finished tasks' series from (series retention).
            registry=self._registry,
            # Telemetry->scheduler loop: with a pool scheduler attached,
            # every round's measured wall time refines the family's cost
            # estimate for the NEXT admission/packing decision.
            cost_oracle=(self._pool.oracle if self._pool is not None
                         else None),
            device=self._device,
        )

    # ------------------------------------------------------------------ RPCs
    def submit_task(self, tc) -> bool:
        """Reference ``submitTask`` (``task_manager.py:186-253``). ``tc`` — a
        :class:`TaskConfig`, or a task JSON string or dict (decoded by
        :func:`json2taskconfig`)."""
        if isinstance(tc, (str, dict)):
            tc = json2taskconfig(tc)
        ok, msg = validate_task_parameters(tc)
        task_id = tc.taskID.taskID
        if not ok:
            self.logger.error(task_id=task_id, system_name="TaskMgr",
                              module_name="submit_task", message=msg)
            return False
        with self._lock:
            if not self._task_repo.has_task(task_id):
                # The reference requires a pre-inserted UNDONE row from the
                # GUI backend (``task_manager.py:204-215``); standalone mode
                # creates it.
                if not self._auto_create_rows:
                    return False
                self._task_repo.add_task(task_id, task_status=TaskStatus.UNDONE.name,
                                         user_id=tc.userID)
            status = self._task_repo.get_item_value(task_id, "task_status")
            if status not in (TaskStatus.UNDONE.name, None):
                self.logger.error(
                    task_id=task_id, system_name="TaskMgr", module_name="submit_task",
                    message=f"task exists with status {status}, not UNDONE",
                )
                return False
            if task_id in self._task_queue:
                return False
            repo = self._task_repo
            if self._pool is not None:
                decision = self._pool.admit(tc, len(self._task_queue))
                if not decision.ok:
                    # Terminal by policy: an admission rejection fails the
                    # row loudly (admission_rejected event + metric already
                    # recorded by the pool) — the submitter resubmits as a
                    # new task once pressure clears. Never a silent queue,
                    # never a placement that runs a worker out of memory.
                    repo.set_item_value(task_id, "task_status",
                                        TaskStatus.FAILED.name)
                    repo.set_item_value(
                        task_id, "task_finished_time",
                        time.strftime("%Y-%m-%d %H:%M:%S"),
                    )
                    return False
            repo.set_item_value(task_id, "task_params", json.dumps(taskconfig2json(tc)))
            repo.set_item_value(
                task_id, "total_simulation", json.dumps(_total_simulation_entry(tc))
            )
            repo.set_item_value(task_id, "task_status", TaskStatus.QUEUED.name)
            repo.set_item_value(task_id, "in_queue_time", time.strftime("%Y-%m-%d %H:%M:%S"))
            repo.set_item_value(task_id, "resource_occupied", "0")
            self._task_queue.add(tc)
            self._queue_entered[task_id] = time.monotonic()
            self._update_queue_gauge()
            return True

    def _update_queue_gauge(self) -> None:
        from olearning_sim_tpu_torch.telemetry import default_registry, instrument

        if not default_registry().enabled:
            return
        instrument("ols_taskmgr_queue_depth").set(
            len(self._task_queue.get_task_ids())
        )

    def stop_task(self, task_id: str) -> bool:
        """Reference ``stop_task`` (``task_manager.py:358-455``)."""
        with self._lock:
            if task_id in self._task_queue:
                self._task_queue.delete(task_id)
                self._queue_entered.pop(task_id, None)
                if self._pool is not None:
                    self._pool.abort_launch(task_id)
                self._update_queue_gauge()
                self._task_repo.set_item_value(task_id, "task_status", TaskStatus.STOPPED.name)
                return True
            job_id = self._task_repo.get_item_value(task_id, "job_id")
            if job_id:
                self._launcher.stop_job(job_id)
                if self._phone_client is not None and \
                        self._task_repo.get_item_value(task_id, "device_target"):
                    # Reference stops the phone half too (task_manager.py:358-455).
                    self._phone_client.stop_device(task_id)
                self._task_repo.set_item_value(task_id, "task_status", TaskStatus.STOPPED.name)
                return True
            if self._task_repo.has_task(task_id):
                # Between queue removal and launch: mark STOPPED so the
                # in-flight _submit_scheduled aborts before launching.
                self._task_repo.set_item_value(task_id, "task_status", TaskStatus.STOPPED.name)
                return True
            return False

    def get_task_status(self, task_id: str) -> TaskStatus:
        """Status fusion (reference ``get_task_status``,
        ``task_manager.py:467-608``)."""
        with self._lock:
            if not self._task_repo.has_task(task_id):
                return TaskStatus.MISSING
            if task_id in self._task_queue:
                return TaskStatus.QUEUED
            occupied = str(self._task_repo.get_item_value(task_id, "resource_occupied"))
            if occupied == "1":
                job_id = self._task_repo.get_item_value(task_id, "job_id")
                logical_status = self._launcher.get_job_status(job_id) if job_id \
                    else TaskStatus.FAILED
                device_result = self._get_device_result(task_id)
                status = self._combine(task_id, logical_status, device_result)
                if status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.STOPPED):
                    self._task_repo.set_item_value(task_id, "task_status", status.name)
                return status
            stored = self._task_repo.get_item_value(task_id, "task_status")
            try:
                return TaskStatus[stored]
            except (KeyError, TypeError):
                return TaskStatus.MISSING

    def get_task_queue(self) -> list:
        return self._task_queue.get_task_ids()

    def get_resilience(self, task_id: str) -> Dict[str, Any]:
        """Resilience digest for one task (task status API surface): the
        runner-persisted per-task blob when present, else the live event
        log's per-task summary."""
        blob = self._task_repo.get_item_value(task_id, "resilience")
        if blob:
            try:
                return json.loads(blob)
            except (TypeError, ValueError):
                pass
        return self._resilience_log.summary(task_id)

    def change_scheduler(self, name: str) -> bool:
        try:
            self._strategy = StrategyFactory.create_strategy(name)
            return True
        except Exception:  # noqa: BLE001
            return False

    def _stage_hybrid_data(self, tc: TaskConfig) -> None:
        """Split real datasets between the halves per the (possibly ILP-
        mutated) allocation (reference HybridDataSplitter,
        ``utils_runner.py:195-382``): the logical half's ``dataPath`` is
        rewritten to its disjoint shard, the device shard's path rides to
        the phone job in ``_device_paths``. Only runs for target data with
        ``dataSplitType`` set, a real ``dataPath``, and device rounds > 0."""
        from olearning_sim_tpu_torch.data.hybrid_split import (
            device_fraction_of,
            stage_hybrid_split,
        )
        from olearning_sim_tpu_torch.storage import make_file_repo

        for td in tc.target.targetData:
            frac = device_fraction_of(td)
            if not (td.dataSplitType and td.dataPath and frac > 0.0):
                continue
            transfer = td.dataTransferType
            repo = None
            if transfer != 0:  # not FILE: upload both halves beside the original
                repo = make_file_repo(transfer)
            logical_path, device_path = stage_hybrid_split(
                td.dataPath, frac, transfer_type=transfer, repo=repo,
            )
            self._device_paths[(tc.taskID.taskID, td.dataName)] = device_path
            if repo is None:
                # Both halves sit in a temporary directory of their own.
                import os

                self._staging_dirs.setdefault(tc.taskID.taskID, []).append(
                    os.path.dirname(logical_path))
            td.dataPath = logical_path
            self.logger.info(
                task_id=tc.taskID.taskID, system_name="TaskMgr",
                module_name="hybrid",
                message=f"{td.dataName}: split {frac:.0%} to device half "
                        f"({device_path}); logical trains on {logical_path}",
            )

    def _cleanup_hybrid_staging(self, task_id: str) -> None:
        """Drop the task's staged hybrid shards (paths + local temp files) —
        releases otherwise leak one entry and two staged zips per task."""
        import os

        for key in [k for k in self._device_paths if k[0] == task_id]:
            path = self._device_paths.pop(key)
            if os.path.isfile(path):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _remove_staging_dirs(self, task_id: str) -> None:
        """Remove the directories the task's local halves were staged in,
        the logical half with them. Only at the release: a fenced task's
        reclaimer may still build its runner from the logical half. The JAX
        manager leaves them in the temporary directory."""
        import shutil

        for d in self._staging_dirs.pop(task_id, []):
            shutil.rmtree(d, ignore_errors=True)

    def _submit_device_half(self, tc: TaskConfig) -> bool:
        """Launch the phone (device-simulation) sub-job when the allocation
        routes device-rounds to phones (reference ``submit_phonejob``,
        ``task_runner.py:89-114``). Returns False when the phone job could
        not be launched (the caller fails the task)."""
        if self._phone_client is None:
            return True
        task_id = tc.taskID.taskID
        device_target = []
        for td in tc.target.targetData:
            nums = _device_nums(td)
            if nums:
                entry = {
                    "name": td.dataName,
                    "devices": list(td.totalSimulation.deviceTotalSimulation),
                    "nums": nums,
                }
                staged = self._device_paths.get((task_id, td.dataName))
                if staged:
                    # The phone job trains on its own disjoint shard
                    # (hybrid data split), not the full dataset.
                    entry["data_path"] = staged
                device_target.append(entry)
        if not device_target:
            return True
        ok = self._phone_client.submit_task(
            task_id,
            rounds=tc.operatorFlow.flowSetting.round,
            operators=[op.name for op in tc.operatorFlow.operator],
            data=device_target,
        )
        if not ok:
            self.logger.error(task_id=task_id, system_name="TaskMgr",
                              module_name="phone", message="phone job submit failed")
            return False
        self._task_repo.set_item_value(
            task_id, "device_target", json.dumps({"device_target": [
                {"name": d["name"],
                 "simulation_target": {"devices": d["devices"], "nums": d["nums"]}}
                for d in device_target
            ]})
        )
        return True

    # --------------------------------------------------------- status fusion
    def _get_device_result(self, task_id: str) -> Dict[str, Any]:
        """Phone-side progress via the PhoneMgr client; absent in standalone
        mode. Persists the device half so the status calculus reads both
        halves from the repo (reference ``task_manager.py:538-576``)."""
        if self._phone_client is None:
            return {"is_finished": True, "device_result": []}
        if not self._task_repo.get_item_value(task_id, "device_target"):
            # No device sub-job was launched for this task.
            return {"is_finished": True, "device_result": []}
        from olearning_sim_tpu_torch.resilience import faults

        def _poll():
            faults.inject("taskmgr.device_poll", context=task_id,
                          task_id=task_id)
            return self._phone_client.get_device_task_status(task_id)

        result = self._retry_policy.call(
            _poll, point="taskmgr.device_poll", task_id=task_id,
            log=self._resilience_log,
        )
        repo = self._task_repo
        repo.set_item_value(task_id, "device_round", result.get("round", 0))
        repo.set_item_value(task_id, "device_operator", result.get("operator", ""))
        repo.set_item_value(
            task_id, "device_result",
            json.dumps({"device_result": result.get("device_result", [])}),
        )
        return result

    def _half_state(self, task_id: str, prefix: str) -> SimHalfState:
        target_blob = self._task_repo.get_item_value(task_id, f"{prefix}_target")
        if not target_blob:
            return SimHalfState(present=False)
        result_blob = self._task_repo.get_item_value(task_id, f"{prefix}_result")
        rnd = self._task_repo.get_item_value(task_id, f"{prefix}_round")
        return SimHalfState(
            present=True,
            target=json.loads(target_blob).get(f"{prefix}_target", []),
            result=json.loads(result_blob).get(f"{prefix}_result", []) if result_blob else [],
            current_round=int(rnd) if rnd is not None else None,
            operator_name=self._task_repo.get_item_value(task_id, f"{prefix}_operator"),
        )

    def _combine(self, task_id: str, logical_status: TaskStatus,
                 device_result: Dict[str, Any]) -> TaskStatus:
        blob = self._task_repo.get_item_value(task_id, "total_simulation")
        if not blob:
            return TaskStatus.FAILED
        task_params = json.loads(blob)
        conditions = calculate_conditions(
            task_params,
            self._half_state(task_id, "logical"),
            self._half_state(task_id, "device"),
        )
        return combine_task_status(
            conditions, logical_status, device_result.get("is_finished", True)
        )

    # ------------------------------------------------------------ scheduling
    def drain_intake_once(self) -> int:
        """Pop every pending task-JSON payload off the alternate intake
        queue and submit it through the normal path (reference Redis-list
        ``submitTask`` variant, ``task_manager.py:255-345``). Returns the
        number of tasks accepted; malformed payloads are logged and dropped
        (they would fail validation identically on every retry)."""
        if self._intake_queue is None:
            return 0
        accepted = 0
        while True:
            payload = self._intake_queue.pop()
            if payload is None:
                return accepted
            try:
                tc = json2taskconfig(payload)
            except Exception as e:  # noqa: BLE001 — bad payload must not kill the daemon
                self.logger.error(
                    task_id="", system_name="TaskMgr",
                    module_name="drain_intake_once",
                    message=f"undecodable intake payload dropped: {e}",
                )
                continue
            if self.submit_task(tc):
                accepted += 1
            else:
                # The payload is consumed either way (retrying would fail
                # identically), but unlike the gRPC path no caller sees the
                # False — so the rejection must leave a trace.
                self.logger.error(
                    task_id=tc.taskID.taskID, system_name="TaskMgr",
                    module_name="drain_intake_once",
                    message="intake payload rejected by submit_task "
                            "(validation / duplicate / missing UNDONE row)",
                )

    def adopt_stranded_once(self, now: Optional[float] = None) -> int:
        """Re-queue QUEUED rows stranded by a dead sibling manager (see
        ``adopt_stranded_after``). Returns how many were adopted."""
        if self._adopt_stranded_after is None:
            return 0
        # Wall clock: in_queue_time is a wall-clock timestamp persisted
        # by (possibly dead) sibling processes.
        now = time.time() if now is None else now
        if now - self._last_adopt_scan < self._adopt_stranded_after:
            return 0
        self._last_adopt_scan = now
        adopted = 0
        for row in self._task_repo.query_all():
            if row.get("task_status") != TaskStatus.QUEUED.name:
                continue
            task_id = row.get("task_id", "")
            if not task_id or task_id in self._task_queue:
                continue
            in_queue = row.get("in_queue_time")
            if not in_queue:
                continue
            try:
                queued_at = time.mktime(
                    time.strptime(in_queue, "%Y-%m-%d %H:%M:%S"))
            except ValueError:
                continue
            if now - queued_at < self._adopt_stranded_after:
                continue
            try:
                tc = json2taskconfig(row["task_params"])
            except Exception as e:  # noqa: BLE001
                self.logger.error(
                    task_id=task_id, system_name="TaskMgr",
                    module_name="adopt",
                    message=f"stranded QUEUED row undecodable: {e}",
                )
                continue
            with self._lock:
                if self._task_queue.add(tc):
                    adopted += 1
                    self.logger.info(
                        task_id=task_id, system_name="TaskMgr",
                        module_name="adopt",
                        message="adopted stranded QUEUED task from a dead "
                                "sibling manager's queue",
                    )
        if adopted:
            self._update_queue_gauge()
        return adopted

    def schedule_once(self) -> Optional[str]:
        """One scheduler iteration (reference ``run`` thread body,
        ``task_manager.py:1053-1069``); returns the launched task id."""
        self.drain_intake_once()
        self.adopt_stranded_once()
        with self._lock:
            queue = self._task_queue.get_task_queue()
        if not queue:
            return None
        available = (
            self._resource_manager.get_resource()
            if self._resource_manager is not None
            else {"logical_simulation": {"cpu": float("inf"), "mem": float("inf")},
                  "device_simulation": {}}
        )
        result = self._strategy.schedule_next_task(queue, available)
        if result is None:
            return None
        task_id = result.task.taskID.taskID
        with self._lock:
            if not self._task_queue.delete(task_id):
                # stop_task removed it between snapshot and here
                return None
            self._update_queue_gauge()
            self._submit_scheduled(result)
        return task_id

    def _submit_scheduled(self, result: ScheduleResult) -> None:
        """Freeze -> register deviceflow -> launch (reference
        ``threading_submit_task``, ``task_manager.py:917-1051``)."""
        launched = False
        try:
            launched = bool(self._submit_scheduled_inner(result))
        finally:
            if not launched:
                # The task left the queue on every failure path too —
                # drop its wait-clock entry (leaks otherwise) and the
                # pool's pending placement.
                self._queue_entered.pop(result.task.taskID.taskID, None)
                if self._pool is not None:
                    self._pool.abort_launch(result.task.taskID.taskID)

    def _submit_scheduled_inner(self, result: ScheduleResult) -> bool:
        tc = result.task
        task_id = tc.taskID.taskID
        repo = self._task_repo
        # Exactly-once across managers: another manager sharing this task
        # table may have launched (or finished) the task since it entered
        # OUR in-memory queue (boot recovery re-queues every QUEUED row).
        # Launch only a task that is still QUEUED; anything else belongs
        # to whoever moved it on.
        stored = repo.get_item_value(task_id, "task_status")
        if stored not in (TaskStatus.QUEUED.name, None):
            return False
        if any(td.allocation.optimization for td in tc.target.targetData):
            # Hybrid ILP allocation before launch (reference
            # HybridOptimizer.fix_data_parameters, utils_runner.py:29-51).
            from olearning_sim_tpu_torch.taskmgr.hybrid import fix_data_parameters

            try:
                fix_data_parameters(tc, self._cost_model)
            except Exception as e:  # noqa: BLE001
                self.logger.error(task_id=task_id, system_name="TaskMgr",
                                  module_name="hybrid", message=f"allocation failed: {e}")
                repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
                return False
        try:
            self._stage_hybrid_data(tc)
        except Exception as e:  # noqa: BLE001
            self.logger.error(task_id=task_id, system_name="TaskMgr",
                              module_name="hybrid",
                              message=f"hybrid data split failed: {e}")
            repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
            return False
        if repo.get_item_value(task_id, "task_status") == TaskStatus.STOPPED.name:
            return False  # stopped while being scheduled
        # Persist the (possibly allocator-mutated) config and the logical
        # half's target BEFORE launch, so status fusion never sees an
        # occupied task with a vacuously-absent logical half.
        repo.set_item_value(task_id, "task_params", json.dumps(taskconfig2json(tc)))
        logical_target = [
            {
                "name": td.dataName,
                "simulation_target": {
                    "devices": list(td.totalSimulation.deviceTotalSimulation),
                    "nums": _logical_nums(td),
                },
            }
            for td in tc.target.targetData
        ]
        repo.set_item_value(
            task_id, "logical_target", json.dumps({"logical_target": logical_target})
        )
        if self._resource_manager is not None:
            req = result.task_request["logical_simulation"]
            if not self._resource_manager.request_cluster_resource(
                task_id, tc.userID, req["cpu"], req["mem"]
            ):
                repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
                return False
            # Freeze the phone share too (reference 2-phase freeze,
            # task_scheduler.py:71-174) so concurrent hybrid tasks cannot
            # oversubscribe the farm behind the scheduler's back.
            for user_id, phones in result.task_request.get(
                "device_simulation", {}
            ).items():
                if phones and not self._resource_manager.request_phone_resource(
                    task_id, user_id, phones
                ):
                    self._resource_manager.release_resource(task_id)
                    repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
                    return False
        if self._deviceflow is not None:
            uses_flow = any(
                op.operationBehaviorController.useController
                for op in tc.operatorFlow.operator
            )
            if uses_flow:
                # Reference DeviceflowResgister (utils_runner.py:630-671).
                self._deviceflow.register_task(task_id, ["logical_simulation"])
        if not self._submit_device_half(tc):
            # A task whose device share cannot run must not report success
            # with device-rounds silently dropped.
            if self._resource_manager is not None:
                self._resource_manager.release_resource(task_id)
            repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
            return False
        # Ownership BEFORE launch and BEFORE the RUNNING write: a RUNNING
        # row with no lease reads as expired, so writing status first would
        # open a window where a supervisor reclaims (and relaunches) the
        # task while our job is coming up. A failed claim means another
        # process holds a live lease on this task — refuse the double
        # launch outright and leave the row to its owner (multi-manager
        # deployments share one task table; stamping FAILED here would
        # stomp the owner's live run).
        if not self._task_repo.claim_lease(task_id, self.owner_id,
                                           self.lease_ttl):
            self.logger.error(
                task_id=task_id, system_name="TaskMgr", module_name="submit",
                message="another process holds a live lease on this task; "
                        "refusing to double-launch (its owner drives it)",
            )
            if self._phone_client is not None and \
                    repo.get_item_value(task_id, "device_target"):
                self._phone_client.stop_device(task_id)
            if self._resource_manager is not None:
                self._resource_manager.release_resource(task_id)
            return False
        try:
            from olearning_sim_tpu_torch.resilience import faults

            attempt = [0]

            def _submit():
                # Idempotence under retry: submit is not transactional — a
                # failure after the launcher registered the job must not
                # launch a second runner against the same task row and
                # checkpoint directory on the retry attempt. Retry attempts
                # only (the first attempt must always launch — a stale LIVE
                # record from a prior submission of this task_id must not
                # satisfy a fresh submission), and only a LIVE record
                # short-circuits.
                attempt[0] += 1
                if attempt[0] > 1:
                    existing = self._launcher.get_job_status(f"job-{task_id}")
                    if existing in (TaskStatus.PENDING, TaskStatus.RUNNING):
                        return f"job-{task_id}"
                faults.inject("taskmgr.submit_job", context=task_id,
                              task_id=task_id)
                return self._launcher.submit(
                    lambda stop_event: self._runner_factory(tc, stop_event),
                    job_id=f"job-{task_id}",
                )

            job_id = self._retry_policy.call(
                _submit, point="taskmgr.submit_job", task_id=task_id,
                log=self._resilience_log,
            )
        except Exception as e:  # noqa: BLE001
            self.logger.error(task_id=task_id, system_name="TaskMgr",
                              module_name="submit", message=f"launch failed: {e}")
            if self._phone_client is not None and \
                    repo.get_item_value(task_id, "device_target"):
                # The phone half launched before the engine failed; stop it so
                # it doesn't run (and hold farm state) for a dead task.
                self._phone_client.stop_device(task_id)
            if self._resource_manager is not None:
                self._resource_manager.release_resource(task_id)
            repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
            self._task_repo.release_lease(task_id, self.owner_id)
            return False
        repo.set_item_value(task_id, "job_id", job_id)
        repo.set_item_value(task_id, "task_status", TaskStatus.RUNNING.name)
        repo.set_item_value(task_id, "resource_occupied", "1")
        repo.set_item_value(task_id, "submit_task_time", time.strftime("%Y-%m-%d %H:%M:%S"))
        # The heartbeat daemon renews the lease claimed above while the job
        # lives; if this process dies, expiry is the supervisor's signal.
        self._own_jobs[task_id] = job_id
        entered = self._queue_entered.pop(task_id, None)
        if entered is not None:
            from olearning_sim_tpu_torch.telemetry import instrument

            instrument("ols_taskmgr_task_wait_seconds").observe(
                time.monotonic() - entered
            )
        if self._pool is not None:
            # Consume the pending placement: the worker's memory share is
            # charged and the row's worker_id records where it landed.
            self._pool.on_launched(task_id)
        return True

    # ------------------------------------------------------- release/interrupt
    def release_once(self) -> None:
        """Release finished tasks (reference ``releaseResource`` thread,
        ``task_manager.py:1071-1148``): job terminal -> release resources,
        unregister deviceflow once dispatch drained, stamp finish time."""
        for row in self._task_repo.query_all():
            if str(row.get("resource_occupied")) != "1":
                continue
            task_id = row["task_id"]
            if task_id in self._fenced:
                # Another process reclaimed this task (heartbeat fencing):
                # the row — including its final status — is theirs to write.
                continue
            if task_id in self._migrating:
                # Planned preemption in flight: the stopped job is a fence,
                # not a terminal state — the pool scheduler relaunches it.
                continue
            job_id = row.get("job_id")
            if self._supervise_orphans and job_id and \
                    self._launcher.get_job(job_id) is None:
                # Resume-first posture: a job id our launcher has never seen
                # is an orphan awaiting the supervisor (or a supervisor's
                # relaunch in another process) — MISSING-failing it here
                # would beat the reclaim to the row.
                continue
            status = self._launcher.get_job_status(job_id) if job_id else TaskStatus.FAILED
            if status in (TaskStatus.PENDING, TaskStatus.RUNNING):
                continue
            if self._deviceflow is not None:
                if not self._deviceflow.check_dispatch_finished(task_id):
                    continue  # retry next cycle (reference :1104-1121)
                self._deviceflow.unregister_task(task_id)
            if self._resource_manager is not None:
                self._resource_manager.release_resource(task_id)
            if status == TaskStatus.MISSING:
                # job record lost (shouldn't happen in-process): fail loudly
                final = TaskStatus.FAILED
            else:
                final = self.get_task_status(task_id)
            job = self._launcher.get_job(job_id) if job_id else None
            if job is not None and job.error:
                # The engine job's exception (a runner that failed to build
                # or run on its device): the row says why it failed.
                self._task_repo.set_item_value(task_id, "job_error", job.error)
            self._task_repo.set_item_value(task_id, "resource_occupied", "0")
            self._task_repo.set_item_value(task_id, "task_status", final.name)
            self._task_repo.set_item_value(
                task_id, "task_finished_time", time.strftime("%Y-%m-%d %H:%M:%S")
            )
            self._task_repo.release_lease(task_id, self.owner_id)
            self._own_jobs.pop(task_id, None)
            self._cleanup_hybrid_staging(task_id)
            self._remove_staging_dirs(task_id)
            if self._pool is not None:
                self._pool.on_finished(task_id)
            # Series retention: the finished task's per-task label series
            # (ols_engine_*{task_id=...}, ols_resilience_events_total)
            # are retired — a long-lived server otherwise leaks one
            # labeled series per completed task forever.
            self._retire_task_series(task_id)

    def _retire_task_series(self, task_id: str) -> None:
        """Drop every metric series labeled with this (terminal) task's id
        from the registry (MetricsRegistry.retire_label_value)."""
        from olearning_sim_tpu_torch.telemetry import default_registry

        reg = (self._registry if self._registry is not None
               else default_registry())
        reg.retire_label_value("task_id", task_id)

    def heartbeat_once(self, now: Optional[float] = None) -> None:
        """Renew the lease of every task this process owns whose engine job
        is live. A failed renewal means another process stole the lease
        (this process was presumed dead — e.g. it wedged past the TTL):
        fence ourselves by stopping the job, so exactly one process ever
        drives a task (the reclaimer's resumed job is now the task of
        record)."""
        # Wall clock: renewals compare/extend the repo's persisted
        # cross-process lease timestamps (see task_repo).
        now = now if now is not None else time.time()
        # Scope: jobs THIS manager launched (not the row's job_id column —
        # a supervisor reclaim overwrites that, and fencing must still see
        # our original job then). Renewal continues while the row is still
        # occupied even after the job goes terminal: the release loop can
        # legitimately hold a finished task occupied past the TTL (deviceflow
        # drain gate), and an expired lease would invite a pointless reclaim
        # of a completed task. release_once pops the entry at finalization.
        for task_id, job_id in list(self._own_jobs.items()):
            status = self._launcher.get_job_status(job_id)
            if self._task_repo.renew_lease(
                task_id, self.owner_id, self.lease_ttl, now=now
            ):
                continue
            # Renewal failed: confirm before acting — a transient DB error
            # also answers False, and killing a healthy job over a DB blip
            # (then resuming it from checkpoint) would burn resume budget
            # for nothing.
            owner, _ = self._task_repo.lease_info(task_id)
            if owner == self.owner_id:
                self.logger.warning(
                    task_id=task_id, system_name="TaskMgr",
                    module_name="heartbeat",
                    message="lease renewal failed but we still own the row "
                            "(transient repo error?); retrying next beat",
                )
                continue
            if owner == "":
                # Unowned: nothing else is driving the task — re-establish
                # rather than fence (fencing would kill a healthy job).
                self._task_repo.claim_lease(task_id, self.owner_id,
                                            self.lease_ttl, now=now)
                continue
            if status not in (TaskStatus.PENDING, TaskStatus.RUNNING):
                # Terminal job whose row another process took over: stand
                # down — the new owner writes the final status — but OUR
                # frozen resources and staging are still ours to release
                # (release_once skips fenced rows and would otherwise leak
                # them forever).
                self._own_jobs.pop(task_id, None)
                self._fenced.add(task_id)
                if self._resource_manager is not None:
                    self._resource_manager.release_resource(task_id)
                self._cleanup_hybrid_staging(task_id)
                if self._pool is not None:
                    self._pool.on_finished(task_id)
                continue
            self.logger.error(
                task_id=task_id, system_name="TaskMgr",
                module_name="heartbeat",
                message="lease stolen (this process was presumed dead); "
                        "fencing: stopping the local engine job",
            )
            self._launcher.stop_job(job_id)
            self._own_jobs.pop(task_id, None)
            # Hand the row over wholesale: release OUR frozen resources
            # and staging, and never let release_once overwrite the
            # reclaimer's status with our stopped job's.
            self._fenced.add(task_id)
            if self._resource_manager is not None:
                self._resource_manager.release_resource(task_id)
            self._cleanup_hybrid_staging(task_id)
            if self._pool is not None:
                self._pool.on_finished(task_id)

    def interrupt_once(self, now: Optional[float] = None) -> None:
        """Watchdog (reference ``interruptTask``, ``task_manager.py:1150-1200``):
        kill tasks queued or running beyond their timeouts."""
        # Wall clock: compared against in_queue_time / submit_task_time,
        # wall-clock strings persisted by other processes.
        now = now if now is not None else time.time()
        for row in self._task_repo.query_all():
            task_id = row["task_id"]
            status = row.get("task_status")
            if status == TaskStatus.QUEUED.name and row.get("in_queue_time"):
                queued_at = time.mktime(time.strptime(row["in_queue_time"], "%Y-%m-%d %H:%M:%S"))
                if now - queued_at > self._interrupt_queue_time:
                    self.stop_task(task_id)
            elif status == TaskStatus.RUNNING.name and row.get("submit_task_time"):
                started_at = time.mktime(
                    time.strptime(row["submit_task_time"], "%Y-%m-%d %H:%M:%S")
                )
                if now - started_at > self._interrupt_running_time:
                    self.stop_task(task_id)

    # --------------------------------------------------------------- threads
    def start(self) -> None:
        """Reference daemon threads (``task_manager.py:79-84``)."""
        self._stop.clear()
        daemons = [
            (self.schedule_once, self._schedule_interval, "taskmgr-schedule"),
            (self.release_once, self._release_interval, "taskmgr-release"),
            (self.interrupt_once, self._interrupt_interval, "taskmgr-interrupt"),
            (self.heartbeat_once, self._heartbeat_interval, "taskmgr-heartbeat"),
        ]
        if self._pool is not None:
            daemons.append((self._pool.rebalance_once,
                            self._rebalance_interval, "taskmgr-rebalance"))
        for fn, interval, name in daemons:
            t = threading.Thread(
                target=self._loop, args=(fn, interval), name=name, daemon=True
            )
            t.start()
            self._threads.append(t)

    def _loop(self, fn, interval: float) -> None:
        while not self._stop.is_set():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — keep daemons alive
                self.logger.error(task_id="", system_name="TaskMgr",
                                  module_name="loop", message=f"{fn.__name__}: {e}")
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
