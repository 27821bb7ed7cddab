"""TaskSupervisor: lease-expiry reclaim + resume-from-checkpoint relaunch.

Recovery protocol per scan (:meth:`TaskSupervisor.scan_once`):

1. **Fence & finalize own jobs** — tasks this supervisor relaunched are
   heartbeated (lease renewed while the job is live) and finalized when the
   job reaches a terminal state (status row written, resources released,
   lease dropped) so a standalone supervisor needs no TaskManager release
   loop behind it.
2. **Reclaim** — a RUNNING row whose lease expired before ``now`` lost its
   owner process. Subject to crash-loop backoff, the supervisor claims the
   lease (atomic CAS — two supervisors racing on one DB produce exactly one
   winner), records ``lease_expired`` and the lease-age histogram, and
   bumps the task's durable resume counter.
3. **Relaunch** — resources are re-frozen, durable deviceflow rooms are
   re-attached (task re-registration; the sqlite-backed rooms recovered
   their staged messages at open), and the engine job is re-submitted under
   a fresh job id. The runner's ``_try_resume`` restores the last committed
   checkpoint and replays from there, bitwise. Recorded as ``task_resumed``
   + ``ols_supervisor_resumes_total``.
4. **Crash-loop quarantine** — when the durable resume counter exceeds the
   budget, the task is failed through ``FailurePolicy.FAIL_TASK`` semantics
   (released, FAILED, ``crash_loop`` event) instead of being relaunched
   forever.

Fault-injection points: ``supervisor.reclaim`` (before the lease claim) and
``supervisor.relaunch`` (before the job submit) — docs/resilience.md.

A copy of the JAX package's ``supervisor/supervisor.py`` over the port's
task manager, repo and runners (a standalone supervisor builds them on its
``device``, ``"cuda"`` unless the caller asks for the CPU). The JAX
supervisor also enables XLA's persistent compile cache so that relaunches
deserialize their round programs; eager PyTorch compiles nothing (ROADMAP
A11), so there is no counterpart and that step is dropped.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Callable, Dict, Optional

from olearning_sim_tpu_torch.resilience import (
    CRASH_LOOP,
    LEASE_EXPIRED,
    TASK_RESUMED,
    FailurePolicy,
    faults,
)
from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.resilience.events import global_log
from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
from olearning_sim_tpu_torch.taskmgr.jobs import LocalJobLauncher
from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
from olearning_sim_tpu_torch.utils.logging import Logger


class TaskSupervisor:
    """Scan-and-reclaim daemon over the task table.

    Construct over a live :class:`TaskManager` (shares its repo, launcher,
    resource manager, deviceflow, runner factory, and owner id — so the
    manager's heartbeat also covers re-adopted tasks) or standalone over a
    ``task_repo`` (crash recovery for a control plane whose manager died
    with the host).
    """

    def __init__(
        self,
        task_manager=None,
        *,
        task_repo: Optional[TaskTableRepo] = None,
        launcher: Optional[LocalJobLauncher] = None,
        resource_manager=None,
        deviceflow=None,
        runner_factory: Optional[Callable] = None,
        owner_id: Optional[str] = None,
        lease_ttl: Optional[float] = None,
        scan_interval: Optional[float] = None,
        resume_budget: int = 3,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 300.0,
        failure_policy: FailurePolicy = FailurePolicy.FAIL_TASK,
        log=None,
        logger: Optional[Logger] = None,
        registry=None,
        device="cuda",
    ):
        """``resume_budget`` — total resumes a task may consume over its
        lifetime (durable: rides the task row's ``supervision`` column, so
        supervisor restarts don't refill it). ``backoff_base_s`` — crash-loop
        backoff: resume ``n`` waits ``backoff_base_s * 2**(n-1)`` seconds
        (capped at ``backoff_max_s``) after the previous resume before the
        task is eligible again. ``failure_policy`` — what budget exhaustion
        degrades to; only :attr:`FailurePolicy.FAIL_TASK` is meaningful for
        a whole task and anything else raises. ``device`` — where a
        standalone supervisor's default runner factory builds runners
        (an attached one uses its manager's factory)."""
        if failure_policy != FailurePolicy.FAIL_TASK:
            raise ValueError(
                "task-level crash-loop quarantine supports only "
                "FailurePolicy.FAIL_TASK (a dead process has no round to "
                f"skip or retry); got {failure_policy}"
            )
        self._mgr = task_manager
        if task_manager is not None:
            self.task_repo = task_manager._task_repo
            self.launcher = launcher or task_manager._launcher
            self.resource_manager = (resource_manager
                                     or task_manager._resource_manager)
            self.deviceflow = deviceflow or task_manager._deviceflow
            self._runner_factory = (runner_factory
                                    or task_manager._runner_factory)
            self.owner_id = owner_id or task_manager.owner_id
            self.lease_ttl = (lease_ttl if lease_ttl is not None
                              else task_manager.lease_ttl)
        else:
            if task_repo is None:
                raise ValueError("need a task_manager or a task_repo")
            self.task_repo = task_repo
            self.launcher = launcher if launcher is not None \
                else LocalJobLauncher()
            self.resource_manager = resource_manager
            self.deviceflow = deviceflow
            self._device = resolve_device(device)
            self._runner_factory = runner_factory or self._default_runner_factory
            if owner_id is None:
                from olearning_sim_tpu_torch.taskmgr.task_repo import make_owner_id

                owner_id = make_owner_id("supervisor")
            self.owner_id = owner_id
            self.lease_ttl = float(lease_ttl) if lease_ttl is not None else 60.0
        self.scan_interval = (scan_interval if scan_interval is not None
                              else max(self.lease_ttl / 3.0, 0.05))
        self.resume_budget = int(resume_budget)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.failure_policy = failure_policy
        self.log = log if log is not None else global_log()
        self.logger = logger if logger is not None else Logger()
        self.registry = registry
        # Jobs this supervisor launched: task_id -> job_id (heartbeat +
        # terminal finalization scope; never another manager's jobs).
        self._jobs: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- relaunching
    def _default_runner_factory(self, tc, stop_event):
        from olearning_sim_tpu_torch.engine.task_bridge import (
            build_runner_from_taskconfig,
        )

        return build_runner_from_taskconfig(
            tc, task_repo=self.task_repo, deviceflow=self.deviceflow,
            stop_event=stop_event, registry=self.registry,
            device=self._device,
        )

    # ---------------------------------------------------------------- scans
    def scan_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One supervision pass; returns a digest
        ``{"renewed": [...], "resumed": [...], "failed": [...],
        "finalized": [...]}`` for tests and operators. ``now`` overrides
        wall-clock for deterministic tests."""
        # Wall clock: expiry scans compare lease_expires timestamps
        # persisted by the owning worker process.
        now = time.time() if now is None else now
        digest: Dict[str, Any] = {"renewed": [], "resumed": [], "failed": [],
                                  "finalized": [], "fenced": []}
        for row in self.task_repo.query_all():
            task_id = row.get("task_id", "")
            try:
                self._scan_row(row, task_id, now, digest)
            except Exception as e:  # noqa: BLE001 — one task must not
                # starve the rest of the scan (injected faults land here).
                self.logger.error(
                    task_id=task_id, system_name="Supervisor",
                    module_name="scan", message=f"scan failed: {e}",
                )
        return digest

    def _scan_row(self, row: Dict[str, Any], task_id: str, now: float,
                  digest: Dict[str, Any]) -> None:
        status = row.get("task_status")
        if status != TaskStatus.RUNNING.name:
            return
        owner = row.get("owner_id") or ""
        if owner == self.owner_id:
            self._tend_own(row, task_id, now, digest)
            return
        if not self.task_repo.lease_expired(row, now):
            return  # live lease: its owner is heartbeating
        if not self._backoff_elapsed(row, now):
            return  # crash-looping: not eligible again yet
        self._reclaim(row, task_id, now, digest)

    def _tend_own(self, row: Dict[str, Any], task_id: str, now: float,
                  digest: Dict[str, Any]) -> None:
        """Heartbeat / finalize / crash-detect a task this supervisor owns."""
        job_id = self._jobs.get(task_id)
        if job_id is None:
            if self._mgr is not None:
                # Attached mode shares the manager's owner id, so every
                # manager-launched job reads as "ours" here — but those are
                # the manager's to heartbeat, release, and fail (its release
                # loop also handles deviceflow drain + hybrid staging).
                # Tending them here would race it with divergent semantics.
                return
            # Standalone supervisor restarted under a recycled owner_id:
            # adopt the row's job id if it exists, else let the lease lapse
            # and the reclaim path take it.
            job_id = row.get("job_id") or ""
        job_status = self.launcher.get_job_status(job_id)
        if job_status in (TaskStatus.PENDING, TaskStatus.RUNNING):
            if self.task_repo.renew_lease(task_id, self.owner_id,
                                          self.lease_ttl, now=now):
                digest["renewed"].append(task_id)
                return
            # Renewal failed: confirm a real steal before fencing — a
            # transient repo error also answers False (mirror of
            # TaskManager.heartbeat_once's discipline).
            owner, _ = self.task_repo.lease_info(task_id)
            if owner in (self.owner_id, ""):
                if owner == "":
                    self.task_repo.claim_lease(task_id, self.owner_id,
                                               self.lease_ttl, now=now)
                return
            # Stolen between the row read and the renewal (we stalled past
            # the TTL and a standby reclaimed): fence ourselves — two jobs
            # must never drive one task or share one checkpoint dir.
            self.logger.error(
                task_id=task_id, system_name="Supervisor",
                module_name="scan",
                message="lease stolen mid-resume; fencing: stopping "
                        "the relaunched engine job",
            )
            self.launcher.stop_job(job_id)
            self._jobs.pop(task_id, None)
            if self.resource_manager is not None:
                self.resource_manager.release_resource(task_id)
            digest["fenced"].append(task_id)
            return
        if job_status in (TaskStatus.SUCCEEDED, TaskStatus.STOPPED):
            self._finalize(task_id, job_status, digest)
            return
        # FAILED / MISSING while the row says RUNNING: the relaunched worker
        # died again. Counts as a consecutive crash — resume or quarantine.
        if self._backoff_elapsed(row, now):
            self._reclaim(row, task_id, now, digest, reason="worker_died")

    def _finalize(self, task_id: str, final: TaskStatus,
                  digest: Dict[str, Any]) -> None:
        if self.deviceflow is not None:
            # Mirror TaskManager.release_once: let the dispatch drain, then
            # unregister — releasing first would strand staged messages.
            try:
                if not self.deviceflow.check_dispatch_finished(task_id):
                    return  # retry on a later scan
                self.deviceflow.unregister_task(task_id)
            except Exception:  # lint: allow-silent — a deviceflow hiccup
                pass           # must not block finalization; scan retries
        self.task_repo.set_item_value(task_id, "resource_occupied", "0")
        self.task_repo.set_item_value(task_id, "task_status", final.name)
        self.task_repo.set_item_value(
            task_id, "task_finished_time", time.strftime("%Y-%m-%d %H:%M:%S")
        )
        if self.resource_manager is not None:
            self.resource_manager.release_resource(task_id)
        self.task_repo.release_lease(task_id, self.owner_id)
        self._jobs.pop(task_id, None)
        digest["finalized"].append(task_id)

    # --------------------------------------------------------------- reclaim
    def _supervision(self, row: Dict[str, Any]) -> Dict[str, Any]:
        # Shared ledger with the chip-pool scheduler's planned migrations
        # (taskmgr/pool.py): crash resumes and migrations charge the same
        # durable budget, so neither can livelock past it alone.
        from olearning_sim_tpu_torch.taskmgr.task_repo import parse_supervision

        return parse_supervision(row.get("supervision"))

    def _backoff_elapsed(self, row: Dict[str, Any], now: float) -> bool:
        sup = self._supervision(row)
        resumes = int(sup.get("resumes", 0))
        if resumes <= 0:
            return True
        delay = min(self.backoff_base_s * (2.0 ** (resumes - 1)),
                    self.backoff_max_s)
        return now - float(sup.get("last_resume_ts", 0.0)) >= delay

    def _reclaim(self, row: Dict[str, Any], task_id: str, now: float,
                 digest: Dict[str, Any], reason: str = "lease_expired") -> None:
        faults.inject("supervisor.reclaim", context=task_id, task_id=task_id)
        try:
            expires: Optional[float] = float(row.get("lease_expires"))
        except (TypeError, ValueError):
            expires = None
        if not self.task_repo.claim_lease(task_id, self.owner_id,
                                          self.lease_ttl, now=now):
            return  # another supervisor won the race
        # Lease age: how stale the dead owner's lease was when reclaimed —
        # the recovery-latency half an operator tunes TTL against.
        lease_age = max(0.0, now - expires) if expires is not None else 0.0
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_supervisor_lease_age_seconds", self.registry).labels(
            task_id=task_id
        ).observe(lease_age)
        self.log.record(
            LEASE_EXPIRED, point="supervisor.reclaim", task_id=task_id,
            lease_age_s=lease_age, reason=reason,
        )
        sup = self._supervision(row)
        resumes = int(sup.get("resumes", 0))
        if resumes >= self.resume_budget:
            self._quarantine_crash_loop(task_id, resumes, digest)
            return
        sup.update(resumes=resumes + 1, last_resume_ts=now)
        self.task_repo.set_item_value(task_id, "supervision", json.dumps(sup))
        try:
            self._relaunch(row, task_id, resumes + 1)
        except Exception as e:  # noqa: BLE001 — a failed relaunch burns the
            # attempt (the backoff gate spaces the next one) but must not
            # kill the scan. Release the lease OUTRIGHT — merely backdating
            # lease_expires would leave owner == us, and in attached mode
            # every later scan routes our own rows to _tend_own (which
            # defers manager-launched work), wedging the task forever.
            self.logger.error(
                task_id=task_id, system_name="Supervisor",
                module_name="relaunch", message=f"relaunch failed: {e}",
            )
            self.task_repo.release_lease(task_id, self.owner_id)
            return
        digest["resumed"].append(task_id)

    def _quarantine_crash_loop(self, task_id: str, resumes: int,
                               digest: Dict[str, Any]) -> None:
        """Budget exhausted: degrade through FailurePolicy.FAIL_TASK — the
        task fails loudly instead of being relaunched forever."""
        self.logger.error(
            task_id=task_id, system_name="Supervisor", module_name="reclaim",
            message=f"crash loop: {resumes} resumes exhausted the budget of "
                    f"{self.resume_budget}; failing task",
        )
        if self.resource_manager is not None:
            self.resource_manager.release_resource(task_id)
        self.task_repo.set_item_value(task_id, "resource_occupied", "0")
        self.task_repo.set_item_value(task_id, "task_status",
                                      TaskStatus.FAILED.name)
        self.task_repo.set_item_value(
            task_id, "task_finished_time", time.strftime("%Y-%m-%d %H:%M:%S")
        )
        self.task_repo.release_lease(task_id, self.owner_id)
        self._jobs.pop(task_id, None)
        self.log.record(
            CRASH_LOOP, point="supervisor.reclaim", task_id=task_id,
            resumes=resumes, budget=self.resume_budget,
            policy=self.failure_policy.value,
        )
        digest["failed"].append(task_id)

    def _relaunch(self, row: Dict[str, Any], task_id: str,
                  attempt: int) -> None:
        tc = json2taskconfig(row["task_params"])
        # Re-freeze resources: the dead process's in-memory ledger freeze
        # died with it; an in-process ledger (wedged-job takeover) may still
        # hold the task's share — release first so the re-request is not a
        # double freeze.
        if self.resource_manager is not None:
            from olearning_sim_tpu_torch.taskmgr.scheduler import (
                get_task_request_resource,
            )

            with contextlib.suppress(Exception):
                self.resource_manager.release_resource(task_id)
            req = get_task_request_resource(tc)["logical_simulation"]
            if not self.resource_manager.request_cluster_resource(
                task_id, tc.userID, req["cpu"], req["mem"]
            ):
                raise RuntimeError("resource re-freeze failed")
        # Re-attach durable deviceflow rooms: registration is what lets the
        # resumed rounds open flows again; the sqlite-backed rooms already
        # recovered their staged (claimed-but-unacked) messages at open.
        if self.deviceflow is not None and any(
            op.operationBehaviorController.useController
            for op in tc.operatorFlow.operator
        ):
            with contextlib.suppress(Exception):
                self.deviceflow.register_task(task_id, ["logical_simulation"])
        faults.inject("supervisor.relaunch", context=task_id, task_id=task_id)
        # Fresh job id per resume: the dead attempt's job record (if this
        # launcher saw it) must never answer status for the new one.
        job_id = self.launcher.submit(
            lambda stop_event: self._runner_factory(tc, stop_event),
            job_id=f"job-{task_id}~s{attempt}",
        )
        self.task_repo.set_item_value(task_id, "job_id", job_id)
        self.task_repo.set_item_value(task_id, "resource_occupied", "1")
        self._jobs[task_id] = job_id
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_supervisor_resumes_total", self.registry).labels(
            task_id=task_id
        ).inc()
        self.log.record(
            TASK_RESUMED, point="supervisor.relaunch", task_id=task_id,
            job_id=job_id, attempt=attempt,
        )
        self.logger.info(
            task_id=task_id, system_name="Supervisor", module_name="relaunch",
            message=f"re-adopted as {job_id} (resume {attempt}); engine will "
                    f"resume from the last committed checkpoint",
        )

    # -------------------------------------------------------------- daemon
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="supervisor-scan", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scan_once()
            except Exception as e:  # noqa: BLE001 — keep the daemon alive
                self.logger.error(
                    task_id="", system_name="Supervisor", module_name="loop",
                    message=f"scan_once: {e}",
                )
            self._stop.wait(self.scan_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
