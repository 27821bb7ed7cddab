"""Chip-pool control plane: cost-model admission, bin-packing, planned
preemption & migration.

A copy of the JAX package's ``taskmgr/pool.py`` over the port's
``TaskConfig`` dataclasses, with the same decisions on the same inputs:

- :class:`CostOracle` — per-task cost estimates fed by three sources, in
  precedence order: an explicit ``{"scheduling": {...}}`` block in the
  task's engine params (the operator knows best), **measured** family
  records (bench entries / live telemetry via
  :meth:`CostOracle.record_measurement`), and a **static** memory budget
  scaled to the task's population. The JAX package reads its static budget
  from compiled-HLO buffer assignments; eager PyTorch compiles no program,
  so the port's static source is a budgets file it writes only from its own
  card measurement (``performancemgr.hbm_budget.measure_hbm_budget``: one
  ``round_step`` after ``torch.cuda.reset_peak_memory_stats()``), named by
  ``CostOracle(budgets_path=...)``. Without one, defaults apply, as in the
  JAX package without blessed budgets.
- :class:`ChipPool` — a pool of :class:`MeshSpec` workers (cards or fixed
  groups of cards) with peak-memory capacity accounting and
  best-fit-decreasing placement. A worker whose memory is not given takes
  its cards' own (``torch.cuda.get_device_properties(i).total_memory``).
- :class:`PoolScheduler` — a :class:`~olearning_sim_tpu_torch.taskmgr.
  scheduler.SchedulerStrategy` driving the whole control plane:
  **admission** (a placement that would run every worker out of memory is
  rejected up-front with an ``admission_rejected`` event instead of
  crashing a worker; a bounded queue applies backpressure; a task whose
  estimated completion blows its deadline is refused while the rejection
  is still cheap), **bin-packing** (priority, deadline urgency, then
  shortest-estimated-runtime), and **planned preemption/migration**
  (:meth:`PoolScheduler.migrate`): a low-priority task is fenced at a round
  boundary through the cooperative stop + lease machinery, checkpointed
  (the runner force-commits the fence round on stop), and resumed bitwise
  on another worker under a fresh job id. Migrations charge the SAME
  durable ``supervision`` resume budget the supervisor's crash-loop
  accounting uses, so a migration storm degrades to FAIL_TASK — never a
  livelock.

Fault-injection points: ``scheduler.admit`` (before the admission
decision) and ``scheduler.preempt`` (before a planned preemption). Wired
into :class:`~olearning_sim_tpu_torch.taskmgr.task_manager.TaskManager` via
``TaskManager(pool=PoolScheduler(...))``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from olearning_sim_tpu_torch.resilience import faults
from olearning_sim_tpu_torch.resilience.events import (
    ADMISSION_REJECTED,
    CRASH_LOOP,
    TASK_MIGRATED,
    TASK_PREEMPTED,
    ResilienceLog,
    global_log,
)
from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig
from olearning_sim_tpu_torch.taskmgr.scheduler import (
    ScheduleResult,
    SchedulerStrategy,
    check_resource_availability,
    get_task_request_resource,
)
from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
from olearning_sim_tpu_torch.taskmgr.task_repo import parse_supervision
from olearning_sim_tpu_torch.utils.logging import Logger

# Defaults for tasks nothing has measured yet: deliberately conservative
# (a fat round + a long first round) so unknown tasks are packed loosely,
# not optimistically co-scheduled out of memory. Guesses, not measurements,
# kept equal to the JAX package's so that both decide alike.
DEFAULT_ROUND_TIME_S = 1.0
DEFAULT_COMPILE_S = 30.0
DEFAULT_PEAK_HBM_BYTES = 1 << 30  # 1 GiB
# The budget variant a plain one-card round is filed under (the JAX
# package's name for the unsharded dp-1 round program).
DEFAULT_HBM_VARIANT = "plain/shard0/dp1"


def card_memory_bytes(count: int = 1) -> float:
    """Total memory of CUDA cards ``0 .. count - 1``. Raises when there is
    no such card: a worker's capacity is the card's, never a guess."""
    import torch

    if not torch.cuda.is_available() or count > torch.cuda.device_count():
        raise ValueError(
            f"MeshSpec: no CUDA cards 0..{count - 1} to take the worker's "
            f"memory from; give hbm_bytes explicitly (on the CPU it must be "
            f"given)")
    return float(sum(torch.cuda.get_device_properties(i).total_memory
                     for i in range(count)))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One schedulable worker: a card or a fixed group of ``chips`` cards.
    ``hbm_bytes`` None takes the memory of CUDA cards ``0 .. chips - 1``
    (:func:`card_memory_bytes`)."""

    name: str
    hbm_bytes: Optional[float] = None
    chips: int = 1

    def __post_init__(self):
        if self.hbm_bytes is None:
            object.__setattr__(self, "hbm_bytes", card_memory_bytes(self.chips))


@dataclasses.dataclass(frozen=True)
class TaskCost:
    """Per-task cost estimate (seconds / bytes) the scheduler packs with."""

    round_time_s: float = DEFAULT_ROUND_TIME_S
    compile_s: float = DEFAULT_COMPILE_S
    peak_hbm_bytes: float = DEFAULT_PEAK_HBM_BYTES
    rounds: int = 1
    deadline_s: Optional[float] = None   # completion budget from submit
    preemptible: bool = True
    source: str = "default"

    def runtime_estimate_s(self) -> float:
        return self.compile_s + self.rounds * self.round_time_s


@dataclasses.dataclass
class Placement:
    task_id: str
    worker: str
    cost: TaskCost
    priority: int = 0


def _engine_params(tc: TaskConfig) -> Dict[str, Any]:
    """First operator's operatorParams JSON (mirror of the task bridge's
    accessor, re-implemented here so the control plane never imports the
    engine)."""
    for op in tc.operatorFlow.operator:
        raw = op.logicalSimulationOperatorInfo.operatorParams
        if raw:
            try:
                return json.loads(raw)
            except (TypeError, ValueError):
                return {}
    return {}


def _total_clients(tc: TaskConfig) -> int:
    return int(sum(
        sum(td.totalSimulation.numTotalSimulation)
        for td in tc.target.targetData
    ))


class CostOracle:
    """Telemetry-fed cost estimates per task family.

    ``family`` keys default to ``<algorithm>_<model>`` from the engine
    params (override per task via ``scheduling.family``). Measured records
    win over the static oracle; explicit ``scheduling`` values win over
    everything.
    """

    def __init__(self, bench_records: Optional[Sequence[Dict[str, Any]]] = None,
                 hbm_variant: str = DEFAULT_HBM_VARIANT,
                 budgets_path: Optional[str] = None):
        """``budgets_path`` — a JSON file ``{variant: {params_bytes,
        largest_buffer_bytes, clients}}`` written by
        ``performancemgr.hbm_budget.measure_hbm_budget`` (the static
        source); None or an
        unreadable file leaves the static source empty."""
        self._measured: Dict[str, Dict[str, float]] = {}
        self._hbm_variant = hbm_variant
        self._budgets_path = budgets_path
        self._hbm_budgets: Optional[Dict[str, Dict[str, float]]] = None
        self._lock = threading.Lock()
        if bench_records:
            self.ingest_bench_records(bench_records)

    # ------------------------------------------------------------- feeds
    def ingest_bench_records(self, records: Sequence[Dict[str, Any]]) -> int:
        """Feed bench-shaped entries (``family`` plus
        ``round_time_sec``/``rounds_per_sec``, ``compile_sec``,
        ``peak_hbm_bytes_est``); returns how many were usable."""
        n = 0
        for rec in records:
            family = rec.get("family")
            if not family:
                continue
            round_time = rec.get("round_time_sec")
            if round_time is None and rec.get("rounds_per_sec"):
                round_time = 1.0 / float(rec["rounds_per_sec"])
            self.record_measurement(
                family,
                round_time_s=round_time,
                compile_s=rec.get("compile_sec"),
                peak_hbm_bytes=rec.get("peak_hbm_bytes_est"),
            )
            n += 1
        return n

    def record_measurement(self, family: str,
                           round_time_s: Optional[float] = None,
                           compile_s: Optional[float] = None,
                           peak_hbm_bytes: Optional[float] = None) -> None:
        """Live telemetry feed: a finished round's measured costs refine
        the family's estimate for the next admission decision."""
        with self._lock:
            entry = self._measured.setdefault(family, {})
            if round_time_s is not None:
                entry["round_time_s"] = float(round_time_s)
            if compile_s is not None:
                entry["compile_s"] = float(compile_s)
            if peak_hbm_bytes is not None:
                entry["peak_hbm_bytes"] = float(peak_hbm_bytes)

    # ------------------------------------------------------- static oracle
    def _static_budget(self) -> Optional[Dict[str, float]]:
        if self._hbm_budgets is None:
            self._hbm_budgets = {}
            if self._budgets_path:
                try:
                    with open(self._budgets_path, encoding="utf-8") as f:
                        self._hbm_budgets = dict(json.load(f))
                except (OSError, ValueError, TypeError):
                    # No readable budgets file is a degraded-but-working
                    # oracle (defaults apply), not an error.
                    self._hbm_budgets = {}
        return self._hbm_budgets.get(self._hbm_variant)

    def static_peak_hbm(self, clients: int) -> Optional[float]:
        """Scale the variant's measured memory facts to a task population:
        parameters (×4 for params/update/optimizer slots) plus the largest
        live buffer prorated per client. A heuristic, anchored in a real
        round on the card, which is what admission needs to refuse a
        placement that would run a worker out of memory up-front."""
        entry = self._static_budget()
        if not entry:
            return None
        golden_clients = max(1.0, float(entry.get("clients", 1)))
        per_client = float(entry.get("largest_buffer_bytes", 0)) / golden_clients
        return (4.0 * float(entry.get("params_bytes", 0))
                + max(1, clients) * per_client)

    # --------------------------------------------------------- estimation
    @staticmethod
    def family_of(tc: TaskConfig) -> str:
        params = _engine_params(tc)
        sched = params.get("scheduling") or {}
        if sched.get("family"):
            return str(sched["family"])
        algo = (params.get("algorithm") or {}).get("name", "unknown")
        model = (params.get("model") or {}).get("name", "unknown")
        return f"{algo}_{model}"

    def estimate(self, tc: TaskConfig) -> TaskCost:
        params = _engine_params(tc)
        sched = params.get("scheduling") or {}
        family = self.family_of(tc)
        with self._lock:
            measured = dict(self._measured.get(family, {}))
        rounds = max(1, int(tc.operatorFlow.flowSetting.round))
        clients = _total_clients(tc)

        source = "default"
        round_time = measured.get("round_time_s")
        compile_s = measured.get("compile_s")
        peak_hbm = measured.get("peak_hbm_bytes")
        if round_time is not None or compile_s is not None \
                or peak_hbm is not None:
            source = "measured"
        if peak_hbm is None:
            static = self.static_peak_hbm(clients)
            if static is not None:
                peak_hbm = static
                if source == "default":
                    source = "static_hbm"
        if any(k in sched for k in ("round_time_s", "compile_s",
                                    "peak_hbm_bytes")):
            source = "scheduling_params"
        deadline = sched.get("deadline_s")
        return TaskCost(
            round_time_s=float(sched.get(
                "round_time_s",
                round_time if round_time is not None else DEFAULT_ROUND_TIME_S,
            )),
            compile_s=float(sched.get(
                "compile_s",
                compile_s if compile_s is not None else DEFAULT_COMPILE_S,
            )),
            peak_hbm_bytes=float(sched.get(
                "peak_hbm_bytes",
                peak_hbm if peak_hbm is not None else DEFAULT_PEAK_HBM_BYTES,
            )),
            rounds=rounds,
            deadline_s=float(deadline) if deadline is not None else None,
            preemptible=bool(sched.get("preemptible", True)),
            source=source,
        )


class ChipPool:
    """Capacity ledger over a set of workers: placements consume peak
    device memory until released. Thread-safe; utilization mirrors into the
    ``ols_taskmgr_pool_utilization_ratio`` gauge per worker."""

    def __init__(self, workers: Sequence[MeshSpec], registry=None):
        if not workers:
            raise ValueError("a chip pool needs at least one worker")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        self.workers: Dict[str, MeshSpec] = {w.name: w for w in workers}
        self.registry = registry
        self._placements: Dict[str, Placement] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------ queries
    def used_bytes(self, worker: str) -> float:
        with self._lock:
            return sum(p.cost.peak_hbm_bytes
                       for p in self._placements.values()
                       if p.worker == worker)

    def free_bytes(self, worker: str) -> float:
        return self.workers[worker].hbm_bytes - self.used_bytes(worker)

    def max_worker_hbm(self) -> float:
        return max(w.hbm_bytes for w in self.workers.values())

    def placement(self, task_id: str) -> Optional[Placement]:
        with self._lock:
            return self._placements.get(task_id)

    def placements(self) -> List[Placement]:
        with self._lock:
            return list(self._placements.values())

    def best_fit(self, cost: TaskCost,
                 exclude: Sequence[str] = ()) -> Optional[str]:
        """Best-fit: the worker whose remaining HBM after placement is
        smallest but non-negative (packs tight, keeps big holes open for
        big tasks). None when nothing fits right now."""
        with self._lock:
            best, best_left = None, None
            for name, spec in sorted(self.workers.items()):
                if name in exclude:
                    continue
                left = self.free_bytes(name) - cost.peak_hbm_bytes
                if left < 0:
                    continue
                if best_left is None or left < best_left:
                    best, best_left = name, left
            return best

    # ---------------------------------------------------------- mutation
    def place(self, task_id: str, worker: str, cost: TaskCost,
              priority: int = 0, force: bool = False) -> bool:
        """``force=True`` records the placement even over capacity — for a
        task that is ALREADY running there, a truthful over-committed
        ledger (gauge > 1.0) beats an invisible tenant."""
        with self._lock:
            if worker not in self.workers:
                raise KeyError(f"unknown worker {worker!r}")
            if task_id in self._placements:
                return False
            if not force and self.free_bytes(worker) < cost.peak_hbm_bytes:
                return False
            self._placements[task_id] = Placement(task_id, worker, cost,
                                                  priority)
        self._update_gauge()
        return True

    def move(self, task_id: str, worker: str) -> bool:
        with self._lock:
            p = self._placements.get(task_id)
            if p is None or worker not in self.workers:
                return False
            p.worker = worker
        self._update_gauge()
        return True

    def release(self, task_id: str) -> Optional[Placement]:
        with self._lock:
            p = self._placements.pop(task_id, None)
        if p is not None:
            self._update_gauge()
        return p

    def _update_gauge(self) -> None:
        from olearning_sim_tpu_torch.telemetry import default_registry, instrument

        registry = self.registry if self.registry is not None \
            else default_registry()
        if not registry.enabled:
            return
        gauge = instrument("ols_taskmgr_pool_utilization_ratio", registry)
        for name, spec in self.workers.items():
            gauge.labels(worker=name).set(
                self.used_bytes(name) / max(spec.hbm_bytes, 1.0)
            )


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    ok: bool
    reason: str = ""
    detail: str = ""


class PoolScheduler(SchedulerStrategy):
    """The cost-model strategy + admission + migration control plane.

    Use as ``TaskManager(pool=PoolScheduler(pool=ChipPool([...])))`` — the
    manager binds itself, routes submissions through :meth:`admit`, uses
    :meth:`schedule_next_task` as its strategy, reports launches/releases,
    and (when started) drives :meth:`rebalance_once` on a daemon.
    """

    def __init__(self, pool: ChipPool, oracle: Optional[CostOracle] = None,
                 max_queue: int = 64, resume_budget: int = 3,
                 log: Optional[ResilienceLog] = None,
                 logger: Optional[Logger] = None, registry=None):
        self.pool = pool
        self.oracle = oracle if oracle is not None else CostOracle()
        self.max_queue = int(max_queue)
        self.resume_budget = int(resume_budget)
        self.log = log if log is not None else global_log()
        self.logger = logger if logger is not None else Logger()
        self.registry = registry
        self._mgr = None
        self._lock = threading.RLock()
        # task_id -> (worker, cost, priority): chosen by the strategy,
        # consumed at launch (placed) or aborted.
        self._pending: Dict[str, Tuple[str, TaskCost, int]] = {}
        # Admitted-but-not-finished cost ledger: the deadline estimator's
        # view of the backlog.
        self._costs: Dict[str, TaskCost] = {}
        # Highest-priority queued task the last scheduling pass could not
        # place anywhere — the rebalancer's preemption trigger.
        self._starved: Optional[Tuple[str, TaskCost, int]] = None

    # ------------------------------------------------------------ binding
    def bind(self, manager) -> None:
        self._mgr = manager

    def _require_manager(self):
        if self._mgr is None:
            raise RuntimeError(
                "PoolScheduler is not bound to a TaskManager; construct "
                "the manager with TaskManager(pool=<this scheduler>)"
            )
        return self._mgr

    # ---------------------------------------------------------- admission
    def admit(self, tc: TaskConfig, queue_depth: int) -> AdmissionDecision:
        """Admission control at submit time. Rejections are terminal by
        policy (the row is failed loudly with an ``admission_rejected``
        event) — never a crash inside a worker, never a silent queue."""
        task_id = tc.taskID.taskID
        faults.inject("scheduler.admit", context=task_id, task_id=task_id)
        cost = self.oracle.estimate(tc)
        if queue_depth >= self.max_queue:
            return self._reject(task_id, "backpressure",
                                f"queue depth {queue_depth} >= bound "
                                f"{self.max_queue}")
        if cost.peak_hbm_bytes > self.pool.max_worker_hbm():
            return self._reject(
                task_id, "oom",
                f"peak HBM estimate {cost.peak_hbm_bytes:.0f} B exceeds "
                f"every worker (max {self.pool.max_worker_hbm():.0f} B; "
                f"oracle source: {cost.source})",
            )
        if cost.deadline_s is not None:
            projected = self.estimated_wait_s() + cost.runtime_estimate_s()
            if projected > cost.deadline_s:
                return self._reject(
                    task_id, "deadline",
                    f"projected completion {projected:.1f}s exceeds "
                    f"deadline {cost.deadline_s:.1f}s",
                )
        with self._lock:
            self._costs[task_id] = cost
        return AdmissionDecision(True)

    def _reject(self, task_id: str, reason: str,
                detail: str) -> AdmissionDecision:
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_taskmgr_admission_rejected_total",
                   self.registry).labels(reason=reason).inc()
        self.log.record(ADMISSION_REJECTED, point="scheduler.admit",
                        task_id=task_id, reason=reason, detail=detail)
        self.logger.warning(
            task_id=task_id, system_name="TaskMgr", module_name="admission",
            message=f"admission rejected ({reason}): {detail}",
        )
        return AdmissionDecision(False, reason, detail)

    def estimated_wait_s(self) -> float:
        """Crude, monotone backlog estimate: admitted-but-unfinished work
        divided by pool width. Good enough to refuse a deadline the queue
        has already blown; deliberately conservative."""
        with self._lock:
            backlog = sum(c.runtime_estimate_s() for c in self._costs.values())
        return backlog / max(1, len(self.pool.workers))

    # ----------------------------------------------------------- strategy
    def schedule_next_task(self, task_queue, available_resources):
        """Pick (task, worker): feasibility against both the legacy
        resource ledger and the pool's HBM capacity, then priority →
        deadline urgency → shortest estimated runtime → queue order."""
        scored = []
        starved: Optional[Tuple[str, TaskCost, int]] = None
        for pos, tc in enumerate(task_queue):
            task_id = tc.taskID.taskID
            with self._lock:
                cost = self._costs.get(task_id)
            if cost is None:
                cost = self.oracle.estimate(tc)
                with self._lock:
                    self._costs[task_id] = cost
            request = get_task_request_resource(tc)
            if not check_resource_availability(request, available_resources):
                continue
            priority = int(tc.target.priority)
            worker = self.pool.best_fit(cost)
            if worker is None:
                if starved is None or priority > starved[2]:
                    starved = (task_id, cost, priority)
                continue
            urgency = cost.deadline_s if cost.deadline_s is not None \
                else float("inf")
            scored.append((
                (-priority, urgency, cost.runtime_estimate_s(), pos),
                tc, request, worker, cost, priority,
            ))
        with self._lock:
            self._starved = starved
        if not scored:
            return None
        scored.sort(key=lambda item: item[0])
        _, tc, request, worker, cost, priority = scored[0]
        with self._lock:
            self._pending[tc.taskID.taskID] = (worker, cost, priority)
        return ScheduleResult(task=tc, task_request=request, worker=worker)

    # --------------------------------------------------------- lifecycle
    def on_launched(self, task_id: str) -> None:
        """The manager launched the task: consume the pending placement
        and charge the worker's capacity. The reserved worker may have
        filled between scheduling and launch (a concurrent migration
        landed there) — re-fit, and as a last resort record the
        placement over capacity rather than run an unaccounted tenant."""
        with self._lock:
            pending = self._pending.pop(task_id, None)
        if pending is None:
            return
        worker, cost, priority = pending
        if not self.pool.place(task_id, worker, cost, priority):
            alt = self.pool.best_fit(cost)
            if alt is not None and self.pool.place(task_id, alt, cost,
                                                   priority):
                worker = alt
            else:
                self.pool.place(task_id, worker, cost, priority, force=True)
                self.logger.warning(
                    task_id=task_id, system_name="TaskMgr",
                    module_name="pool",
                    message=f"worker {worker} filled between scheduling "
                            f"and launch; placement recorded over capacity",
                )
        mgr = self._mgr
        if mgr is not None:
            mgr._task_repo.set_item_value(task_id, "worker_id", worker)

    def abort_launch(self, task_id: str) -> None:
        with self._lock:
            self._pending.pop(task_id, None)
            self._costs.pop(task_id, None)

    def on_finished(self, task_id: str) -> None:
        self.pool.release(task_id)
        with self._lock:
            self._pending.pop(task_id, None)
            self._costs.pop(task_id, None)

    # --------------------------------------------------------- migration
    def rebalance_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One preemption pass: when the last scheduling pass starved a
        higher-priority task, fence the lowest-priority preemptible
        placement that (a) frees enough room and (b) itself fits on
        another worker, and migrate it there. Never evicts without a
        landing spot — a preemption that strands its victim is just a
        slower crash."""
        digest: Dict[str, Any] = {"migrated": [], "failed": [],
                                  "skipped": []}
        with self._lock:
            starved = self._starved
        if starved is None:
            return digest
        task_id, cost, priority = starved
        victims = sorted(
            (p for p in self.pool.placements()
             if p.cost.preemptible and p.priority < priority),
            key=lambda p: p.priority,
        )
        for victim in victims:
            freed = self.pool.free_bytes(victim.worker) \
                + victim.cost.peak_hbm_bytes
            if freed < cost.peak_hbm_bytes:
                continue
            target = self.pool.best_fit(victim.cost,
                                        exclude=(victim.worker,))
            if target is None:
                continue
            outcome = self.migrate(victim.task_id, target,
                                   reason=f"preempted_for:{task_id}")
            digest[{"migrated": "migrated", "failed": "failed"}.get(
                outcome, "skipped")].append(victim.task_id)
            if outcome in ("migrated", "failed"):
                # Either way the victim's worker freed enough room for
                # the starved task — one eviction per pass, never more.
                break
        return digest

    def migrate(self, task_id: str, target_worker: Optional[str] = None,
                reason: str = "rebalance", fence_timeout_s: float = 60.0
                ) -> str:
        """Planned preemption + migration of one running task. Returns
        ``"migrated"``, ``"failed"`` (resume budget exhausted →
        FAIL_TASK), or ``"skipped"`` (not ours / no target / fence did
        not land).

        Fence protocol: verify we still hold the task's lease (a renewal
        that fails means another process reclaimed it — never fight),
        cooperatively stop the engine job (the runner stops at the next
        round boundary and force-commits the fence round through the
        manifest path), charge the shared supervision resume budget, then
        relaunch under a fresh job id on the target worker. The resumed
        runner restores the fence checkpoint and replays bitwise.
        """
        mgr = self._require_manager()
        repo = mgr._task_repo
        faults.inject("scheduler.preempt", context=task_id, task_id=task_id)
        placement = self.pool.placement(task_id)
        if placement is None:
            return "skipped"
        if not placement.cost.preemptible:
            return "skipped"
        if target_worker is None:
            target_worker = self.pool.best_fit(placement.cost,
                                               exclude=(placement.worker,))
            if target_worker is None:
                return "skipped"
        # Cross-process lease timestamps are wall-clock by design (see
        # task_repo); monotonic clocks have per-process epochs.
        now = time.time()  # lint: allow-wall-clock
        if not repo.renew_lease(task_id, mgr.owner_id, mgr.lease_ttl,
                                now=now):
            # Not ours anymore (supervisor reclaimed a wedged run): the
            # new owner drives it; migrating would double-run the task.
            return "skipped"
        sup = parse_supervision(repo.get_item_value(task_id, "supervision"))
        resumes = int(sup.get("resumes", 0))
        job_id = mgr._own_jobs.get(task_id) \
            or repo.get_item_value(task_id, "job_id")
        if resumes >= self.resume_budget:
            self._fail_migration_storm(task_id, job_id, resumes)
            return "failed"
        # Decode the relaunch config BEFORE fencing: a row we cannot
        # relaunch must never be stopped (that would strand it STOPPED,
        # not migrated).
        raw = repo.get_item_value(task_id, "task_params")
        if not raw:
            return "skipped"
        from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig

        tc = json2taskconfig(raw)
        mgr._migrating.add(task_id)
        try:
            self.log.record(
                TASK_PREEMPTED, point="scheduler.preempt", task_id=task_id,
                worker=placement.worker, reason=reason,
            )
            mgr._launcher.stop_job(job_id)
            job = mgr._launcher.get_job(job_id)
            if job is not None:
                job.join(fence_timeout_s)
            status = mgr._launcher.get_job_status(job_id)
            if status in (TaskStatus.PENDING, TaskStatus.RUNNING):
                # Fence did not land in time: withdraw the stop request
                # so the task genuinely keeps running — a pending stop
                # left behind would land later with nobody to relaunch,
                # and release_once would finalize a healthy task STOPPED.
                if job is not None:
                    job.cancel_stop()
                    job.join(2.0)
                status = mgr._launcher.get_job_status(job_id)
                if status in (TaskStatus.PENDING, TaskStatus.RUNNING):
                    self.logger.error(
                        task_id=task_id, system_name="TaskMgr",
                        module_name="migrate",
                        message=f"fence did not land within "
                                f"{fence_timeout_s}s; stop withdrawn, task "
                                f"stays on {placement.worker}",
                    )
                    return "skipped"
                # Else the stop landed (or the job finished) while we
                # were withdrawing it — fall through to the status gate.
            if status != TaskStatus.STOPPED:
                # The job reached SUCCEEDED/FAILED on its own: there is
                # nothing to migrate — the release loop (or supervision)
                # finalizes it through the normal paths.
                return "skipped"
            # Shared crash-loop accounting: migrations and crash resumes
            # draw from ONE durable budget.
            sup.update(resumes=resumes + 1, last_resume_ts=now)
            repo.set_item_value(task_id, "supervision", json.dumps(sup))
            new_job = mgr._launcher.submit(
                lambda stop_event: mgr._runner_factory(tc, stop_event),
                job_id=f"job-{task_id}~m{resumes + 1}",
            )
            repo.set_item_value(task_id, "job_id", new_job)
            repo.set_item_value(task_id, "worker_id", target_worker)
            mgr._own_jobs[task_id] = new_job
            self.pool.move(task_id, target_worker)
            self.log.record(
                TASK_MIGRATED, point="scheduler.preempt", task_id=task_id,
                src=placement.worker, dst=target_worker, job_id=new_job,
                attempt=resumes + 1,
            )
            self.logger.info(
                task_id=task_id, system_name="TaskMgr",
                module_name="migrate",
                message=f"migrated {placement.worker} -> {target_worker} "
                        f"as {new_job} (resume {resumes + 1} of "
                        f"{self.resume_budget})",
            )
            return "migrated"
        finally:
            mgr._migrating.discard(task_id)

    def _fail_migration_storm(self, task_id: str, job_id: Optional[str],
                              resumes: int) -> None:
        """Budget exhausted: degrade to FAIL_TASK exactly like the
        supervisor's crash-loop quarantine — the budget is one and the
        same, so a storm of preemptions can never livelock a task."""
        mgr = self._require_manager()
        self.logger.error(
            task_id=task_id, system_name="TaskMgr", module_name="migrate",
            message=f"migration storm: {resumes} resumes exhausted the "
                    f"shared budget of {self.resume_budget}; failing task",
        )
        if job_id:
            mgr._launcher.stop_job(job_id)
        if mgr._resource_manager is not None:
            mgr._resource_manager.release_resource(task_id)
        repo = mgr._task_repo
        repo.set_item_value(task_id, "resource_occupied", "0")
        repo.set_item_value(task_id, "task_status", TaskStatus.FAILED.name)
        repo.set_item_value(
            task_id, "task_finished_time",
            time.strftime("%Y-%m-%d %H:%M:%S"),
        )
        repo.release_lease(task_id, mgr.owner_id)
        mgr._own_jobs.pop(task_id, None)
        self.on_finished(task_id)
        self.log.record(
            CRASH_LOOP, point="scheduler.preempt", task_id=task_id,
            resumes=resumes, budget=self.resume_budget,
            policy="fail_task",
        )
