"""SimulationRunner — the round loop of one task, synchronous path.

The port of the JAX package's ``engine/runner.py`` (the reference RayRunner
rebuilt around the round engine). Reference semantics
(``ols_core/taskMgr/run_task.py:212-322``): for each round x operator:
operator-flow start barrier -> optional deviceflow NotifyStart -> execute
the operator over all virtual devices -> deviceflow NotifyComplete -> per-
(data, device-class) success/failed accounting persisted to the task table
-> operator-flow stop barrier (tolerant on the final round).

- "execute the operator" is one :meth:`FedCore.round_step` advancing the
  whole population on the device;
- deviceflow behaviour enters the round as masks from the trace compiler
  (participation / drops); with a deviceflow service attached (passed in,
  duck-typed: ``notify_start`` / ``notify_complete``) the runner also walks
  the flow lifecycle;
- success/failed counts per device class come from per-client finite-loss
  masks;
- faults are absorbed by the resilience layer: with a
  :class:`~olearning_sim_tpu_torch.resilience.ResilienceConfig` the loop
  gains rollback-and-retry / skip-round failure policies from an in-memory
  snapshot of the round's entry state or the last readable checkpoint,
  client quarantine, and the injection points ``runner.round_begin``,
  ``runner.pre_checkpoint``, ``runner.poison_clients``,
  ``runner.attack_clients`` and ``runner.straggler_spike``;
- with a :class:`~olearning_sim_tpu_torch.engine.pacing.DeadlineConfig`
  each round over-selects its cohort, models every client's completion
  time, masks late clients out of the aggregate, enforces a quorum through
  the failure policy (``deadline_miss``) and adapts the next deadline;
- with a :class:`~olearning_sim_tpu_torch.engine.defense.DefenseConfig`
  the round clips and robustly aggregates the deltas, and anomaly scores
  feed the quarantine (``client_flagged``);
- with a :class:`~olearning_sim_tpu_torch.checkpoint.RoundCheckpointer`
  each round (every ``checkpoint_every``-th) is checkpointed and ``begin``
  resumes from the newest readable step, a cooperative stop fences the last
  completed round; with a
  :class:`~olearning_sim_tpu_torch.checkpoint.ModelUpdateExporter` each
  round's global model is exported as a model file, and a fresh runner
  resumes from the newest one or warm-starts from ``warm_start_path``;
- with a :class:`~olearning_sim_tpu_torch.engine.convergence.ConvergenceConfig`
  the loop tracks time-to-accuracy (:meth:`convergence_record`);
- with a :class:`~olearning_sim_tpu_torch.engine.scenario.ScenarioConfig`
  each train round intersects the dispatch trace with the scenario's
  availability (diurnal, charging, spikes, churn) and rotates drifting
  clients' labels for that launch; a population with a
  :class:`~olearning_sim_tpu_torch.engine.client_data.HostClientStore`
  stays on the host and trains through ``FedCore.stream_round``;
- with an :class:`~olearning_sim_tpu_torch.engine.async_rounds.AsyncConfig`
  each train round plans its clients' simulated arrivals into commit
  windows and runs the buffered asynchronous round (staleness-weighted
  commits every ``buffer_size`` arrivals), with the commit, staleness,
  buffer-depth and idle accounting.

Over dp ranks (the core's plan, one process per rank) every rank runs
this loop alike: each holds its shard of every resident population
(``DataPopulation.dataset``) and its rows of the per-client state, and the
same host records, and takes every decision alike (a stop request is
agreed between rounds). Only rank 0 writes: checkpoints (every rank hands
it the gathered state), model files and the task row.

Host state that later rounds depend on (quarantine, the adaptive deadline
controller, the async commit clock, convergence clocks) rides the per-round
history records, so a rollback or a resume restores it with the history
(``_requarantine``, ``_repace``, ``_reasync``, ``_reconverge``).

:class:`MultiTaskDispatcher` drives several runners in one process, in
turns (``begin``/``step``/``finish``) or on threads, holding each task's
lease in a task repo.

The fault injector, the resilience log and the default metrics registry
and tracer are the port's own process globals: a chaos plan armed through
the JAX package does not reach a port runner, and its resilience events
land in the port's log. The digest reaches a control plane through the
task row (``_persist_resilience`` writes the ``resilience`` column), which
is the interface between the two. A ``registry`` passed in is used
duck-typed, so a control plane's registry receives the round series.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.deviceflow.trace_compiler import combine_traces, compile_trace
from olearning_sim_tpu_torch.engine import pacing
from olearning_sim_tpu_torch.engine.async_rounds import AsyncConfig, plan_async_round
from olearning_sim_tpu_torch.engine.client_data import ClientDataset, HostClientStore
from olearning_sim_tpu_torch.engine.convergence import ConvergenceConfig, ConvergenceTracker
from olearning_sim_tpu_torch.engine.defense import DefenseConfig
from olearning_sim_tpu_torch.engine.fedcore import FedCore
from olearning_sim_tpu_torch.engine.pacing import (
    DeadlineConfig,
    DeadlineController,
    DeadlineMissError,
    RoundPacing,
)
from olearning_sim_tpu_torch.engine.scenario import ScenarioConfig, ScenarioModel
from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.resilience import (
    CLIENT_FLAGGED,
    DEADLINE_MISS,
    ROLLBACK,
    SKIP_ROUND,
    FailurePolicy,
    HostPreemption,
    QuarantineManager,
    ResilienceConfig,
    faults,
)
from olearning_sim_tpu_torch.resilience.events import global_log
from olearning_sim_tpu_torch.taskmgr.operator_flow import OperatorFlowController
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
from olearning_sim_tpu_torch.telemetry import default_tracer, instrument
from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax


@dataclasses.dataclass
class OperatorSpec:
    """One operator in the flow (reference ``Operator`` proto,
    ``taskService.proto:68-76``). ``kind``:

    - ``train``: one FedCore round step;
    - ``eval``: centralized evaluation of the global model;
    - ``custom``: host callback ``fn(runner, round_idx, operator,
      population) -> dict``, called once per population; a returned
      ``ok_mask`` feeds per-class success accounting. Callbacks that take
      only (runner, round_idx, operator) work too.
    """

    name: str
    kind: str = "train"
    use_deviceflow: bool = False
    deviceflow_strategy: str = ""
    # OperationBehaviorController.outboundService: JSON config for where
    # dispatched batches go, handed to the deviceflow service.
    outbound_service: str = ""
    inputs: List[str] = dataclasses.field(default_factory=list)
    custom_fn: Optional[Callable[..., Dict[str, Any]]] = None
    # Scratch directories the operator owns (fetched user code, an external
    # operator's save root): removed when its runner's run ends.
    scratch_dirs: List[str] = dataclasses.field(default_factory=list)


def remove_scratch(operators: List[OperatorSpec]) -> None:
    """Remove every scratch directory of ``operators`` (the JAX package
    leaves them in the temporary directory)."""
    for op in operators:
        for d in op.scratch_dirs:
            shutil.rmtree(d, ignore_errors=True)
        op.scratch_dirs = []


@dataclasses.dataclass
class DataPopulation:
    """One target-data entry: a client population plus its device-class
    layout (reference ``TargetData`` + ``TotalSimulation``,
    ``taskService.proto:18-32``)."""

    name: str
    # On the device, padded to whole blocks of every rank (this rank's
    # shard, ClientDataset.shard); a streamed population's stays on the
    # host, unpadded.
    dataset: ClientDataset
    device_classes: List[str]  # class names, e.g. ["high", "low"]
    class_of_client: np.ndarray  # [C] int index into device_classes (host)
    nums: List[int]  # target simulated devices per class
    dynamic_nums: List[int]  # failure allowance per class
    eval_data: Optional[tuple] = None  # (x, y) central eval set (host)
    # Heterogeneous compute profiles: per-client local-step counts [C]
    # (padded). None = every client runs config.max_local_steps.
    num_steps: Optional[np.ndarray] = None
    # The population's label-class count (the label-drift modulus). None
    # falls back to the observed max(y) + 1.
    num_classes: Optional[int] = None
    # Block-streamed population (scenario.stream_block_rows): the clients
    # stay in this host store and train rounds run through
    # ``FedCore.stream_round`` (O(block) device memory), on ``device``.
    store: Optional[HostClientStore] = None
    device: Any = "cuda"


def _copy_tree(tree):
    """A deep copy of a state tree (dataclasses, dicts, lists of tensors and
    scalars): every tensor cloned, so that nothing a failed attempt does to
    the live state reaches the snapshot it rolls back to."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _copy_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


class SimulationRunner:
    def __init__(
        self,
        task_id: str,
        core: FedCore,
        populations: List[DataPopulation],
        operators: List[OperatorSpec],
        rounds: int,
        task_repo: Optional[TaskTableRepo] = None,
        deviceflow: Optional[Any] = None,
        operator_flow: Optional[OperatorFlowController] = None,
        stop_event: Optional[threading.Event] = None,
        perf: Optional[Any] = None,
        resilience: Optional[ResilienceConfig] = None,
        registry: Optional[Any] = None,
        quarantine_preseed: Optional[Dict[str, List[int]]] = None,
        cost_oracle: Optional[Any] = None,
        cost_family: Optional[str] = None,
        checkpointer: Optional[Any] = None,
        checkpoint_every: int = 1,
        model_io: Optional[Any] = None,
        warm_start_path: Optional[str] = None,
        convergence: Optional[ConvergenceConfig] = None,
        deadline: Optional[DeadlineConfig] = None,
        defense: Optional[DefenseConfig] = None,
        scenario: Optional[ScenarioConfig] = None,
        async_config: Optional[AsyncConfig] = None,
        trace_seed: int = 0,
    ):
        """``task_repo`` — the task table (duck-typed: ``has_task``,
        ``add_task``, ``set_item_value``); a fresh in-memory one when None.
        ``deviceflow`` — a deviceflow service (duck-typed). ``perf`` — a
        performance manager with ``time_round`` (duck-typed).
        ``resilience`` — opt-in resilient round execution (None fails the
        task on the first failed round). ``registry`` — the metrics sink;
        None resolves the port's process default at use time (spans go to
        the port's default tracer). ``quarantine_preseed`` — population
        name -> known-bad client ids blocklisted from round 0.
        ``cost_oracle`` / ``cost_family`` — a scheduler cost oracle
        (duck-typed: ``record_measurement``) fed this task's measured
        per-round wall time at every round close. ``checkpointer`` — a
        :class:`~olearning_sim_tpu_torch.checkpoint.RoundCheckpointer`
        saving every ``checkpoint_every``-th round and the last.
        ``model_io`` — a
        :class:`~olearning_sim_tpu_torch.checkpoint.ModelUpdateExporter`
        realizing the reference's model-update-style convention (round r's
        global model exported as ``{task_id}_{r}_result_model.*``;
        ``utils_run_task.py:327-397``). ``warm_start_path`` — the round-0
        model fetched through ``model_io``'s repo (``Model.modelPath`` with
        ``useModel``). ``convergence`` — opt-in time-to-accuracy tracking,
        its state riding the history records. ``deadline`` — opt-in
        deadline-aware rounds: completion-time model, over-selection,
        deadline-masked aggregation with straggler accounting, a quorum
        routed through the failure policy as ``deadline_miss`` events, and
        adaptive pacing whose controller state rides the history records.
        ``defense`` — opt-in adversarial-client defense: clipping and
        robust aggregation in the round, and the anomaly -> quarantine
        feedback loop. None (or a config that is not ``enabled``) keeps
        the plain round for either. ``scenario`` — scenario traces:
        availability masks and arrival times intersected with each train
        round's dispatch trace, and label drift; a trace is a function of
        (config, trace seed, round), so a rollback or a resume replays it
        with no saved state. Populations with a ``store`` stream (the
        config's ``stream_block_rows``). ``async_config`` — buffered
        asynchronous rounds: arrivals simulated by its completion model
        fill commit windows of ``buffer_size``, each committed with a
        staleness discount; the cumulative commit clock rides the history
        records. It excludes ``deadline``, per-client-state algorithms and
        a streamed population. ``trace_seed`` — the seed of the host traces
        (dispatch, pacing, scenario draws): the bridge leaves it at 0, the
        convergence harness sets its task seed."""
        self.task_id = task_id
        self.trace_seed = int(trace_seed)
        self.core = core
        self.populations = populations
        self.operators = operators
        self.rounds = int(rounds)
        # Over the mesh's ranks (dp, and mp or pp) every rank runs this loop
        # alike and takes every decision alike; only rank 0 of the world
        # writes (checkpoints, model files, the task row), the others keep
        # their task rows in a private repo.
        self.writer = core.plan.rank == 0
        self.task_repo = (task_repo if task_repo is not None and self.writer
                          else TaskTableRepo())
        self.deviceflow = deviceflow
        self.operator_flow = operator_flow or OperatorFlowController(task_id, rounds)
        self.logger = Logger()
        self.stop_event = stop_event  # threading.Event; honored between rounds
        self.perf = perf
        self.registry = registry
        self.checkpointer = checkpointer
        if checkpointer is not None:
            # Every rank of the mesh shares its directory.
            checkpointer.group = core.plan.world_group
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.model_io = model_io
        self.warm_start_path = warm_start_path
        if warm_start_path and model_io is None:
            raise ValueError("warm_start_path needs model_io (a repo to fetch it from)")
        self._model_io_export_dead = False
        # Operators whose round step has run once for this task: the first
        # run's wall time lands in ols_engine_compile_duration_seconds.
        self._compiled_once: set = set()
        self.stopped = False
        self.states: Dict[str, Any] = {}
        self._custom_arity: Dict[int, bool] = {}
        self._round_outputs: Dict[str, Any] = {}
        # Per-client state per population: Ditto personal params, SCAFFOLD
        # control variates.
        self.personal_states: Dict[str, Any] = {}
        self.control_states: Dict[str, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self.resilience = resilience
        self._rlog = (resilience.log if resilience is not None and
                      resilience.log is not None else global_log())
        self.defense = (defense if defense is not None and defense.enabled
                        else None)
        self._quarantine: Optional[QuarantineManager] = None
        if resilience is not None and resilience.quarantine_after is not None:
            self._quarantine = QuarantineManager(
                quarantine_after=resilience.quarantine_after,
                readmit_after=resilience.readmit_after,
                log=self._rlog, task_id=task_id,
            )
        scoring = self.defense is not None and self.defense.score_enabled
        if self._quarantine is None and (quarantine_preseed or scoring):
            # The anomaly feedback loop and an operator blocklist need a
            # manager even when the resilience config did not ask for one.
            # With scoring the defense's strike budget applies; a
            # preseed-only manager keeps pure blocklist semantics (an
            # effectively infinite budget), so it never quarantines clients
            # nobody asked it to watch.
            qa, ra = ((self.defense.quarantine_after, self.defense.readmit_after)
                      if scoring else (1 << 30, 3))
            self._quarantine = QuarantineManager(
                quarantine_after=qa, readmit_after=ra,
                log=self._rlog, task_id=task_id,
            )
        if quarantine_preseed:
            by_name = {p.name: p.dataset for p in populations}
            for pop, ids in quarantine_preseed.items():
                ds = by_name.get(pop)
                if ds is None:
                    raise ValueError(
                        f"quarantine.preseed names unknown population "
                        f"{pop!r} (known: {sorted(by_name)})"
                    )
                bad = [c for c in ids if c >= ds.num_real_clients]
                if bad:
                    raise ValueError(
                        f"quarantine.preseed[{pop!r}]: client ids {bad} out "
                        f"of range (population has {ds.num_real_clients} "
                        f"clients)"
                    )
                self._quarantine.preseed(pop, ids, ds.padded_clients)
        # Per-round attacks from ``runner.attack_clients``: population name
        # -> {"mode", "clients", "scale" [C] or None, "y" or None}, redrawn
        # (seeded by round) at every round begin, so a replay reproduces
        # the attack set; and each population's clean labels, for
        # label_flip.
        self._attacks: Dict[str, Dict[str, Any]] = {}
        self._clean_y: Dict[str, torch.Tensor] = {}
        # Deadline-aware rounds: one controller per task, shared across
        # populations and train operators.
        self.deadline = (deadline if deadline is not None and deadline.enabled
                         else None)
        self._pacer: Optional[DeadlineController] = (
            DeadlineController(self.deadline) if self.deadline is not None else None
        )
        # Snapshot of the executing round's entry state (rollback source),
        # plus per-completed-round quarantine snapshots (rollback must
        # restore the quarantine decisions the replayed rounds first saw).
        self._round_snapshot: Optional[Dict[str, Any]] = None
        self._qsnapshots: Dict[int, Any] = {}
        # Rounds <= this index are rollback replays: their checkpoint saves
        # overwrite, in case a stale step survived the discard.
        self._force_checkpoint_until = -1
        # Routing key of the deviceflow flow currently open (None between
        # operators); closed best-effort when a round fails mid-operator.
        self._live_routing_key: Optional[str] = None
        # Convergence tracking: its state rides the history records, so a
        # rollback or a resume replays the record (_reconverge).
        self._convergence: Optional[ConvergenceTracker] = (
            ConvergenceTracker(convergence)
            if convergence is not None and convergence.enabled else None
        )
        self._convergence_warned = False
        self._cost_oracle = cost_oracle
        self._cost_family = cost_family
        self._cost_round0_wall: Optional[float] = None
        self._cost_compile_fed = False
        # begin()/step()/finish() loop state; None outside a run.
        self._loop: Optional[Dict[str, Any]] = None
        # Buffered asynchronous rounds: commits every M arrivals with a
        # staleness discount instead of one deadline-masked commit per
        # round. max_staleness is their lateness control.
        self.async_config = async_config
        if self.async_config is not None:
            if self.deadline is not None:
                raise ValueError(
                    "async and deadline configs are mutually exclusive: "
                    "the buffered engine's lateness control is "
                    "async.max_staleness (docs/performance.md)"
                )
            if core.algorithm.personalized or core.algorithm.control_variates:
                raise ValueError(
                    f"async rounds do not support the personalized/"
                    f"control-variate algorithm {core.algorithm.name!r}"
                )
        # Cumulative committed buffer windows across the task (the async
        # staleness clock); it rides the history records (_reasync).
        self._async_commit_clock = 0
        self.scenario = scenario
        self._scenario_models: Dict[str, ScenarioModel] = {}
        if self.scenario is not None and self.scenario.streamed:
            if self.async_config is not None:
                raise ValueError(
                    "streamed scenario populations do not compose with "
                    "buffered async rounds (the commit-window scan needs "
                    "the whole cohort resident; docs/performance.md)"
                )
            if core.algorithm.personalized or core.algorithm.control_variates:
                raise ValueError(
                    f"streamed scenario populations do not support the "
                    f"personalized/control-variate algorithm "
                    f"{core.algorithm.name!r}"
                )
            if self.defense is not None and self.defense.gathers_deltas:
                raise ValueError(
                    "streamed scenario populations support clip-only "
                    "defense: robust aggregators / anomaly scoring need "
                    "every client's delta resident (docs/performance.md)"
                )

        if not self.task_repo.has_task(task_id):
            self.task_repo.add_task(task_id)
        self._write_targets()

    # ------------------------------------------------------------ accounting
    def _write_targets(self) -> None:
        """Persist logical_target in the reference shape
        (``run_task.py:155-183``)."""
        target = [
            {
                "name": p.name,
                "simulation_target": {
                    "devices": list(p.device_classes),
                    "nums": list(p.nums),
                },
            }
            for p in self.populations
        ]
        self.task_repo.set_item_value(
            self.task_id, "logical_target", json.dumps({"logical_target": target})
        )

    def _analyze_results(self, operator: OperatorSpec, round_idx: int,
                         ok_by_population: Dict[str, np.ndarray]) -> None:
        """Reference ``analyze_results`` (``run_task.py:149-210``): rebuild
        per-(data, class) success/failed counts fresh each (round, operator)
        and persist round/operator/result."""
        result = []
        for p in self.populations:
            ok = ok_by_population.get(p.name)
            success = [0] * len(p.device_classes)
            failed = [0] * len(p.device_classes)
            if ok is not None:
                real = p.dataset.num_real_clients
                cls = p.class_of_client[:real]
                for ci in range(len(p.device_classes)):
                    mask = cls == ci
                    success[ci] = int(np.logical_and(mask, ok[:real]).sum())
                    failed[ci] = int(np.logical_and(mask, ~ok[:real]).sum())
            result.append(
                {
                    "name": p.name,
                    "simulation_target": {
                        "devices": list(p.device_classes),
                        "success_num": success,
                        "failed_num": failed,
                    },
                }
            )
        repo = self.task_repo
        repo.set_item_value(self.task_id, "logical_round", round_idx + 1)
        repo.set_item_value(self.task_id, "logical_operator", operator.name)
        repo.set_item_value(
            self.task_id, "logical_result", json.dumps({"logical_result": result})
        )

    # ------------------------------------------------------------- deviceflow
    def _notify(self, point: str, fn, *args, **kwargs):
        """Deviceflow RPCs return (ok, msg); under ``resilience.rpc_retry``
        a not-ok answer (or a raised transient) is retried with backoff
        before the round-level failure policy ever sees it."""
        policy = self.resilience.rpc_retry if self.resilience is not None else None
        if policy is None:
            return fn(*args, **kwargs)
        return policy.call(
            fn, *args, retry_if=lambda r: not r[0], point=point,
            task_id=self.task_id, log=self._rlog, **kwargs,
        )

    def _flow_start(self, operator: OperatorSpec, round_idx: int,
                    attempt: int = 0) -> Optional[str]:
        if self.deviceflow is None or not operator.use_deviceflow:
            return None
        routing_key = f"{self.task_id}_{operator.name}_{round_idx}"
        if attempt:
            # A replayed round gets a fresh flow: the failed attempt's flow
            # (same key) may still be awaiting the release loop.
            routing_key = f"{routing_key}~r{attempt}"
        outbound = None
        if operator.outbound_service:
            try:
                outbound = json.loads(operator.outbound_service)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"operator {operator.name}: outbound_service is not "
                    f"valid JSON: {e}"
                ) from e
        ok, msg = self._notify(
            "deviceflow.notify_start", self.deviceflow.notify_start,
            self.task_id, routing_key, "logical_simulation",
            operator.deviceflow_strategy or "{}",
            outbound_service=outbound,
        )
        if not ok:
            raise RuntimeError(f"deviceflow NotifyStart failed for {routing_key}: {msg}")
        return routing_key

    def _abandon_live_flow(self) -> None:
        """Best-effort NotifyComplete for the flow open at a round failure:
        left open, its dispatcher would block on release forever and wedge
        task teardown."""
        key, self._live_routing_key = self._live_routing_key, None
        if self.deviceflow is None or key is None:
            return
        with contextlib.suppress(Exception):
            self.deviceflow.notify_complete(
                self.task_id, key, "logical_simulation"
            )

    def _flow_complete(self, routing_key: Optional[str]) -> None:
        if self.deviceflow is None or routing_key is None:
            return
        ok, msg = self._notify(
            "deviceflow.notify_complete", self.deviceflow.notify_complete,
            self.task_id, routing_key, "logical_simulation"
        )
        if not ok:
            raise RuntimeError(f"deviceflow NotifyComplete failed for {routing_key}: {msg}")

    # -------------------------------------------------------------- telemetry
    @contextlib.contextmanager
    def _phase(self, operator_name: str, phase: str, round_idx: int):
        """Span + per-phase latency histogram around one round phase."""
        t0 = time.perf_counter()
        with default_tracer().span(f"round.{operator_name}.{phase}",
                         task_id=self.task_id, round_idx=round_idx):
            yield
        instrument(
            "ols_engine_round_phase_duration_seconds", self.registry
        ).labels(
            task_id=self.task_id, operator=operator_name, phase=phase
        ).observe(time.perf_counter() - t0)

    # -------------------------------------------------------------- operators
    def _completion_times(self, p: DataPopulation, round_idx: int,
                          operator: OperatorSpec, trace, cfg) -> np.ndarray:
        """[real] simulated completion times for one (population, round)
        under ``cfg``'s completion model, with the ``runner.straggler_spike``
        injection applied. Replays exactly under rollback and resume."""
        real = p.dataset.num_real_clients
        stream = zlib.crc32(f"{operator.name}\x00{p.name}".encode())
        if p.num_steps is not None:
            steps = np.minimum(
                np.asarray(p.num_steps[:real], np.int32),
                self.core.config.max_local_steps,
            )
        else:
            steps = np.full(real, self.core.config.max_local_steps, np.int32)
        completion = pacing.completion_times(
            trace.arrival_time[:real], steps, p.class_of_client[:real],
            p.device_classes, cfg, self.trace_seed, round_idx, stream=stream,
        )
        # ``runner.straggler_spike`` injection point: a simulated fleet-wide
        # (or targeted) slowdown that multiplies this round's completion
        # times. Payload: ``{"factor": 5.0, "clients": [...]?}``; scope to
        # one population with the spec's ``match`` filter (the context is
        # the population name).
        spec = faults.fire("runner.straggler_spike", context=p.name,
                           round_idx=round_idx, task_id=self.task_id)
        if spec is not None:
            payload = spec.payload or {}
            factor = np.float32(payload.get("factor", 10.0))
            clients = payload.get("clients")
            if clients is None:
                completion = completion * factor
            else:
                idx = [int(c) for c in clients if int(c) < real]
                completion[idx] = completion[idx] * factor
        return completion

    def _plan_pacing(self, p: DataPopulation, round_idx: int,
                     operator: OperatorSpec, trace,
                     eligible: np.ndarray) -> RoundPacing:
        """Host-side deadline plan for one (population, round): over-select
        the cohort, derive each client's simulated completion time (network
        arrival + device-class compute), and close the round at the earlier
        of (controller deadline, K-th arrival). Deterministic for a given
        (config, trace seed, operator, population, round), so rollback
        replays reproduce the straggler set."""
        cfg = self.deadline
        stream = zlib.crc32(f"{operator.name}\x00{p.name}".encode())
        selected = pacing.select_cohort(eligible, cfg, self.trace_seed, round_idx,
                                        stream=stream)
        completion = self._completion_times(p, round_idx, operator, trace, cfg)
        completion = np.where(selected, completion, np.inf).astype(np.float32)
        eff = pacing.effective_deadline(
            completion, selected, cfg, self._pacer.current_deadline()
        )
        n_selected = int(selected.sum())
        n_on_time = int((selected & (completion <= eff)).sum())
        quorum_base = (cfg.target_cohort if cfg.target_cohort is not None
                       else n_selected)
        return RoundPacing(
            selected=selected, completion=completion, deadline_s=float(eff),
            n_selected=n_selected, n_on_time=n_on_time,
            quorum_required=int(math.ceil(cfg.quorum_fraction * quorum_base)),
        )

    def _run_train(self, p: DataPopulation, round_idx: int,
                   operator: OperatorSpec) -> Dict[str, Any]:
        real = p.dataset.num_real_clients
        tracer = default_tracer()
        select = f"round.{operator.name}.select"
        with self._phase(operator.name, "select", round_idx):
            # Compiled over real clients only: released slots must never be
            # spent on zero-weight padding clients.
            with tracer.span(f"{select}.dispatch"):
                trace = compile_trace(
                    json.loads(operator.deviceflow_strategy) if (
                        operator.use_deviceflow and operator.deviceflow_strategy
                    ) else None,
                    real,
                    round_idx,
                    task_id=self.task_id,
                    operator=operator.name,
                    seed=self.trace_seed,
                )
            strace = None
            if self.scenario is not None:
                # Scenario availability intersects the dispatch trace: a
                # client participates only if both release it, and arrives
                # at the later of the two times (pacing sees that).
                with tracer.span(f"{select}.scenario"):
                    strace = self._scenario_model(p).round_trace(round_idx)
                    trace = combine_traces(trace, strace.as_client_trace())
            mask = np.zeros(p.dataset.padded_clients, trace.participate.dtype)
            mask[:real] = trace.participate
            if self._quarantine is not None:
                # Quarantined clients are masked out like churned-out
                # devices: zero weight, zero contribution.
                mask[:real] = mask[:real] * self._quarantine.active_mask(
                    p.name, real
                ).astype(mask.dtype)
            kwargs: Dict[str, Any] = {}
            aplan = async_completion = None
            if self.async_config is not None:
                # Simulate the cohort's arrivals and assign commit windows
                # in completion-time order: deterministic for (config, trace
                # seed, operator, population, round), so a rollback or a
                # resume replays the commit sequence.
                with tracer.span(f"{select}.pacing"):
                    async_completion = self._completion_times(
                        p, round_idx, operator, trace, self.async_config.pacing_config())
                    aplan = plan_async_round(self.async_config, async_completion,
                                             mask[:real] > 0, p.dataset.padded_clients)
                kwargs["async_plan"] = aplan
            pace: Optional[RoundPacing] = None
            if self.deadline is not None:
                with tracer.span(f"{select}.pacing"):
                    pace = self._plan_pacing(p, round_idx, operator, trace, mask[:real] > 0)
                if not pace.quorum_met:
                    # Enforced before anything is launched (state untouched):
                    # a starved cohort degrades through the failure policy
                    # instead of aggregating silently.
                    self._rlog.record(
                        DEADLINE_MISS, point="runner.deadline",
                        task_id=self.task_id, round_idx=round_idx,
                        population=p.name, on_time=pace.n_on_time,
                        required=pace.quorum_required,
                        selected=pace.n_selected, deadline_s=pace.deadline_s,
                    )
                    raise DeadlineMissError(
                        f"round {round_idx} population {p.name}: "
                        f"{pace.n_on_time} on-time of {pace.n_selected} "
                        f"selected is below the quorum of "
                        f"{pace.quorum_required} "
                        f"(deadline {pace.deadline_s:.3f}s)"
                    )
                # Over-selection: eligible clients left out of the cohort
                # sit this round out, like churned-out devices.
                mask[:real] = np.where(pace.selected, mask[:real], 0)
                if p.store is None:
                    comp_full = np.full(p.dataset.padded_clients, np.inf, np.float32)
                    comp_full[:real] = pace.completion
                    kwargs["completion_time"] = torch.from_numpy(comp_full)
                else:
                    kwargs["completion_time"] = pace.completion
                kwargs["deadline"] = pace.deadline_s
            if p.store is None:
                # Over the whole population: the core keeps this rank's rows.
                kwargs["participate"] = torch.from_numpy(mask)
                kwargs["num_steps"] = (torch.from_numpy(np.asarray(p.num_steps, np.int64))
                                       if p.num_steps is not None else None)
            else:
                # Streamed population: the per-client arrays stay on the
                # host and FedCore.stream_round stages them block by block.
                kwargs.update(participate=mask[:real], num_steps=p.num_steps)
        if self.defense is not None:
            kwargs["defense"] = self.defense
        shift = (strace.label_shift if strace is not None and strace.label_shift is not None
                 and strace.label_shift.any() else None)
        sstats = astats = None
        t_step0 = time.perf_counter()
        with self._phase(operator.name, "train", round_idx):
            # Launches the round's kernels; the device may still be running
            # them when this phase closes.
            atk = self._attacks.get(p.name)
            if p.store is not None:
                atk = self._streamed_attack(p, atk, kwargs)
                if shift is not None:
                    kwargs.update(label_shift=shift,
                                  label_classes=self._label_classes(p, p.dataset.y))
                state, metrics, sstats = self.core.stream_round(
                    self.states[p.name], p.store,
                    stream_rows=self.scenario.stream_block_rows,
                    tracer=default_tracer(), **kwargs,
                )
            else:
                state, metrics, astats = self._resident_step(p, atk, shift, kwargs)
            self.states[p.name] = state
        with self._phase(operator.name, "host_transfer", round_idx):
            # The copy to the host is the sync point: this interval covers
            # the device work "train" only queued.
            client_loss = metrics.client_loss.float().cpu().numpy()
        if operator.name not in self._compiled_once:
            # First run of the round step for this operator (see the
            # catalog entry: eager mode compiles nothing, so this is the
            # warm-up round's wall time).
            self._compiled_once.add(operator.name)
            instrument(
                "ols_engine_compile_duration_seconds", self.registry
            ).labels(task_id=self.task_id, operator=operator.name).set(
                time.perf_counter() - t_step0
            )
        ok = np.isfinite(client_loss)
        flagged = None
        clipped = 0
        if self.defense is not None:
            clipped = int(metrics.clipped)
            if clipped:
                instrument("ols_engine_clipped_total", self.registry).labels(
                    task_id=self.task_id
                ).inc(clipped)
            if self.defense.score_enabled:
                flagged = self._flag_anomalies(p, round_idx, metrics, mask, ok)
        if self._quarantine is not None:
            # Strikes accrue only for clients that participated and came
            # back non-finite or anomaly-flagged; quarantined clients are
            # then reported failed in the per-class accounting, as the
            # reference reports dead phones.
            self._quarantine.observe(
                p.name, round_idx, mask[:real] > 0, ok[:real], flagged=flagged,
            )
            for ci in self._quarantine.quarantined(p.name):
                if ci < len(ok):
                    ok[ci] = False
            instrument(
                "ols_engine_quarantined_clients", self.registry
            ).labels(task_id=self.task_id).set(
                self._quarantine.num_quarantined()
            )
        rec = {
            "mean_loss": float(metrics.mean_loss),
            "clients_trained": int(metrics.clients_trained),
            "released": trace.num_released,
            "dropped": trace.num_dropped,
            "sim_duration_s": trace.round_duration(),
            "ok_mask": ok,
        }
        if self.defense is not None:
            rec["clipped"] = clipped
            rec["flagged"] = int(flagged.sum()) if flagged is not None else 0
        if atk is not None:
            rec["attacked"] = len(atk["clients"])
            rec["attack_mode"] = atk["mode"]
        if strace is not None:
            # The availability, churn and drift counts of the trace this
            # round trained under ride the history record.
            rec["scenario"] = strace.counts()
        if sstats is not None:
            # The stream cursor of the committed round rides the history
            # (and checkpoint meta): a round is atomic (one server commit
            # at its close), so a crash mid-stream replays the round.
            rec["stream"] = {
                "blocks": sstats.blocks,
                "cursor": sstats.blocks,
                "block_rows": sstats.block_rows,
                "rows": sstats.rows,
                "host_transfer_s": sstats.host_transfer_s,
                "transfer_bytes": sstats.transfer_bytes,
                "overlap_fraction": sstats.overlap_fraction,
                "peak_hbm_bytes_est": sstats.peak_hbm_bytes_est,
                "staging_s": sstats.staging_s,
            }
        if pace is not None:
            rec.update(self._pacing_record(pace, int(metrics.stragglers)))
        if aplan is not None:
            rec.update(self._async_record(p, aplan, async_completion, astats, metrics,
                                          mask, ok))
        if self.core.algorithm.personalized:
            rec["personal_loss"] = float(metrics.personal_loss)
        return rec

    def _resident_step(self, p: DataPopulation, atk, shift: Optional[np.ndarray],
                       kwargs: Dict[str, Any]):
        """The core call of a resident population's train round, with the
        label flip and label drift swapped in for this launch only.
        Returns ``(state, metrics, async_stats)``, the stats None for a
        synchronous round."""
        if atk is not None and atk["scale"] is not None:
            # Byzantine update attack (sign_flip / scale): a per-client
            # delta multiplier.
            kwargs["attack_scale"] = torch.from_numpy(atk["scale"])
        y_swap = atk["y"] if atk is not None else None
        if shift is not None:
            # Label drift, scoped to this train launch like the label flip
            # and composing with it: drift rotates whatever labels the
            # round would otherwise train on.
            base = y_swap if y_swap is not None else p.dataset.y
            y_swap = self._drift_labels(p, base, shift)
        clean_y = None
        if y_swap is not None:
            # The swap is scoped to this train launch: the finally puts the
            # clean labels back, so same-round eval operators and later
            # rounds see them.
            clean_y = p.dataset.y
            p.dataset = dataclasses.replace(p.dataset, y=y_swap)
        astats = None
        try:
            state = self.states[p.name]
            if self.core.algorithm.personalized:
                personal = self.personal_states.get(p.name)
                if personal is None:
                    personal = self.core.init_personal(state, p.dataset.num_clients)
                state, metrics, personal = self.core.round_step(
                    state, p.dataset, personal=personal, **kwargs)
                self.personal_states[p.name] = personal
            elif self.core.algorithm.control_variates:
                control = self.control_states.get(p.name)
                if control is None:
                    control = self.core.init_control(state, p.dataset.num_clients)
                state, metrics, control = self.core.round_step(
                    state, p.dataset, control=control, **kwargs)
                self.control_states[p.name] = control
            elif "async_plan" in kwargs:
                state, metrics, astats = self.core.round_step(state, p.dataset, **kwargs)
            else:
                state, metrics = self.core.round_step(state, p.dataset, **kwargs)
        finally:
            if clean_y is not None:
                p.dataset = dataclasses.replace(p.dataset, y=clean_y)
        return state, metrics, astats

    def _streamed_attack(self, p: DataPopulation, atk, kwargs: Dict[str, Any]):
        """The part of a population's attack that a streamed round applies:
        sign_flip and scale, as host multipliers in ``kwargs``. A label flip
        swaps device labels and is resident-only: it is skipped with a
        warning. Returns the attack applied, or None."""
        if atk is None:
            return None
        if atk["scale"] is None:
            self.logger.warning(
                task_id=self.task_id, system_name="engine", module_name="runner",
                message=f"label_flip attack skipped for streamed "
                        f"population {p.name} (labels stream from the "
                        f"host store; use sign_flip/scale)",
            )
            return None
        kwargs["attack_scale"] = atk["scale"][:p.dataset.num_real_clients]
        return atk

    # ------------------------------------------------- scenario / streaming
    def _device(self, p: DataPopulation) -> torch.device:
        """The device of a population's rounds: a resident population's
        dataset's; a streamed one's (its dataset stays on the host) its
        state's, or ``p.device`` before the state exists."""
        if p.store is None:
            return p.dataset.x.device
        state = self.states.get(p.name)
        if state is not None:
            return next(iter(state.params.values())).device
        return resolve_device(p.device)

    def _scenario_model(self, p: DataPopulation) -> ScenarioModel:
        """One ScenarioModel per population over its real clients, built
        lazily and seeded with the trace seed, so every process, and every
        relaunch, realizes the same fleet."""
        m = self._scenario_models.get(p.name)
        if m is None:
            m = ScenarioModel(
                self.scenario, p.dataset.num_real_clients, seed=self.trace_seed,
                class_of_client=p.class_of_client, device_classes=p.device_classes,
            )
            self._scenario_models[p.name] = m
        return m

    def _label_classes(self, p: DataPopulation, base) -> int:
        """The label-drift modulus: the population's class count when the
        bridge supplied it, else the observed max(y) + 1 over every rank's
        labels."""
        if p.num_classes:
            return int(p.num_classes)
        return self._global_max(base) + 1

    def _global_max(self, y) -> int:
        """The largest label over the whole population (every rank's rows)."""
        top = torch.as_tensor(y).max().reshape(1)
        return int(collectives.pmax([top], self.core.group)[0].item())

    def _local_rows(self, p: DataPopulation, clients) -> List[int]:
        """This rank's rows of the real clients among ``clients`` (global
        ids)."""
        lo, n = p.dataset.offset, p.dataset.num_clients
        real = p.dataset.num_real_clients
        return [c - lo for c in clients if lo <= c < lo + n and c < real]

    def _drift_labels(self, p: DataPopulation, base: torch.Tensor,
                      shift: np.ndarray) -> torch.Tensor:
        """The labels with the real clients' rotated by their drift shift,
        modulo the class count (on the labels' device; the integers numpy's
        rotation gives). ``base`` is this rank's rows, ``shift`` the real
        population's."""
        n_cls = self._label_classes(p, base)
        y = base.clone()
        lo = p.dataset.offset
        rows = self._local_rows(p, range(lo, lo + p.dataset.num_clients))
        if rows:
            sh = torch.from_numpy(np.asarray(shift[lo:lo + len(rows)], np.int64)).to(y.device)
            y[:len(rows)] = (base[:len(rows)] + sh[:, None]) % n_cls
        return y

    def _flag_anomalies(self, p: DataPopulation, round_idx: int, metrics,
                        mask: np.ndarray, ok: np.ndarray) -> Optional[np.ndarray]:
        """The anomaly feedback loop: a participant whose Krum-style score
        exceeds ``anomaly_threshold x median(score)`` is flagged (and then
        accrues a quarantine strike). The median normalization makes the
        threshold model- and scale-free. Returns the [real] flags, or None
        when no score is positive."""
        real = p.dataset.num_real_clients
        scores = metrics.anomaly_score.cpu().numpy()[:real]
        # scores > 0 aligns the host mask with the round's own participants:
        # a selected client that missed the deadline had its weight zeroed
        # and scores exactly 0; it must not be flagged for an update that
        # was never aggregated.
        part = (mask[:real] > 0) & ok[:real] & (scores > 0)
        vals = scores[part]
        med = float(np.median(vals)) if vals.size else 0.0
        if med <= 0:
            return None
        instrument("ols_engine_anomaly_ratio", self.registry).labels(
            task_id=self.task_id
        ).observe_many(vals / med)
        flagged = np.zeros(real, bool)
        flagged[part] = vals > self.defense.anomaly_threshold * med
        ids = np.nonzero(flagged)[0]
        if len(ids):
            self._rlog.record(
                CLIENT_FLAGGED, point="runner.defense",
                task_id=self.task_id, round_idx=round_idx,
                population=p.name,
                clients=[int(i) for i in ids[:64]],
                num_clients=int(len(ids)),
                threshold=float(self.defense.anomaly_threshold),
                median_score=med,
            )
        return flagged

    def _pacing_record(self, pace: RoundPacing, stragglers: int) -> Dict[str, Any]:
        """A deadline round's record fields and series. Stragglers of record
        come from the round's own deadline mask (``metrics.stragglers``);
        the adaptive controller observes the cohort's completion times."""
        finite = pace.completion[np.isfinite(pace.completion)]
        instrument("ols_engine_stragglers_total", self.registry).labels(
            task_id=self.task_id
        ).inc(stragglers)
        instrument("ols_engine_completion_time_seconds", self.registry).labels(
            task_id=self.task_id
        ).observe_many(finite)
        if np.isfinite(pace.deadline_s):
            instrument("ols_engine_round_deadline_seconds", self.registry).labels(
                task_id=self.task_id
            ).observe(pace.deadline_s)
        # Updated only on rounds that launched: a rolled-back round's
        # observation is discarded with the rest of its state.
        self._pacer.observe(finite)
        # Tail idle of the synchronous round: every on-time update waits
        # from its arrival until the single round-close commit.
        on_time = pace.completion[np.isfinite(pace.completion)
                                  & (pace.completion <= pace.deadline_s)]
        idle = float(np.clip(pace.round_close_s() - on_time, 0.0, None).sum())
        instrument("ols_engine_idle_seconds_total", self.registry).labels(
            task_id=self.task_id, mode="sync"
        ).inc(idle)
        return {
            "selected": pace.n_selected,
            "on_time": pace.n_on_time,
            "stragglers": stragglers,
            "deadline_s": pace.deadline_s if np.isfinite(pace.deadline_s) else None,
            "round_close_s": pace.round_close_s(),
            "idle_s": round(idle, 6),
        }

    def _async_record(self, p: DataPopulation, aplan, completion: np.ndarray, astats,
                      metrics, mask: np.ndarray, ok: np.ndarray) -> Dict[str, Any]:
        """An async round's record fields and series: commits, staleness,
        buffer depth and the committed updates' buffer wait (idle), from the
        plan and the round's own stats. ``ok`` is the accounting mask after
        the quarantine."""
        real = p.dataset.num_real_clients
        commits = int(astats.commits)
        committed = int(metrics.clients_trained)
        self._async_commit_clock += commits
        idle = aplan.idle_seconds(completion)
        rec: Dict[str, Any] = {
            "commits": commits,
            "committed": committed,
            "stale_dropped": int(astats.dropped_stale),
            "buffer_size": self.async_config.buffer_size,
            "windows": aplan.num_windows,
            "idle_s": round(idle, 6),
            "commit_clock": self._async_commit_clock,
        }
        instrument("ols_engine_buffer_depth", self.registry).labels(
            task_id=self.task_id
        ).set(committed / commits if commits else 0.0)
        # A committed client's staleness is its commit-window index (server
        # commits between its dispatch and its commit).
        committed_mask = ((aplan.window[:real] >= 0) & ~aplan.stale_dropped_mask()[:real]
                          & ok[:real] & (mask[:real] > 0))
        if committed_mask.any():
            instrument("ols_engine_staleness_rounds", self.registry).labels(
                task_id=self.task_id
            ).observe_many(aplan.window[:real][committed_mask].astype(np.float64))
            # The round's simulated makespan, the last committed arrival
            # (the final commit's clock): the convergence clock reads it.
            rec["round_close_s"] = float(completion[committed_mask].max())
        instrument("ols_engine_idle_seconds_total", self.registry).labels(
            task_id=self.task_id, mode="async"
        ).inc(idle)
        return rec

    def _feed_cost(self, round_wall_s: float) -> None:
        """Feed this round's measured wall time into the cost oracle. Round
        0's wall is held back until round 1 can classify it: only a round 0
        much slower than round 1 refines the family's start-up (compile_s)
        estimate."""
        if self._cost_round0_wall is None:
            self._cost_round0_wall = round_wall_s
            return
        self._cost_oracle.record_measurement(
            self._cost_family, round_time_s=round_wall_s
        )
        if not self._cost_compile_fed:
            self._cost_compile_fed = True
            if self._cost_round0_wall > 1.5 * round_wall_s:
                self._cost_oracle.record_measurement(
                    self._cost_family, compile_s=self._cost_round0_wall
                )

    # ------------------------------------------------------------ convergence
    def _observe_convergence(self, round_idx: int,
                             round_record: Dict[str, Any],
                             wall_s: float) -> None:
        """Advance the convergence clocks for this completed round and, at
        the configured cadence, record an eval point. The quality value
        comes from an eval operator's ``eval_loss``/``eval_acc`` record when
        this round produced one; otherwise the global model is evaluated
        directly on the first population with held-out eval data."""
        tracker = self._convergence
        # Simulated round duration: the longest population's round close
        # (deadline rounds) or dispatch-trace duration this round.
        sim_s = 0.0
        for op in self.operators:
            if op.kind != "train":
                continue
            for rec in (round_record.get(op.name) or {}).values():
                dur = rec.get("round_close_s")
                if dur is None:
                    dur = rec.get("sim_duration_s")
                if dur:
                    sim_s = max(sim_s, float(dur))
        tracker.observe_round(round_idx, sim_s, wall_s)
        if not tracker.should_eval(round_idx, self.rounds):
            return
        eval_loss = eval_acc = None
        for op in self.operators:
            for rec in (round_record.get(op.name) or {}).values():
                if isinstance(rec, dict) and rec.get("eval_acc") is not None:
                    eval_loss, eval_acc = rec.get("eval_loss"), rec["eval_acc"]
                    break
            if eval_acc is not None:
                break
        t_eval0 = time.perf_counter()
        if eval_acc is None:
            for p in self.populations:
                if p.eval_data is not None:
                    x, y = p.eval_data
                    with self._phase("convergence", "eval", round_idx):
                        eval_loss, eval_acc = self.core.evaluate(
                            self.states[p.name].params, x, y
                        )
                    break
        if eval_acc is None:
            if not self._convergence_warned:
                self._convergence_warned = True
                self.logger.warning(
                    task_id=self.task_id, system_name="engine",
                    module_name="runner",
                    message="convergence tracking enabled but no "
                            "population has eval_data and no eval "
                            "operator ran; the quality series stays "
                            "empty",
                )
            return
        tracker.observe_eval(round_idx, eval_loss, eval_acc)
        instrument("ols_engine_eval_accuracy", self.registry).labels(
            task_id=self.task_id
        ).set(float(eval_acc))
        # Published on every reached eval, not only the reach transition: a
        # resumed process rehydrates reached=True from checkpoint meta and
        # must expose the to-target gauges in its registry too.
        if tracker.reached:
            if tracker.sim_seconds_to_target is not None:
                # None = the config has no simulated clock; 0.0 would read
                # as "reached instantaneously".
                instrument(
                    "ols_engine_time_to_target_seconds", self.registry
                ).labels(task_id=self.task_id, clock="sim").set(
                    tracker.sim_seconds_to_target
                )
            instrument(
                "ols_engine_time_to_target_seconds", self.registry
            ).labels(task_id=self.task_id, clock="wall").set(
                tracker.wall_seconds_to_target
            )
            instrument(
                "ols_engine_rounds_to_target", self.registry
            ).labels(task_id=self.task_id).set(tracker.rounds_to_target)
        if self.perf is not None:
            # A distinct convergence_eval timing row per eval point: the
            # quality series then rides the performance manager's rows, so
            # get_performance()["convergence"] answers like every
            # throughput number.
            from olearning_sim_tpu_torch.performancemgr.performance_manager import (
                RoundTiming,
            )

            extra = {
                "eval_acc": float(eval_acc),
                "sim_s": tracker.sim_seconds_total,
                "wall_s": tracker.wall_seconds_total,
                "reached": 1.0 if tracker.reached else 0.0,
            }
            if eval_loss is not None:
                extra["eval_loss"] = float(eval_loss)
            if tracker.config.target_accuracy is not None:
                extra["target"] = float(tracker.config.target_accuracy)
            if tracker.rounds_to_target is not None:
                extra["rounds_to_target"] = float(tracker.rounds_to_target)
                if tracker.sim_seconds_to_target is not None:
                    extra["sim_s_to_target"] = float(tracker.sim_seconds_to_target)
                extra["wall_s_to_target"] = float(tracker.wall_seconds_to_target)
            self.perf.record_round(RoundTiming(
                task_id=self.task_id, round_idx=round_idx,
                operator="convergence_eval",
                duration_s=time.perf_counter() - t_eval0,
                extra=extra,
            ))

    def convergence_record(self) -> Optional[Dict[str, Any]]:
        """The task's convergence record (engine/convergence.py), or None
        when tracking is off."""
        if self._convergence is None:
            return None
        return self._convergence.record()

    def _run_eval(self, p: DataPopulation) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"eval_loss": None, "eval_acc": None}
        if p.eval_data is not None:
            x, y = p.eval_data
            loss, acc = self.core.evaluate(self.states[p.name].params, x, y)
            rec.update(eval_loss=loss, eval_acc=acc)
        personal = self.personal_states.get(p.name)
        if personal is not None:
            # Ditto metric of record: personalized models on own local data.
            ploss, pacc = self.core.evaluate_personal(personal, p.dataset)
            rec.update(personal_eval_loss=ploss, personal_eval_acc=pacc)
        return rec

    # --------------------------------------------------- model file interop
    def _host_params(self, params):
        """The global model as a model file holds it: the flax-layout tree of
        host f32 arrays (``weights.params_to_jax``)."""
        return params_to_jax(params, heads=getattr(self.core.model, "heads", None))

    def _set_params(self, host_params, next_round: Optional[int] = None) -> None:
        """Install ingested params into every population's state. When the
        ingested model represents completed training through round
        ``next_round - 1``, the round counter moves too: it seeds every
        round's minibatch draws, so leaving it at 0 would make a resumed
        run replay round 0's minibatches."""
        params = params_from_jax(host_params)
        for name, state in list(self.states.items()):
            dev = next(iter(state.params.values())).device
            state = dataclasses.replace(
                state, params={k: v.to(dev) for k, v in params.items()})
            if next_round is not None:
                state = dataclasses.replace(state, round_idx=int(next_round))
            self.states[name] = state

    def _warm_start(self) -> None:
        """Round-0 model ingestion: ``Model.modelPath`` via the model repo
        (reference ``download_model_files`` round-0 branch,
        ``utils_run_task.py:327-397``)."""
        template = self._host_params(
            self.states[self.populations[0].name].params
        )
        self._set_params(self.model_io.load_path(self.warm_start_path, template))
        self.logger.info(
            task_id=self.task_id, system_name="engine", module_name="runner",
            message=f"warm-started from {self.warm_start_path}",
        )

    def _resume_from_exports(self) -> int:
        """Resume from the newest exported round model (the reference's
        ``{task_id}_{round}_result_model`` update style) when no checkpoint
        claimed the task first. The model file carries params only, so a
        stateful server optimizer (FedAdam moments) restarts cold, as an
        external aggregator would see it. Probes upward from round 0."""
        last = None
        try:
            for r in range(self.rounds):
                if not self.model_io.repo.exists(self.model_io._name(r)):
                    break
                last = r
        except NotImplementedError:
            # Download-only repos cannot probe; warm start still works,
            # export-resume does not.
            return 0
        if last is None:
            return 0
        template = self._host_params(
            self.states[self.populations[0].name].params
        )
        self._set_params(self.model_io.load(last, template), next_round=last + 1)
        self.logger.info(
            task_id=self.task_id, system_name="engine", module_name="runner",
            message=f"resumed from exported round model {last}",
        )
        return last + 1

    # ------------------------------------------------------------- checkpoint
    def _client_state_slot(self):
        """The active per-client state dict and its initializer — Ditto
        personal params or SCAFFOLD control variates (mutually exclusive).
        Both ride the checkpoint's per-population tree slot so a resumed run
        keeps its drift/personalization state instead of re-initializing."""
        if self.core.algorithm.personalized:
            return self.personal_states, self.core.init_personal
        if self.core.algorithm.control_variates:
            return self.control_states, self.core.init_control
        return None, None

    def _materialized_client_states(self):
        slot, init = self._client_state_slot()
        if slot is None:
            return {}
        for p in self.populations:
            if p.name not in slot:
                slot[p.name] = init(self.states[p.name], p.dataset.num_clients)
        return slot

    def _full_states(self) -> Dict[str, Any]:
        """The server states as a checkpoint holds them: under the sharded
        update, the optimizer state gathered from every rank's shard into
        its full flat padded layout (a collective)."""
        return {name: dataclasses.replace(st, opt_state=self.core.full_opt_state(st.opt_state))
                for name, st in self.states.items()}

    def _full_client_states(self) -> Dict[str, Any]:
        """The per-client state as a checkpoint holds it: every rank's rows,
        over the whole padded population (a collective)."""
        return {name: self.core.gather_clients(st)
                for name, st in self._materialized_client_states().items()}

    def _try_resume(self) -> int:
        """Restore the latest round checkpoint if one exists; returns the
        round index to resume from (0 when starting fresh). Every rank reads
        the same step and keeps its own shard of it."""
        if self.checkpointer is None:
            return 0
        restored = self.checkpointer.restore(self._full_states(), self._full_client_states())
        if restored is None:
            return 0
        last_round, states, client_states, history = restored
        states = {name: dataclasses.replace(st, opt_state=self.core.local_opt_state(st.opt_state))
                  for name, st in states.items()}
        by_name = {p.name: p.dataset for p in self.populations}
        client_states = {name: self.core.local_clients(st, by_name[name])
                         for name, st in client_states.items()}
        # The restore may have fallen back past an unreadable newer step; it
        # must not stay newest, or every restart would fall back, and lose
        # the replay, again.
        with contextlib.suppress(Exception):
            self.checkpointer.discard_steps_after(last_round)
        self.states = states
        if self.core.algorithm.personalized:
            self.personal_states = client_states
        elif self.core.algorithm.control_variates:
            self.control_states = client_states
        self.history = history
        self._repace()
        self._requarantine()
        self._reasync()
        self._reconverge()
        self.logger.info(
            task_id=self.task_id, system_name="engine", module_name="runner",
            message=f"resumed from checkpoint: round {last_round} complete",
        )
        return last_round + 1

    def _checkpoint(self, round_idx: int) -> None:
        if self.checkpointer is None:
            return
        if (round_idx + 1) % self.checkpoint_every and round_idx != self.rounds - 1:
            return
        # Per-client state is materialized for every population before
        # saving, so the step's tree matches the restore template even when
        # no train operator has run yet.
        kwargs = {}
        if round_idx <= self._force_checkpoint_until:
            kwargs["force"] = True
        self.checkpointer.save(
            round_idx, self._full_states(), self._full_client_states(),
            self.history, **kwargs
        )

    def _checkpoint_on_stop(self, last_round: int) -> None:
        """Planned-preemption fence: a cooperative stop force-commits the
        last completed round, so a migrated task resumes from the fence
        round instead of replaying back to the last cadence checkpoint.
        No-op without a checkpointer or when the round is already durable;
        a save failure must not block the stop (the resume replays the gap
        bitwise anyway)."""
        if self.checkpointer is None or last_round < 0:
            return
        try:
            # Settle the in-flight commit first so the latest-step read is
            # authoritative (saving an already-committed step raises).
            self.checkpointer.wait()
            latest = self.checkpointer.latest_round()
            if latest is not None and latest >= last_round:
                return
            self.checkpointer.save(
                last_round, self._full_states(),
                self._full_client_states(), self.history,
            )
            self.checkpointer.wait()
        except Exception as e:  # noqa: BLE001 — fence best-effort
            self.logger.warning(
                task_id=self.task_id, system_name="engine",
                module_name="runner",
                message=f"fence checkpoint at round {last_round} failed "
                        f"({e}); resume will replay from the last "
                        f"committed step",
            )

    def operator_inputs(self, operator: OperatorSpec) -> Dict[str, Any]:
        """Named upstream outputs for ``operator`` this round: each entry
        maps an upstream operator's name (from ``operator.inputs``) to its
        per-population record from the current round, so train -> eval ->
        custom chains compose (reference ``utils.py:647-651``)."""
        return {
            name: self._round_outputs[name]
            for name in operator.inputs
            if name in self._round_outputs
        }

    def _call_custom(self, operator: OperatorSpec, round_idx: int,
                     p: DataPopulation) -> Dict[str, Any]:
        """Invoke a custom operator callback, passing the population when the
        callback requires a 4th positional argument (inspected once per
        callback: catching TypeError at call time would mask errors raised
        inside it)."""
        fn = operator.custom_fn
        takes_population = self._custom_arity.get(id(fn))
        if takes_population is None:
            try:
                params = inspect.signature(fn).parameters.values()
                required = [
                    prm for prm in params
                    if prm.kind in (prm.POSITIONAL_ONLY, prm.POSITIONAL_OR_KEYWORD)
                    and prm.default is prm.empty
                ]
                takes_population = (
                    len(required) >= 4
                    or any(prm.kind == prm.VAR_POSITIONAL for prm in params)
                )
            except (TypeError, ValueError):
                takes_population = True
            self._custom_arity[id(fn)] = takes_population
        if takes_population:
            return fn(self, round_idx, operator, p)
        return fn(self, round_idx, operator)

    # ------------------------------------------------------------ resilience
    def _capture_snapshot(self, round_idx: int) -> Dict[str, Any]:
        return {
            "round_idx": round_idx,
            "states": _copy_tree(self.states),
            "personal": _copy_tree(self.personal_states),
            "control": _copy_tree(self.control_states),
            "history": list(self.history),
            "quarantine": (self._quarantine.snapshot()
                           if self._quarantine is not None else None),
        }

    def _restore_snapshot(self) -> None:
        snap = self._round_snapshot
        if snap is None:
            return
        # Copied out of the snapshot, not moved: a second failure of the
        # same round must be able to restore again.
        self.states = _copy_tree(snap["states"])
        self.personal_states = _copy_tree(snap["personal"])
        self.control_states = _copy_tree(snap["control"])
        self.history = list(snap["history"])
        self._repace()
        self._reasync()
        self._reconverge()
        if self._quarantine is not None and snap["quarantine"] is not None:
            self._quarantine.restore(snap["quarantine"])

    def _repace(self) -> None:
        """Rehydrate the adaptive deadline controller from the history just
        restored (rollback or checkpoint resume): the newest record carrying
        pacing state holds the controller as of that round's completion, so
        replayed rounds see the deadlines they first saw."""
        if self._pacer is not None:
            self._pacer.load_from_history(self.history)

    def _reasync(self) -> None:
        """Rehydrate the async commit clock from the history just restored
        (rollback or checkpoint resume): the newest record carrying an
        ``async_clock`` holds the cumulative commit count as of that
        round's completion, so replays continue the sequence instead of
        double-counting commits."""
        if self.async_config is None:
            return
        for rec in reversed(self.history):
            clock = rec.get("async_clock")
            if clock is not None:
                self._async_commit_clock = int(clock)
                return
        self._async_commit_clock = 0

    def _reconverge(self) -> None:
        """Rehydrate the convergence tracker from the history just restored
        (rollback or checkpoint resume): the ordered ``convergence_state``
        records carry the eval series as increments and the newest one the
        cumulative clocks and to-target facts. No carrying record (rollback
        to round 0) resets the tracker."""
        if self._convergence is None:
            return
        self._convergence.load_history([
            rec["convergence_state"] for rec in self.history
            if rec.get("convergence_state") is not None
        ])

    def _requarantine(self) -> None:
        """Rehydrate quarantine state from the history just restored from a
        checkpoint: the newest record carrying a ``quarantine_state`` holds
        the manager as of that round's completion, so a relaunched process
        replays the masks, and so the aggregation, bitwise. Without a
        carrying record (fresh start) the current state, e.g. an operator
        preseed, is kept."""
        if self._quarantine is None:
            return
        for rec in reversed(self.history):
            st = rec.get("quarantine_state")
            if st is not None:
                self._quarantine.load_json(st)
                return

    def _maybe_poison(self, round_idx: int) -> None:
        """``runner.poison_clients`` injection point: permanently corrupt the
        listed clients' features to NaN (a diverged device), so that their
        local training produces non-finite updates that exercise the
        aggregation gate and the quarantine path end to end.

        Spec payload: ``{"clients": [...], "population": "name"?}`` —
        population omitted poisons every population's listed rows. The rows
        are written into a clone of the device features; integer (token)
        features are left alone with a warning."""
        spec = faults.fire("runner.poison_clients", round_idx=round_idx,
                           task_id=self.task_id)
        if spec is None:
            return
        payload = spec.payload or {}
        clients = [int(c) for c in payload.get("clients", [])]
        pop_name = payload.get("population")
        for p in self.populations:
            if pop_name and p.name != pop_name:
                continue
            if p.store is not None:
                self.logger.warning(
                    task_id=self.task_id, system_name="engine",
                    module_name="runner",
                    message=f"poison_clients: population {p.name} is "
                            f"streamed (host store); NaN poisoning "
                            f"skipped",
                )
                continue
            ds = p.dataset
            if not ds.x.is_floating_point():
                self.logger.warning(
                    task_id=self.task_id, system_name="engine",
                    module_name="runner",
                    message=f"poison_clients: population {p.name} has "
                            f"integer features; NaN poisoning skipped",
                )
                continue
            idx = self._local_rows(p, clients)
            if not idx:
                continue
            x = ds.x.clone()
            x[torch.tensor(idx, device=x.device)] = float("nan")
            p.dataset = dataclasses.replace(ds, x=x)

    def _maybe_attack(self, round_idx: int) -> None:
        """``runner.attack_clients`` injection point: seeded byzantine
        client attacks, the finite adversarial behaviour the finiteness gate
        cannot catch and the defense exists for.

        Spec payload: ``{"mode": "sign_flip"|"scale"|"label_flip",
        "clients": [...]?, "fraction": 0.1?, "factor": ...?}``; scope to one
        population with the spec's ``match`` filter (the context is the
        population name). Without a ``clients`` list, a ``fraction`` of the
        population is drawn seeded by ``(plan seed, round, crc32(population
        name))``, so the draw replays exactly; whether a spec fires at all
        follows the injector's hit counting, so a plan that must replay
        bitwise across rollbacks and resumes scopes attacks with
        ``rounds=[...]`` or ``times=-1``. ``sign_flip`` / ``scale`` multiply
        the client's delta in the round (by -1 / by ``factor``);
        ``label_flip`` trains that round's train launch on labels ``c ->
        num_classes - 1 - c`` (:meth:`_run_train` scopes the swap).
        """
        self._attacks = {}
        inj = faults.active_injector()
        for p in self.populations:
            spec = faults.fire("runner.attack_clients", context=p.name,
                               round_idx=round_idx, task_id=self.task_id)
            if spec is None:
                continue
            payload = spec.payload or {}
            mode = payload.get("mode", "sign_flip")
            if mode not in ("sign_flip", "scale", "label_flip"):
                raise ValueError(
                    f"runner.attack_clients: unknown mode {mode!r} "
                    f"(known: sign_flip, scale, label_flip)"
                )
            real = p.dataset.num_real_clients
            clients = payload.get("clients")
            if clients is None:
                frac = float(payload.get("fraction", 0.1))
                k = min(real, max(1, int(math.ceil(frac * real))))
                rng = np.random.default_rng([
                    int(inj.plan.seed) if inj is not None else 0,
                    int(round_idx), zlib.crc32(p.name.encode()),
                ])
                clients = rng.choice(real, size=k, replace=False)
            clients = sorted(int(c) for c in clients if 0 <= int(c) < real)
            if not clients:
                continue
            atk: Dict[str, Any] = {"mode": mode, "clients": clients,
                                   "scale": None, "y": None}
            if mode in ("sign_flip", "scale"):
                factor = float(payload.get(
                    "factor", -1.0 if mode == "sign_flip" else 10.0
                ))
                scale = np.ones(p.dataset.padded_clients, np.float32)
                scale[clients] = np.float32(factor)
                atk["scale"] = scale
            else:  # label_flip: class c -> (num_classes - 1 - c)
                if p.name not in self._clean_y:
                    # A streamed population's labels are host arrays.
                    self._clean_y[p.name] = torch.as_tensor(p.dataset.y).clone()
                y = self._clean_y[p.name].clone()
                n_cls = self._global_max(y) + 1
                # A resident shard's rows; a streamed population's are all.
                rows = self._local_rows(p, clients) if p.store is None else clients
                idx = torch.tensor(rows, dtype=torch.int64, device=y.device)
                y[idx] = n_cls - 1 - y[idx]
                atk["y"] = y
            self._attacks[p.name] = atk

    def _rollback(self, round_idx: int,
                  error: BaseException) -> Optional[int]:
        """Restore the last good state; returns the round to (re-)execute,
        or None when nothing restorable exists.

        A generic failure rolls back to the in-memory snapshot of this
        round's entry state (falling back to the checkpointer when
        ``snapshot_rounds`` is off). A :class:`HostPreemption` models process
        death: recovery prefers the checkpointer (falling back across corrupt
        steps), replaying any rounds after the last readable checkpoint, or
        resuming *past* the failed round when its checkpoint already
        committed before death. When no checkpoint has committed yet the
        in-memory snapshot is used as a lenient approximation (a really
        preempted host would replay from round 0)."""
        preempt = isinstance(error, HostPreemption)
        # Quarantine state as of the failure: the right state to keep when
        # the checkpoint shows the failed round durably completed (its
        # observe() already ran before the save).
        qcur = (self._quarantine.snapshot()
                if self._quarantine is not None else None)
        had_snapshot = self._round_snapshot is not None
        self._restore_snapshot()
        resume_round = round_idx
        if self.checkpointer is not None:
            with contextlib.suppress(Exception):
                # A save may be in flight (or have failed) at "death".
                self.checkpointer.wait()
            if preempt or not had_snapshot:
                resumed = self._try_resume()
                if resumed == 0 and not had_snapshot:
                    # No checkpoint yet and no snapshot: nothing was
                    # restored, so a retry would replay on partially
                    # mutated state.
                    return None
                if resumed > 0:
                    resume_round = resumed
                    if self._quarantine is not None:
                        qsnap = (qcur if resume_round > round_idx
                                 else self._qsnapshots.get(resume_round - 1))
                        if qsnap is not None:
                            self._quarantine.restore(qsnap)
                    if resume_round != round_idx:
                        self._round_snapshot = None  # belongs to another round
            # Replayed rounds re-save their steps; a partially-saved step
            # from the failed attempt (or stale/corrupt future steps after a
            # checkpoint fallback) must not shadow them.
            with contextlib.suppress(Exception):
                self.checkpointer.discard_steps_after(resume_round - 1)
            self._force_checkpoint_until = max(
                self._force_checkpoint_until, round_idx
            )
        self._rlog.record(
            ROLLBACK, point="runner.rollback", task_id=self.task_id,
            round_idx=round_idx, to_round=resume_round, preempt=preempt,
            error=f"{type(error).__name__}: {str(error)[:200]}",
        )
        return resume_round

    def _handle_round_failure(self, round_idx: int, attempts: int,
                              error: BaseException):
        """Dispatch a failed round per the operator-level failure policy.
        Returns (action, next_round, next_attempts); action "raise" tells the
        caller to re-raise ``error``."""
        cfg = self.resilience
        policy = cfg.failure_policy if cfg is not None else FailurePolicy.FAIL_TASK
        self.logger.error(
            task_id=self.task_id, system_name="engine", module_name="runner",
            message=f"round {round_idx} failed "
                    f"({type(error).__name__}: {error}); policy={policy}",
        )
        if cfg is None or policy == FailurePolicy.FAIL_TASK:
            return "raise", round_idx, attempts
        if policy == FailurePolicy.SKIP_ROUND:
            if self._round_snapshot is None:
                # No rollback source: skipping would keep the round's
                # partial mutations. Degrade to fail_task.
                self.logger.error(
                    task_id=self.task_id, system_name="engine",
                    module_name="runner",
                    message="skip_round needs snapshot_rounds; failing task",
                )
                return "raise", round_idx, attempts
            self._restore_snapshot()
            if self.checkpointer is not None:
                # The round may have checkpointed before failing (the stop
                # barrier or the model export failed after the save); that
                # step holds the state this skip just discarded and must not
                # resurrect it on a restart.
                with contextlib.suppress(Exception):
                    self.checkpointer.wait()
                with contextlib.suppress(Exception):
                    self.checkpointer.discard_steps_after(round_idx - 1)
            self._rlog.record(
                SKIP_ROUND, point="runner.round", task_id=self.task_id,
                round_idx=round_idx,
                error=f"{type(error).__name__}: {str(error)[:200]}",
            )
            instrument("ols_engine_rounds_total", self.registry).labels(
                task_id=self.task_id, status="skipped"
            ).inc()
            self.history.append({
                "round": round_idx, "skipped": True,
                "error": f"{type(error).__name__}: {str(error)[:200]}",
            })
            return "continue", round_idx + 1, 0
        # FailurePolicy.RETRY
        if attempts >= cfg.max_round_retries:
            return "raise", round_idx, attempts
        if self._round_snapshot is None and self.checkpointer is None:
            # Nothing to roll back to: re-running on partially mutated state
            # would double-apply trained populations.
            self.logger.error(
                task_id=self.task_id, system_name="engine",
                module_name="runner",
                message="retry needs snapshot_rounds or a checkpointer; "
                        "failing task",
            )
            return "raise", round_idx, attempts
        next_round = self._rollback(round_idx, error)
        if next_round is None:
            self.logger.error(
                task_id=self.task_id, system_name="engine",
                module_name="runner",
                message="retry found no recoverable state; failing task",
            )
            return "raise", round_idx, attempts
        if cfg.round_backoff_s > 0:
            time.sleep(cfg.round_backoff_s * (attempts + 1))
        return "continue", next_round, attempts + 1

    def _persist_resilience(self) -> None:
        """Per-task resilience digest into the task table (the task status
        API's ``resilience`` column)."""
        summary = self._rlog.summary(self.task_id)
        if not summary["counters"]:
            return
        with contextlib.suppress(Exception):
            self.task_repo.set_item_value(
                self.task_id, "resilience", json.dumps(summary)
            )

    # -------------------------------------------------------------------- run
    def _execute_round(self, round_idx: int, attempt: int = 0) -> str:
        """One full round: barriers, operators, accounting. Returns "ok",
        "stop" (cooperative stop observed), or "final" (final-round stop
        barrier tolerated)."""
        t_round0 = time.perf_counter()
        if not self.operator_flow.start():
            if self.stop_event is not None and self.stop_event.is_set():
                return "stop"  # barrier abandoned due to stop request
            raise RuntimeError(f"round {round_idx}: operator-flow start failed")

        round_record: Dict[str, Any] = {"round": round_idx}
        self._round_outputs = {}
        for operator in self.operators:
            routing_key = self._flow_start(operator, round_idx, attempt)
            self._live_routing_key = routing_key
            ok_by_population: Dict[str, np.ndarray] = {}
            op_record: Dict[str, Any] = {}
            # Only train operators advance clients; total client steps honor
            # heterogeneous per-class profiles.
            nc = total_steps = 0
            if operator.kind == "train":
                for p in self.populations:
                    real = p.dataset.num_real_clients
                    nc += real
                    total_steps += (
                        int(np.sum(p.num_steps[:real]))
                        if p.num_steps is not None
                        else real * self.core.config.max_local_steps
                    )
            timer = self.perf.time_round(
                self.task_id, round_idx, operator.name, num_clients=nc,
                local_steps=self.core.config.max_local_steps,
                total_client_steps=total_steps,
            ) if self.perf is not None else contextlib.nullcontext()
            with timer, default_tracer().span(
                f"round.{operator.name}", task_id=self.task_id,
                round_idx=round_idx, kind=operator.kind,
            ):
                for p in self.populations:
                    if operator.kind == "train":
                        r = self._run_train(p, round_idx, operator)
                        ok_by_population[p.name] = r.pop("ok_mask")
                    elif operator.kind == "eval":
                        with self._phase(operator.name, "eval", round_idx):
                            r = self._run_eval(p)
                        ok_by_population[p.name] = np.ones(
                            p.dataset.padded_clients, bool
                        )
                    elif operator.kind == "custom":
                        with self._phase(operator.name, "custom", round_idx):
                            r = self._call_custom(operator, round_idx, p) or {}
                        ok_by_population[p.name] = r.pop(
                            "ok_mask", np.ones(p.dataset.padded_clients, bool)
                        )
                    else:
                        raise ValueError(f"unknown operator kind {operator.kind!r}")
                    op_record[p.name] = r
                if operator.kind == "train" and hasattr(timer, "note"):
                    # The same counts the JAX runner notes.
                    timer.note(**{k: sum(rec.get(k, 0) for rec in op_record.values())
                                  for k in ("stragglers", "dropped", "clipped",
                                            "flagged", "attacked")})
            if operator.kind == "train" and nc:
                instrument(
                    "ols_engine_device_rounds_total", self.registry
                ).labels(task_id=self.task_id).inc(nc)
            self._flow_complete(routing_key)
            self._live_routing_key = None
            with self._phase(operator.name, "accounting", round_idx):
                self._analyze_results(operator, round_idx, ok_by_population)
            round_record[operator.name] = op_record
            self._round_outputs[operator.name] = op_record

        round_wall_s = time.perf_counter() - t_round0
        if self._convergence is not None:
            self._observe_convergence(round_idx, round_record, round_wall_s)
        if self._cost_oracle is not None and self._cost_family:
            self._feed_cost(round_wall_s)
        if self._pacer is not None and self.deadline.adaptive:
            # The controller after this round's observations rides the
            # history record, and so checkpoint meta (_repace).
            round_record["pacing"] = self._pacer.state_dict()
        if self._quarantine is not None:
            # Quarantine state after this round's observations rides the
            # history record, and so checkpoint meta (_requarantine).
            round_record["quarantine_state"] = self._quarantine.state_json()
        if self.async_config is not None:
            # The async commit clock rides checkpoint meta the same way, so
            # a resumed run reports a continuous commit sequence (_reasync).
            round_record["async_clock"] = self._async_commit_clock
        if self._convergence is not None:
            # The tracker's clocks, eval series and to-target facts ride
            # checkpoint meta the same way (_reconverge).
            round_record["convergence_state"] = self._convergence.state_json()
        self.history.append(round_record)
        # A preemption here dies with the round's work done but not yet
        # durable (the lost-round scenario rollback must absorb).
        faults.inject("runner.pre_checkpoint", context=str(round_idx),
                      round_idx=round_idx, task_id=self.task_id)
        with self._phase("round", "checkpoint", round_idx):
            self._checkpoint(round_idx)
        if self.writer and self.model_io is not None and not self._model_io_export_dead:
            # One global model per task (reference convention); multi-
            # population tasks export the first population's.
            try:
                with self._phase("round", "model_export", round_idx):
                    self.model_io.export(
                        round_idx,
                        self._host_params(
                            self.states[self.populations[0].name].params
                        ),
                    )
            except NotImplementedError as e:
                # Download-only repo: ingestion works, export cannot.
                self._model_io_export_dead = True
                self.logger.warning(
                    task_id=self.task_id, system_name="engine",
                    module_name="runner",
                    message=f"model export disabled: {e}",
                )

        if not self.operator_flow.stop():
            if self.stop_event is not None and self.stop_event.is_set():
                return "stop"
            if round_idx < self.rounds - 1:
                raise RuntimeError(f"round {round_idx}: operator-flow stop failed")
            # Final round: the work is done; don't block on the barrier
            # (reference ``run_task.py:319-322``).
            return "final"
        return "ok"

    def begin(self) -> None:
        """Arm the round loop: materialize per-population state, resume
        (checkpoint / exported model / warm start) and set the loop cursor.
        ``run()`` is exactly ``begin(); while step(): pass; finish()``. A
        population already in :attr:`states` keeps its state (a caller may
        install parameters before ``run()``)."""
        for p in self.populations:
            if p.name not in self.states:
                # crc32, not hash(): str hashes are randomized per process.
                self.states[p.name] = self.core.init_state(
                    seed=zlib.crc32(self.task_id.encode()) & 0x7FFFFFFF,
                    device=self._device(p),
                )
        start_round = self._try_resume()
        if start_round == 0 and self.model_io is not None:
            start_round = self._resume_from_exports()
        if start_round == 0 and self.warm_start_path:
            # Only a fresh start ingests the round-0 model; any resume
            # supersedes it.
            self._warm_start()
        cfg = self.resilience
        snapshotting = cfg is not None and cfg.snapshot_rounds and (
            cfg.failure_policy != FailurePolicy.FAIL_TASK
        )
        if self._quarantine is not None:
            self._qsnapshots[start_round - 1] = self._quarantine.snapshot()
        # Retry budget is per round (a rollback that resumes earlier than the
        # failed round must not refill it); flow_epoch numbers the
        # rollbacks, so a replayed round's deviceflow routing key is one its
        # earlier execution never used.
        self._loop = {
            "round_idx": start_round,
            "retries": {},
            "flow_epoch": 0,
            "snapshotting": snapshotting,
            "done": False,
        }

    def step(self) -> bool:
        """Execute at most one round (including its failure-policy
        dispatch); returns True while more rounds remain. An exception
        escaping means the task failed under its failure policy."""
        lp = self._loop
        if lp is None:
            raise RuntimeError("SimulationRunner.step() before begin()")
        if lp["done"] or lp["round_idx"] >= self.rounds:
            lp["done"] = True
            return False
        round_idx = lp["round_idx"]
        stopping = self.stop_event is not None and self.stop_event.is_set()
        if self.core.plan.n_devices > 1:
            # Every rank stops at the same round boundary.
            stopping = collectives.agree(stopping, self.core.plan.world_group)
        if stopping:
            # Cooperative stop between rounds; the last completed round is
            # fenced into a checkpoint.
            self.stopped = True
            lp["done"] = True
            self._checkpoint_on_stop(round_idx - 1)
            return False
        if lp["snapshotting"] and (
            self._round_snapshot is None
            or self._round_snapshot["round_idx"] != round_idx
        ):
            self._round_snapshot = self._capture_snapshot(round_idx)
        replaying = (round_idx <= self._force_checkpoint_until
                     or lp["retries"].get(round_idx, 0) > 0)
        try:
            faults.inject("runner.round_begin", context=str(round_idx),
                          round_idx=round_idx, task_id=self.task_id)
            self._maybe_poison(round_idx)
            self._maybe_attack(round_idx)
            status = self._execute_round(
                round_idx, lp["flow_epoch"] if replaying else 0
            )
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — policy dispatch
            instrument("ols_engine_rounds_total", self.registry).labels(
                task_id=self.task_id, status="failed"
            ).inc()
            self._abandon_live_flow()
            action, next_round, new_attempts = self._handle_round_failure(
                round_idx, lp["retries"].get(round_idx, 0), e
            )
            if action == "raise":
                self._persist_resilience()
                raise
            lp["retries"][round_idx] = new_attempts
            lp["round_idx"] = next_round
            lp["flow_epoch"] += 1
            return True
        lp["retries"].pop(round_idx, None)
        # A stop at the start barrier executed nothing and counts as no
        # round; a stop at the stop barrier follows a completed round.
        if status != "stop" or (
            self.history and self.history[-1].get("round") == round_idx
        ):
            instrument("ols_engine_rounds_total", self.registry).labels(
                task_id=self.task_id, status="ok"
            ).inc()
        if self._quarantine is not None:
            self._qsnapshots[round_idx] = self._quarantine.snapshot()
            # Retention covers the deepest rollback: a preemption can fall
            # back across every retained checkpoint step (max_to_keep steps
            # spaced checkpoint_every rounds apart), and _rollback then needs
            # the quarantine state as of the resume round's entry.
            keep = max(
                8,
                getattr(self.checkpointer, "max_to_keep", 0)
                * max(1, self.checkpoint_every) + 2,
            ) if self.checkpointer is not None else 8
            for k in [k for k in self._qsnapshots if k < round_idx - keep]:
                del self._qsnapshots[k]
        if status == "stop":
            self.stopped = True
            lp["done"] = True
            done_round = round_idx if (
                self.history and self.history[-1].get("round") == round_idx
            ) else round_idx - 1
            self._checkpoint_on_stop(done_round)
            return False
        if status == "final":
            lp["done"] = True
            return False
        lp["round_idx"] = round_idx + 1
        if lp["round_idx"] >= self.rounds:
            lp["done"] = True
            return False
        return True

    def finish(self) -> List[Dict[str, Any]]:
        """Close out a run: block on the checkpoint commit in flight, persist
        the resilience digest, remove the operators' scratch directories,
        and return the history."""
        if self.checkpointer is not None:
            # The last step's write runs on the commit thread; a process exit
            # right after run() must not lose it.
            self.checkpointer.wait()
        self._persist_resilience()
        self._loop = None
        remove_scratch(self.operators)
        return self.history

    def pending_device_rounds(self) -> int:
        """Device-rounds this task still has to commit (remaining rounds x
        total real population)."""
        nxt = self._loop["round_idx"] if self._loop is not None else 0
        remaining = max(0, self.rounds - nxt)
        return remaining * sum(
            p.dataset.num_real_clients for p in self.populations
        )

    def run(self) -> List[Dict[str, Any]]:
        try:
            self.begin()
            while self.step():
                pass
            return self.finish()
        finally:
            remove_scratch(self.operators)


class MultiTaskDispatcher:
    """Several tasks' rounds multiplexed in one process, on one device.

    A port of the JAX package's dispatcher over the runner's
    ``begin()``/``step()``/``finish()``:

    - ``interleave="step"`` (default): cooperative round-robin, one round
      of one task per turn. With ``fair_share=True`` the task with the most
      pending device-rounds goes next (ties by list order), so a big task
      cannot be starved by small ones; otherwise strict rotation. Each
      task's results are bitwise its solo run's: task states are
      independent, and the order of turns enters no task's math.
    - ``interleave="thread"``: each task runs its whole loop on its own
      thread, so one task's host phases may overlap another's device work.
      Runners may share a core: a round passes its parameters through
      ``functional_call`` into the module skeleton of its own thread
      (``FedCore._module``), so no thread sees another's weights.

    Leases: with a ``task_repo`` (the port's or the JAX package's
    ``TaskTableRepo``, used duck-typed), the dispatcher claims each task's
    lease at start, renews it as a heartbeat (every turn in step mode; a
    daemon thread in thread mode), releases it on finish, and fences a
    task whose renewal fails: another process (a supervisor that saw the
    lease expire) owns it now, so the local run stops and cedes the row. A
    fenced task's checkpointed rounds stay durable; the reclaimer resumes
    from them. A task whose ``begin``, ``step`` or ``finish`` raises is
    isolated: the other tasks run to their end, its lease is left to expire
    for the supervisor, and the first error is raised after. The lease
    backend is the repo's: in memory, or a file or server that several
    processes share (``TaskTableRepo(sqlite_path=...)`` or a backend of
    ``utils.repo.SqliteTableRepo`` / ``MySqlTableRepo``), where the claim
    and renewal are one conditional UPDATE, so a supervisor in another
    process sees the leases and reclaims an expired one.
    """

    def __init__(self, runners: List[SimulationRunner], *,
                 task_repo: Optional[TaskTableRepo] = None,
                 owner_id: Optional[str] = None,
                 lease_ttl_s: float = 30.0,
                 fair_share: bool = True,
                 interleave: str = "step",
                 logger: Optional[Logger] = None):
        if interleave not in ("step", "thread"):
            raise ValueError(
                f"interleave must be 'step' or 'thread', got {interleave!r}"
            )
        ids = [r.task_id for r in runners]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate task ids in dispatcher: {ids}")
        self.runners = list(runners)
        self.task_repo = task_repo
        self.owner_id = owner_id or f"dispatcher-{os.getpid()}"
        self.lease_ttl_s = float(lease_ttl_s)
        self.fair_share = bool(fair_share)
        self.interleave = interleave
        self.logger = logger if logger is not None else Logger()
        # Task ids dropped mid-run because another process took their
        # lease (inspect after run(); their histories are not returned:
        # the new owner's are the ones of record).
        self.fenced: List[str] = []

    # ------------------------------------------------------------- leases
    def _claim(self, runner: SimulationRunner) -> bool:
        if self.task_repo is None:
            return True
        if not self.task_repo.has_task(runner.task_id):
            self.task_repo.add_task(runner.task_id)
        return self.task_repo.claim_lease(runner.task_id, self.owner_id, self.lease_ttl_s)

    def _renew(self, runner: SimulationRunner) -> bool:
        if self.task_repo is None:
            return True
        return self.task_repo.renew_lease(runner.task_id, self.owner_id, self.lease_ttl_s)

    def _release(self, runner: SimulationRunner) -> None:
        if self.task_repo is not None:
            self.task_repo.release_lease(runner.task_id, self.owner_id)

    @staticmethod
    def _retire(runner: SimulationRunner) -> None:
        """Retire a finished task's metric series from its registry: a
        dispatcher serving a stream of tasks in one long-lived process would
        otherwise keep one labelled series per finished task. Fenced and
        failed tasks keep theirs: their reclaimer owns them."""
        from olearning_sim_tpu_torch.telemetry import default_registry

        # getattr: stub runners carry no registry.
        reg = getattr(runner, "registry", None)
        reg = reg if reg is not None else default_registry()
        reg.retire_label_value("task_id", runner.task_id)

    def _fence(self, runner: SimulationRunner) -> None:
        """Another process owns the task now: stop locally and cede the row
        (no release: the lease belongs to the new owner)."""
        self.fenced.append(runner.task_id)
        self.logger.warning(
            task_id=runner.task_id, system_name="engine",
            module_name="dispatcher",
            message="lease renewal failed; fencing task (another process "
                    "reclaimed it)",
        )

    def _report(self, errors: Dict[str, BaseException]) -> None:
        """Log every task's failure and raise the first."""
        if not errors:
            return
        for tid, e in errors.items():
            self.logger.error(
                task_id=tid, system_name="engine", module_name="dispatcher",
                message=f"task failed under dispatch: {type(e).__name__}: {e}",
            )
        raise next(iter(errors.values()))

    # ---------------------------------------------------------------- run
    def run(self) -> Dict[str, List[Dict[str, Any]]]:
        """Drive every task to completion; returns task_id -> history for
        the tasks this process finished (fenced tasks excluded)."""
        if self.interleave == "thread":
            return self._run_threaded()
        return self._run_cooperative()

    def _pick(self, active: List[SimulationRunner], rotation: int) -> SimulationRunner:
        if not self.fair_share:
            return active[rotation % len(active)]
        # Deficit fairness: the most pending device-rounds goes next; ties
        # break by list order.
        return max(active, key=lambda r: r.pending_device_rounds())

    def _run_cooperative(self) -> Dict[str, List[Dict[str, Any]]]:
        active: List[SimulationRunner] = []
        results: Dict[str, List[Dict[str, Any]]] = {}
        errors: Dict[str, BaseException] = {}
        for r in self.runners:
            if not self._claim(r):
                self._fence(r)
                continue
            try:
                r.begin()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — reported below
                # A task that cannot start must not abandon its co-tasks;
                # its lease is left to expire for the supervisor.
                errors[r.task_id] = e
                continue
            active.append(r)
        rotation = 0
        while active:
            # Renew every active task's lease each turn, not just the
            # picked one's: one slow step of task A must not let task B's
            # lease expire mid-run.
            for other in list(active):
                if not self._renew(other):
                    active.remove(other)
                    self._fence(other)
            if not active:
                break
            r = self._pick(active, rotation)
            rotation += 1
            try:
                more = r.step()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — reported below
                # The task failed under its failure policy; the others run
                # on, and its lease is left to expire for the supervisor.
                active.remove(r)
                errors[r.task_id] = e
                continue
            if not more:
                active.remove(r)
                try:
                    results[r.task_id] = r.finish()
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors[r.task_id] = e
                    continue
                self._release(r)
                self._retire(r)
        self._report(errors)
        return results

    def _run_threaded(self) -> Dict[str, List[Dict[str, Any]]]:
        results: Dict[str, List[Dict[str, Any]]] = {}
        errors: Dict[str, BaseException] = {}
        started: List[SimulationRunner] = []
        for r in self.runners:
            if not self._claim(r):
                self._fence(r)
                continue
            if r.stop_event is None:
                # Fencing needs a handle to stop a running loop.
                r.stop_event = threading.Event()
            started.append(r)

        fenced_ids: set = set()

        def worker(r: SimulationRunner) -> None:
            try:
                results[r.task_id] = r.run()
            except BaseException as e:  # noqa: BLE001 — reported below
                errors[r.task_id] = e

        threads = [threading.Thread(target=worker, args=(r,), name=f"dispatch-{r.task_id}",
                                    daemon=True) for r in started]
        stop_heart = threading.Event()

        def heartbeat() -> None:
            # Renew every ttl/3; a failed renewal stops that task's loop at
            # its next round boundary.
            while not stop_heart.wait(max(0.05, self.lease_ttl_s / 3.0)):
                for r in started:
                    if r.task_id in fenced_ids or r.task_id in results:
                        continue
                    if not self._renew(r):
                        fenced_ids.add(r.task_id)
                        self._fence(r)
                        r.stop_event.set()

        heart = None
        if self.task_repo is not None:
            heart = threading.Thread(target=heartbeat, name="dispatch-heartbeat", daemon=True)
            heart.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop_heart.set()
        if heart is not None:
            heart.join()
        for r in started:
            if r.task_id in fenced_ids:
                # A fenced task's history is not ours to report.
                results.pop(r.task_id, None)
            elif r.task_id in results:
                self._release(r)
                self._retire(r)
        self._report(errors)
        return results
