"""Convergence observability: time-to-accuracy tracking for the round loop.

A port of the JAX package's ``engine/convergence.py``:

- :class:`ConvergenceConfig` — eval cadence, target accuracy, and
  fixed-round / fixed-simulated-second budgets (engine params
  ``{"convergence": ...}``);
- :class:`ConvergenceTracker` — the per-round quality series built from
  the runner's ``eval_loss``/``eval_acc`` values, with time-to-target
  accuracy and accuracy-at-budget in simulated AND wall time. Tracker
  state rides per-round history records, and so checkpoint meta, so a
  resumed run replays the identical record
  (``SimulationRunner._reconverge``);
- :func:`run_convergence_task` — the harness behind the convergence gate
  (``analysis/convergence_gate.py``): one (family x engine-config)
  convergence run end-to-end through the port's ``SimulationRunner``, on
  the card unless the caller asks for the CPU.

Determinism contract: everything in the tracker's record is a pure
function of (config, seeds, round) EXCEPT the ``wall_*`` fields, which
are measured host wall-clock. Once committed to checkpoint meta they
rehydrate bitwise on resume (a resumed run never re-measures committed
rounds), but two independent runs never agree on them —
:func:`strip_wall` yields the deterministic sub-record the gate and the
bitwise tests compare.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# Record keys that carry measured host wall-clock (non-deterministic
# across independent runs; bitwise only across resume/rollback replays of
# committed rounds).
WALL_KEYS = ("wall_seconds_total", "wall_seconds_to_target",
             "accuracy_at_wall_budget")


def strip_wall(record: Dict[str, Any]) -> Dict[str, Any]:
    """The deterministic sub-record: everything except measured wall-clock
    fields (and each eval point's ``wall_s``)."""
    out = {k: v for k, v in record.items() if k not in WALL_KEYS}
    out["evals"] = [
        {k: v for k, v in e.items() if k != "wall_s"}
        for e in record.get("evals", [])
    ]
    return out


@dataclasses.dataclass(frozen=True)
class ConvergenceConfig:
    """Convergence-tracking knobs (engine params ``{"convergence": ...}``).

    ``eval_every`` — evaluate the global model every N train rounds (the
    final round always evaluates, so a cadence longer than the task still
    yields the final point). ``target_accuracy`` — the time-to-target
    threshold; None tracks the series without a target. The three budgets
    pick the "accuracy at fixed budget" points of the record: the last
    eval at/under ``round_budget`` rounds / ``sim_seconds_budget``
    simulated seconds / ``wall_seconds_budget`` wall seconds.
    """

    target_accuracy: Optional[float] = None
    eval_every: int = 1
    round_budget: Optional[int] = None
    sim_seconds_budget: Optional[float] = None
    wall_seconds_budget: Optional[float] = None
    enabled: bool = True

    def __post_init__(self):
        if self.eval_every < 1:
            raise ValueError(
                f"convergence.eval_every must be >= 1, got {self.eval_every}"
            )
        if self.target_accuracy is not None and not (
            0.0 < float(self.target_accuracy) <= 1.0
        ):
            raise ValueError(
                f"convergence.target_accuracy must be in (0, 1], got "
                f"{self.target_accuracy}"
            )
        for field in ("round_budget", "sim_seconds_budget",
                      "wall_seconds_budget"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"convergence.{field} must be > 0, got {v}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ConvergenceConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown convergence params {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        kwargs = dict(d)
        if "eval_every" in kwargs:
            kwargs["eval_every"] = int(kwargs["eval_every"])
        if "round_budget" in kwargs and kwargs["round_budget"] is not None:
            kwargs["round_budget"] = int(kwargs["round_budget"])
        for k in ("target_accuracy", "sim_seconds_budget",
                  "wall_seconds_budget"):
            if kwargs.get(k) is not None:
                kwargs[k] = float(kwargs[k])
        return cls(**kwargs)


class ConvergenceTracker:
    """Per-task quality series + time-to-target accounting.

    The runner calls :meth:`observe_round` once per completed train round
    (advancing the simulated and wall clocks) and :meth:`observe_eval`
    at the configured cadence. State serializes via :meth:`state_json`
    into the per-round history record — and therefore checkpoint meta —
    so rollback/resume rehydrates committed clocks and to-target facts
    instead of re-measuring them (``SimulationRunner._reconverge``).
    """

    def __init__(self, config: ConvergenceConfig):
        self.config = config
        self.reset()

    def reset(self) -> None:
        self.rounds_observed = 0
        self.sim_seconds_total = 0.0
        self.wall_seconds_total = 0.0
        self.evals: List[Dict[str, Any]] = []
        self.reached = False
        self.rounds_to_target: Optional[int] = None
        self.sim_seconds_to_target: Optional[float] = None
        self.wall_seconds_to_target: Optional[float] = None
        # Whether any observed round carried a simulated duration: configs
        # with no pacing model (no deadline/async/scenario clock) report
        # sim-time-to-target as None ("no simulated clock"), never a
        # meaningless 0.0 ("instantaneous").
        self._sim_clock_seen = False
        # Highest eval round already emitted into a history state record
        # (state_json emits increments, not the whole series — see below).
        self._state_high = -1

    # ------------------------------------------------------------ observe
    def should_eval(self, round_idx: int, total_rounds: int) -> bool:
        """Cadence gate: every ``eval_every``-th round plus the final
        round (so ``eval_every > total_rounds`` still yields the final
        point instead of an empty series)."""
        return ((round_idx + 1) % self.config.eval_every == 0
                or round_idx == total_rounds - 1)

    def observe_round(self, round_idx: int, sim_s: float,
                      wall_s: float) -> None:
        """Advance the clocks for one completed train round. ``sim_s`` is
        the round's simulated fleet duration (deterministic); ``wall_s``
        the measured host wall-clock (see module docstring)."""
        self.rounds_observed = round_idx + 1
        self.sim_seconds_total += float(sim_s)
        self.wall_seconds_total += float(wall_s)
        if sim_s > 0:
            self._sim_clock_seen = True

    def observe_eval(self, round_idx: int, eval_loss: Optional[float],
                     eval_acc: float) -> bool:
        """Record one eval point; returns True when this point is the one
        that first reached the target (the caller's cue to publish the
        time-to-target gauges)."""
        acc = float(eval_acc)
        self.evals.append({
            "round": int(round_idx),
            "acc": acc,
            "loss": None if eval_loss is None else float(eval_loss),
            "sim_s": self.sim_seconds_total,
            "wall_s": self.wall_seconds_total,
        })
        target = self.config.target_accuracy
        if not self.reached and target is not None and acc >= target:
            self.reached = True
            self.rounds_to_target = int(round_idx) + 1
            self.sim_seconds_to_target = (
                self.sim_seconds_total if self._sim_clock_seen else None
            )
            self.wall_seconds_to_target = self.wall_seconds_total
            return True
        return False

    # ------------------------------------------------------------- record
    def _at_budget(self, key: str, budget) -> Optional[float]:
        best = None
        for e in self.evals:
            if budget is None or e[key] <= budget:
                best = e["acc"]
        return best if budget is not None else None

    def record(self) -> Dict[str, Any]:
        """The convergence record of record (JSON-safe). ``wall_*`` keys
        are measured, everything else deterministic — see
        :func:`strip_wall`."""
        cfg = self.config
        last = self.evals[-1] if self.evals else None
        best = max((e["acc"] for e in self.evals), default=None)
        at_round = None
        if cfg.round_budget is not None:
            for e in self.evals:
                if e["round"] + 1 <= cfg.round_budget:
                    at_round = e["acc"]
        return {
            "target_accuracy": cfg.target_accuracy,
            "eval_every": cfg.eval_every,
            "reached": self.reached,
            "rounds_to_target": self.rounds_to_target,
            "sim_seconds_to_target": self.sim_seconds_to_target,
            "wall_seconds_to_target": self.wall_seconds_to_target,
            "rounds_observed": self.rounds_observed,
            "sim_seconds_total": self.sim_seconds_total,
            "wall_seconds_total": self.wall_seconds_total,
            "final_accuracy": None if last is None else last["acc"],
            "final_loss": None if last is None else last["loss"],
            "best_accuracy": best,
            "accuracy_at_round_budget": at_round,
            # Like sim_seconds_to_target: a config with no simulated
            # clock answers None — an all-zero sim series would otherwise
            # report the FINAL accuracy as "accuracy at N simulated
            # seconds" and beat every genuinely-paced row for free.
            "accuracy_at_sim_budget": (
                self._at_budget("sim_s", cfg.sim_seconds_budget)
                if self._sim_clock_seen else None
            ),
            "accuracy_at_wall_budget": self._at_budget(
                "wall_s", cfg.wall_seconds_budget
            ),
            "evals": [dict(e) for e in self.evals],
        }

    # -------------------------------------------------------------- state
    def state_json(self) -> Dict[str, Any]:
        """Serializable tracker state for the per-round history record
        (checkpoint meta). Scalars are cumulative, but the eval series is
        emitted INCREMENTALLY — only points newer than the last emitted
        record — so R rounds of history hold O(total evals), not
        O(rounds x evals) (the sibling async/pacing states are O(1);
        :meth:`load_history` folds the increments back together)."""
        new = [dict(e) for e in self.evals if e["round"] > self._state_high]
        if self.evals:
            self._state_high = max(self._state_high,
                                   self.evals[-1]["round"])
        return {
            "rounds_observed": self.rounds_observed,
            "sim_seconds_total": self.sim_seconds_total,
            "wall_seconds_total": self.wall_seconds_total,
            "sim_clock_seen": self._sim_clock_seen,
            "evals_new": new,
            "reached": self.reached,
            "rounds_to_target": self.rounds_to_target,
            "sim_seconds_to_target": self.sim_seconds_to_target,
            "wall_seconds_to_target": self.wall_seconds_to_target,
        }

    def load_history(self, states: List[Dict[str, Any]]) -> None:
        """Rebuild the tracker from the ordered ``convergence_state``
        records of a restored history: eval increments are folded
        (deduped by round — a rolled-back round's replay re-emits its
        points, last record wins) and the cumulative scalars come from
        the newest record. An empty list resets (rollback to round 0)."""
        self.reset()
        if not states:
            return
        by_round: Dict[int, Dict[str, Any]] = {}
        for st in states:
            for e in st.get("evals_new", ()):
                by_round[int(e["round"])] = dict(e)
        self.evals = [by_round[r] for r in sorted(by_round)]
        self._state_high = max(by_round) if by_round else -1
        last = states[-1]
        self.rounds_observed = int(last.get("rounds_observed", 0))
        self.sim_seconds_total = float(last.get("sim_seconds_total", 0.0))
        self.wall_seconds_total = float(last.get("wall_seconds_total", 0.0))
        self._sim_clock_seen = bool(last.get("sim_clock_seen", False))
        self.reached = bool(last.get("reached", False))
        rtt = last.get("rounds_to_target")
        self.rounds_to_target = None if rtt is None else int(rtt)
        for k in ("sim_seconds_to_target", "wall_seconds_to_target"):
            v = last.get(k)
            setattr(self, k, None if v is None else float(v))


# --------------------------------------------------------------- harness
def run_convergence_task(
    *,
    name: str,
    seed: int = 0,
    num_clients: int = 96,
    n_local: int = 8,
    input_shape=(16,),
    num_classes: int = 4,
    class_sep: float = 1.2,
    eval_n: int = 512,
    rounds: int = 12,
    batch: int = 4,
    local_steps: int = 2,
    block_clients: int = 16,
    hidden=(16,),
    local_lr: float = 0.1,
    convergence: Optional[Dict[str, Any]] = None,
    deadline: Optional[Dict[str, Any]] = None,
    async_config: Optional[Dict[str, Any]] = None,
    defense: Optional[Dict[str, Any]] = None,
    attack: Optional[Dict[str, Any]] = None,
    scenario: Optional[Dict[str, Any]] = None,
    streamed: bool = False,
    task_id: Optional[str] = None,
    registry=None,
    perf=None,
    device="cuda",
) -> Dict[str, Any]:
    """One (family x engine-config) convergence run end-to-end through a
    :class:`~olearning_sim_tpu_torch.engine.runner.SimulationRunner`, the
    JAX package's harness over the port: learnable synthetic blob
    population + held-out eval set (the same arrays for the same seed),
    fixed seeds, and the engine-config axes the quality question is about —
    ``deadline`` vs ``async_config`` pacing, ``attack`` (a
    ``runner.attack_clients`` payload run under a seeded FaultPlan) vs
    ``defense``, ``scenario`` label drift, resident vs ``streamed``
    execution. Returns the tracker's record plus run provenance.

    ``device`` — where the model, the population and the rounds run (CUDA
    by default; raises without a card unless the CPU is asked for). The
    rounds run over the default process group when one is initialised, as
    the bridge's do. Deterministic for fixed inputs on one device up to the
    ``wall_*`` fields (:func:`strip_wall`).
    """
    import numpy as np

    from olearning_sim_tpu_torch.device import resolve_device
    from olearning_sim_tpu_torch.engine.algorithms import fedavg
    from olearning_sim_tpu_torch.engine.client_data import (
        HostClientStore,
        make_central_eval_set,
        make_synthetic_dataset,
    )
    from olearning_sim_tpu_torch.engine.fedcore import FedCoreConfig, build_fedcore
    from olearning_sim_tpu_torch.engine.runner import (
        DataPopulation,
        OperatorSpec,
        SimulationRunner,
    )
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.resilience import (
        FaultPlan,
        FaultSpec,
        ResilienceLog,
        faults,
    )

    dev = resolve_device(device)
    input_shape = tuple(input_shape)
    plan = make_mesh_plan()
    cfg = FedCoreConfig(batch_size=batch, max_local_steps=local_steps,
                        block_clients=block_clients)
    core = build_fedcore(
        "mlp2", fedavg(local_lr), cfg,
        model_overrides={"hidden": list(hidden), "num_classes": num_classes},
        input_shape=input_shape, device=dev, plan=plan,
    )
    host_ds = make_synthetic_dataset(
        seed, num_clients, n_local, input_shape, num_classes,
        dirichlet_alpha=0.5, class_sep=class_sep,
    )
    eval_data = make_central_eval_set(
        seed, eval_n, input_shape, num_classes, class_sep=class_sep
    )

    conv_cfg = ConvergenceConfig.from_dict(dict(convergence or {}))
    deadline_cfg = None
    if deadline:
        from olearning_sim_tpu_torch.engine.pacing import DeadlineConfig

        deadline_cfg = DeadlineConfig.from_dict(dict(deadline))
    async_cfg = None
    if async_config:
        from olearning_sim_tpu_torch.engine.async_rounds import AsyncConfig

        async_cfg = AsyncConfig.from_dict(dict(async_config))
    defense_cfg = None
    if defense:
        from olearning_sim_tpu_torch.engine.defense import DefenseConfig

        defense_cfg = DefenseConfig.from_dict(dict(defense))
    scenario_cfg = None
    if scenario or streamed:
        from olearning_sim_tpu_torch.engine.scenario import ScenarioConfig

        scen = dict(scenario or {})
        if streamed and "stream_block_rows" not in scen:
            # >=2 blocks so the streamed path actually streams.
            scen["stream_block_rows"] = max(
                plan.dp * block_clients,
                host_ds.pad_for(plan.dp * block_clients).num_clients // 2,
            )
        scenario_cfg = ScenarioConfig.from_dict(scen)

    store = None
    if scenario_cfg is not None and scenario_cfg.streamed:
        # Never placed whole: the round streams device-sized blocks.
        store = HostClientStore.from_dataset(host_ds)
        dataset = host_ds
    else:
        dataset = host_ds.pad_for(plan.dp * block_clients).shard(plan).to(dev)
    pop = DataPopulation(
        name="data_0", dataset=dataset, device_classes=["c0"],
        class_of_client=np.zeros(dataset.padded_clients, int),
        nums=[num_clients], dynamic_nums=[0], eval_data=eval_data,
        num_classes=num_classes, store=store, device=dev,
    )
    # One fixed default task id for the whole grid: the server's initial
    # parameters are seeded from the task id, so rows sharing it start from
    # IDENTICAL initial params — the resident-vs-streamed pair is then a
    # bitwise sanity check and every other pair isolates its axis.
    runner = SimulationRunner(
        task_id=task_id or "conv-grid", core=core, populations=[pop],
        operators=[OperatorSpec(name="train")], rounds=rounds,
        trace_seed=seed, convergence=conv_cfg, deadline=deadline_cfg,
        async_config=async_cfg, defense=defense_cfg,
        scenario=scenario_cfg, registry=registry, perf=perf,
    )
    if attack:
        plan_f = FaultPlan(seed=seed, specs=[
            FaultSpec(point="runner.attack_clients", times=-1,
                      payload=dict(attack)),
        ])
        with faults.chaos(plan_f, log=ResilienceLog()):
            history = runner.run()
    else:
        history = runner.run()
    record = runner.convergence_record()
    committed = sum(
        rec.get("train", {}).get("data_0", {}).get("clients_trained", 0)
        for rec in history
    )
    record.update(
        family=name,
        clients=num_clients,
        rounds=rounds,
        device_rounds_committed=int(committed),
        # Accuracy-per-device-round: final accuracy amortized over every
        # committed device-round — the quality-per-compute currency the
        # sync-vs-async and defended-vs-undefended comparisons price in.
        accuracy_per_1k_device_rounds=(
            round(1000.0 * record["final_accuracy"] / committed, 6)
            if committed and record["final_accuracy"] is not None else None
        ),
    )
    return record
