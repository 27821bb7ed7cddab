"""Scenario traces: day-scale per-client availability models compiled to
per-round mask/weight/arrival arrays.

A copy of the JAX package's ``engine/scenario.py`` (numpy only): the same
(config, seed, population, round) gives the same trace in both packages.
A :class:`ScenarioConfig` describes how a device fleet behaves over
simulated days — diurnal online/offline cycles by device class, charging
windows, flash-crowd spikes, permanent device churn (leave/join), and
non-IID label drift — and a :class:`ScenarioModel` compiles it, per
round, into plain ``[C]`` numpy arrays that enter the round as data:

- ``participate`` multiplies the aggregation weight (exactly like the
  deviceflow trace compiler's masks — offline/churned clients are inert);
- ``arrival_time`` feeds the pacing/deadline completion-time model;
- ``label_shift`` rotates a client's labels (labels are already a data
  input to the round).

Every scenario knob — spike timing, churn rates, drift schedule — changes
only array values, never the round's structure.

Determinism contract (what the numpy oracle tests pin): a trace is a pure
function of ``(config, seed, num_clients, round_idx)``. Static per-client
draws (diurnal phase, charging-window start, churn lifetimes, drift
stagger) come from ``default_rng([seed, _STATIC_SALT])`` in the fixed
order phase-jitter, charge-start, leave, join-membership, join-round,
drift-stagger; per-round draws (online Bernoulli, arrival offsets) come
from ``default_rng([seed, _ROUND_SALT, round_idx])`` in the order
online, arrival. Rollback / checkpoint resume / supervisor relaunch
therefore replay the exact participation sets with no persisted scenario
state — the round index IS the scenario cursor.

The availability model, precisely:

- hour of (simulated) day ``h = (round_idx * round_seconds mod
  day_seconds) / day_seconds * 24``;
- per-client online probability ``p = clip(online_base + online_amp *
  cos(2*pi * (h - peak_hour - phase_c) / 24), 0, 1)`` where ``phase_c`` is
  the client's device-class phase shift plus seeded jitter;
- flash-crowd spikes multiply ``p`` by ``boost`` (clipped at 1) for the
  covered rounds;
- a client with ``charging_required`` is additionally available only while
  ``(h - charge_start_c) mod 24 < charging_hours``;
- churn: the client exists only for ``join_round_c <= round_idx <
  leave_round_c`` (geometric lifetimes — permanent leave/join, not
  round-scoped dropout);
- drift: the client's labels are rotated by ``(round_idx +
  drift_stagger_c) // drift_period_rounds`` classes (staggered so the
  population drifts continuously rather than in lockstep).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from olearning_sim_tpu_torch.deviceflow.trace_compiler import ClientTrace

_STATIC_SALT = 0x5CE9A10
_ROUND_SALT = 0x5CE9A11


@dataclasses.dataclass(frozen=True)
class SpikeSpec:
    """One flash-crowd spike: availability multiplied by ``boost`` for
    ``rounds`` rounds starting at ``round`` (inclusive)."""

    round: int
    rounds: int = 1
    boost: float = 3.0

    def __post_init__(self):
        if self.round < 0 or self.rounds < 1:
            raise ValueError(
                f"spike needs round >= 0 and rounds >= 1, got "
                f"round={self.round} rounds={self.rounds}"
            )
        if self.boost < 0.0:
            raise ValueError(f"spike boost must be >= 0, got {self.boost}")

    def covers(self, round_idx: int) -> bool:
        return self.round <= round_idx < self.round + self.rounds

    @classmethod
    def from_dict(cls, obj: dict) -> "SpikeSpec":
        if not isinstance(obj, dict):
            raise TypeError(
                f"scenario spike must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(
                f"unknown scenario spike keys: {unknown} "
                f"(known: {sorted(known)})"
            )
        kw = {}
        if obj.get("round") is None:
            raise ValueError("scenario spike needs a start 'round'")
        kw["round"] = int(obj["round"])
        if obj.get("rounds") is not None:
            kw["rounds"] = int(obj["rounds"])
        if obj.get("boost") is not None:
            kw["boost"] = float(obj["boost"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """The validated ``{"scenario": {...}}`` engine-params block.

    All knobs default to "inert": the default config describes an
    always-online fleet with no churn, no drift, and no streaming — a
    scenario-free run's masks are all-ones. ``stream_block_rows`` opts the
    population into block-streamed round execution
    (:meth:`~olearning_sim_tpu_torch.engine.fedcore.FedCore.stream_round` —
    O(block) HBM regardless of population size); ``None`` keeps the
    resident single-program path.
    """

    round_seconds: float = 600.0
    day_seconds: float = 86400.0
    online_base: float = 1.0
    online_amp: float = 0.0
    peak_hour: float = 20.0
    # Device-class name -> diurnal phase shift in hours (e.g. tablets
    # peak later than phones). Unlisted classes shift 0.
    class_phase_hours: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    phase_jitter_hours: float = 0.0
    charging_required: bool = False
    charging_hours: float = 8.0
    spikes: Tuple[SpikeSpec, ...] = ()
    leave_rate: float = 0.0
    join_frac: float = 0.0
    join_rate: float = 0.1
    drift_period_rounds: Optional[int] = None
    stream_block_rows: Optional[int] = None

    def __post_init__(self):
        for fld in ("round_seconds", "day_seconds"):
            if getattr(self, fld) <= 0:
                raise ValueError(
                    f"scenario.{fld} must be > 0, got {getattr(self, fld)}"
                )
        for fld in ("online_amp", "phase_jitter_hours", "charging_hours"):
            if getattr(self, fld) < 0:
                raise ValueError(
                    f"scenario.{fld} must be >= 0, got {getattr(self, fld)}"
                )
        if not 0.0 <= self.online_base <= 1.0:
            raise ValueError(
                f"scenario.online_base must be in [0, 1], got "
                f"{self.online_base}"
            )
        if not 0.0 <= self.leave_rate < 1.0:
            raise ValueError(
                f"scenario.leave_rate must be in [0, 1), got "
                f"{self.leave_rate}"
            )
        if not 0.0 <= self.join_frac <= 1.0:
            raise ValueError(
                f"scenario.join_frac must be in [0, 1], got "
                f"{self.join_frac}"
            )
        if not 0.0 < self.join_rate <= 1.0:
            raise ValueError(
                f"scenario.join_rate must be in (0, 1], got "
                f"{self.join_rate}"
            )
        if (self.drift_period_rounds is not None
                and self.drift_period_rounds < 1):
            raise ValueError(
                f"scenario.drift_period_rounds must be >= 1, got "
                f"{self.drift_period_rounds}"
            )
        if (self.stream_block_rows is not None
                and self.stream_block_rows < 1):
            raise ValueError(
                f"scenario.stream_block_rows must be >= 1, got "
                f"{self.stream_block_rows}"
            )

    @property
    def streamed(self) -> bool:
        return self.stream_block_rows is not None

    @classmethod
    def from_dict(cls, obj: dict) -> "ScenarioConfig":
        """``{"scenario": {"online_base": 0.4, "online_amp": 0.3,
        "spikes": [{"round": 3, "rounds": 2, "boost": 3.0}],
        "leave_rate": 0.001, "stream_block_rows": 2048}}``. Unknown keys
        are rejected so a typo (``online_bias``) fails at submit time,
        not by silently simulating an always-on fleet."""
        if not isinstance(obj, dict):
            raise TypeError(
                f"scenario config must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(
                f"unknown scenario config keys: {unknown} "
                f"(known: {sorted(known)})"
            )
        kw: dict = {}
        for k in ("round_seconds", "day_seconds", "online_base",
                  "online_amp", "peak_hour", "phase_jitter_hours",
                  "charging_hours", "leave_rate", "join_frac", "join_rate"):
            if obj.get(k) is not None:
                kw[k] = float(obj[k])
        if obj.get("charging_required") is not None:
            kw["charging_required"] = bool(obj["charging_required"])
        if obj.get("class_phase_hours") is not None:
            cp = obj["class_phase_hours"]
            if not isinstance(cp, dict):
                raise TypeError(
                    "scenario.class_phase_hours must be an object mapping "
                    "device-class name -> hours"
                )
            kw["class_phase_hours"] = {str(k): float(v)
                                       for k, v in cp.items()}
        if obj.get("spikes") is not None:
            kw["spikes"] = tuple(
                SpikeSpec.from_dict(s) for s in obj["spikes"]
            )
        for k in ("drift_period_rounds", "stream_block_rows"):
            if obj.get(k) is not None:
                kw[k] = int(obj[k])
        return cls(**kw)


@dataclasses.dataclass
class ScenarioTrace:
    """One round's compiled scenario arrays (all host numpy, length C)."""

    participate: np.ndarray        # [C] float32 0/1
    arrival_time: np.ndarray       # [C] float32, inf when unavailable
    alive: np.ndarray              # [C] bool — inside the churn lifetime
    online: np.ndarray             # [C] bool — diurnal/spike draw
    charging_ok: np.ndarray        # [C] bool
    label_shift: Optional[np.ndarray] = None  # [C] int32 (None = no drift)

    @property
    def num_available(self) -> int:
        return int(self.participate.sum())

    def as_client_trace(self) -> ClientTrace:
        """The scenario availability in the deviceflow trace shape, so it
        composes with dispatch-strategy traces via ``combine_traces``."""
        return ClientTrace(
            participate=self.participate,
            arrival_time=self.arrival_time,
            dropped=np.zeros(self.participate.shape[0], bool),
        )

    def counts(self) -> Dict[str, int]:
        """Round-record digest (history -> checkpoint meta)."""
        c = self.participate.shape[0]
        return {
            "available": self.num_available,
            "alive": int(self.alive.sum()),
            "churned": int(c - self.alive.sum()),
            "offline": int((self.alive & ~self.online).sum()),
            "drifted": (int((self.label_shift != 0).sum())
                        if self.label_shift is not None else 0),
        }


class ScenarioModel:
    """A scenario config realized over one concrete population.

    Static per-client draws happen once at construction (vectorized
    numpy); :meth:`round_trace` is then an O(C) pure function of the
    round index — cheap enough to run every round at million-client
    scale (a handful of vectorized passes, no Python loops).
    """

    def __init__(
        self,
        config: ScenarioConfig,
        num_clients: int,
        seed: int = 0,
        class_of_client: Optional[np.ndarray] = None,
        device_classes: Optional[Sequence[str]] = None,
        num_classes: Optional[int] = None,
    ):
        self.config = config
        self.num_clients = int(num_clients)
        self.seed = int(seed)
        self.num_classes = num_classes
        c = self.num_clients
        rng = np.random.default_rng([self.seed, _STATIC_SALT])
        # Fixed draw order — the determinism contract the oracle tests pin.
        jitter = rng.uniform(-1.0, 1.0, size=c) * config.phase_jitter_hours
        self.charge_start = rng.uniform(0.0, 24.0, size=c)
        u_leave = rng.random(c)
        u_member = rng.random(c)
        u_join = rng.random(c)
        self.drift_stagger = (
            rng.integers(0, config.drift_period_rounds, size=c)
            if config.drift_period_rounds is not None
            else np.zeros(c, np.int64)
        )

        phase = jitter
        if class_of_client is not None and device_classes is not None \
                and config.class_phase_hours:
            shift = np.array(
                [config.class_phase_hours.get(name, 0.0)
                 for name in device_classes],
                np.float64,
            )
            cls = np.asarray(class_of_client[:c], np.int64)
            phase = phase + shift[np.clip(cls, 0, len(shift) - 1)]
        self.phase = phase

        # Geometric lifetimes: leave after the round where the cumulative
        # survival drops below the client's uniform draw. inf = never.
        if config.leave_rate > 0.0:
            self.leave_round = np.floor(
                np.log(np.maximum(u_leave, 1e-300))
                / np.log1p(-config.leave_rate)
            ) + 1.0
        else:
            self.leave_round = np.full(c, np.inf)
        joiner = u_member < config.join_frac
        join_round = np.zeros(c)
        if config.join_frac > 0.0:
            join_round[joiner] = np.floor(
                np.log(np.maximum(u_join[joiner], 1e-300))
                / np.log1p(-config.join_rate)
            ) + 1.0
        self.join_round = join_round

    def _hour(self, round_idx: int) -> float:
        cfg = self.config
        t = (round_idx * cfg.round_seconds) % cfg.day_seconds
        return t / cfg.day_seconds * 24.0

    def online_probability(self, round_idx: int) -> np.ndarray:
        """[C] diurnal availability probability incl. spike boosts."""
        cfg = self.config
        h = self._hour(round_idx)
        p = cfg.online_base + cfg.online_amp * np.cos(
            2.0 * np.pi * (h - cfg.peak_hour - self.phase) / 24.0
        )
        for spike in cfg.spikes:
            if spike.covers(round_idx):
                p = p * spike.boost
        return np.clip(p, 0.0, 1.0)

    def round_trace(self, round_idx: int) -> ScenarioTrace:
        cfg = self.config
        c = self.num_clients
        r = int(round_idx)
        rng = np.random.default_rng([self.seed, _ROUND_SALT, r])
        online_u = rng.random(c)
        arrival_u = rng.random(c)

        online = online_u < self.online_probability(r)
        alive = (self.join_round <= r) & (r < self.leave_round)
        if cfg.charging_required:
            h = self._hour(r)
            charging_ok = ((h - self.charge_start) % 24.0) < cfg.charging_hours
        else:
            charging_ok = np.ones(c, bool)
        participate = alive & online & charging_ok
        arrival = np.where(
            participate, arrival_u * cfg.round_seconds, np.inf
        ).astype(np.float32)

        label_shift = None
        if cfg.drift_period_rounds is not None:
            shift = (r + self.drift_stagger) // cfg.drift_period_rounds
            if self.num_classes:
                shift = shift % self.num_classes
            label_shift = shift.astype(np.int32)
        return ScenarioTrace(
            participate=participate.astype(np.float32),
            arrival_time=arrival,
            alive=alive,
            online=online,
            charging_ok=np.asarray(charging_ok, bool),
            label_shift=label_shift,
        )
