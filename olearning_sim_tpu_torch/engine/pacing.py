"""Deadline-aware round pacing: completion-time model, over-selection,
quorum policies, and the adaptive deadline controller.

A copy of the JAX package's ``engine/pacing.py`` (numpy only; the code
is verbatim), so the same seeds give the same cohorts, completion times
and deadlines in both packages, bit for bit.

The deviceflow trace compiler already produces a per-client *network*
``arrival_time`` (when a client's update is released), but the engine
historically ignored it: a round's cohort was fixed at selection time and
every selected client always "finished". Real device–cloud systems survive
heterogeneity with deadlines, over-selection, and partial aggregation
(Apodotiko, arxiv 2404.14033; deadline-constrained assignment,
arxiv 2010.00239). This module makes simulated time a first-class
robustness axis:

- **Completion-time model** — ``completion_times`` combines simulated
  compute latency (device-class speed profile × local-step count, plus an
  optional seeded jitter) with the trace's network ``arrival_time`` into a
  ``completion_time[C]`` array. All host-side numpy, seeded by
  ``(seed, round)`` so replayed rounds reproduce their straggler set.
- **Over-selection** — ``select_cohort`` picks ``ceil(K·(1+α))`` clients
  from the round's eligible participants so the round can close with K
  completions despite stragglers.
- **Round close** — ``effective_deadline`` closes the round at the earlier
  of (the controller's deadline, the K-th simulated arrival).
- **Quorum** — when on-time completions fall below
  ``quorum_fraction × K`` the runner raises :class:`DeadlineMissError`,
  which routes through the resilience ``FailurePolicy`` machinery
  (retry / skip_round / fail_task) as a ``deadline_miss`` event instead of
  silently aggregating a starved cohort.
- **Adaptive pacing** — :class:`DeadlineController` EMA-tracks the
  ``target_completion_fraction`` percentile of observed completion times
  and re-derives the next round's deadline from it, so pacing self-tunes
  across rounds. Controller state rides the runner's per-round history
  records (and therefore the round checkpoint), so rollback/replay repaces
  deterministically.

The *aggregation* consequence of the deadline — zero weight for
``completion_time > deadline`` — is enforced inside the compiled round
program (``fedcore`` masks with where-selects; no host round-trip);
this module only plans the round on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Seed salts: decorrelate pacing RNG streams from the trace compiler's
# (which uses [seed, round]) and from each other.
_JITTER_SALT = 0x7ACE
_COHORT_SALT = 0xC0507


class DeadlineMissError(RuntimeError):
    """A round closed below its quorum of on-time completions.

    Raised by the runner *before* the round step launches (state untouched)
    and dispatched through the resilience failure policy like any other
    round failure — retry replays the round, skip_round degrades
    gracefully, fail_task surfaces it.
    """


@dataclasses.dataclass(frozen=True)
class DeadlineConfig:
    """Knobs for deadline-aware rounds (engine params ``deadline``).

    ``deadline_s`` — static round deadline in *simulated* seconds (None
    with ``adaptive=False`` disables deadline masking entirely — the
    deadline-off path is bitwise identical to a build without this
    subsystem). ``speed_profiles`` maps device-class name → simulated
    seconds per local SGD step; unlisted classes use ``default_step_s``.
    ``jitter`` adds a seeded per-client multiplicative compute jitter in
    ``[1, 1+jitter]``. ``target_cohort`` (K) + ``over_selection`` (α)
    enable over-selection: ``ceil(K·(1+α))`` clients are selected and the
    round closes at the earlier of (deadline, K-th simulated arrival).
    ``quorum_fraction`` of K (of the selected count when K is unset) must
    complete on time or the round is a :class:`DeadlineMissError`.
    ``adaptive`` enables the EMA percentile controller (below); when it has
    no observation yet the deadline falls back to ``deadline_s`` (or no
    deadline at all when that is unset — a self-tuning warm-up round).
    """

    deadline_s: Optional[float] = None
    over_selection: float = 0.0
    target_cohort: Optional[int] = None
    quorum_fraction: float = 0.0
    speed_profiles: Dict[str, float] = dataclasses.field(default_factory=dict)
    default_step_s: float = 0.1
    jitter: float = 0.0
    adaptive: bool = False
    target_completion_fraction: float = 0.9
    ema_beta: float = 0.3          # weight of the newest observation
    margin: float = 1.1            # headroom over the tracked percentile
    min_deadline_s: float = 1e-3
    max_deadline_s: float = float("inf")

    def __post_init__(self):
        if not 0.0 <= self.quorum_fraction <= 1.0:
            raise ValueError(
                f"quorum_fraction must be in [0, 1], got {self.quorum_fraction}"
            )
        if self.over_selection < 0.0:
            raise ValueError(
                f"over_selection must be >= 0, got {self.over_selection}"
            )
        if self.target_cohort is not None and self.target_cohort < 1:
            raise ValueError(
                f"target_cohort must be >= 1, got {self.target_cohort}"
            )
        if not 0.0 < self.target_completion_fraction <= 1.0:
            raise ValueError(
                "target_completion_fraction must be in (0, 1], got "
                f"{self.target_completion_fraction}"
            )
        if not 0.0 < self.ema_beta <= 1.0:
            raise ValueError(f"ema_beta must be in (0, 1], got {self.ema_beta}")
        for fld in ("default_step_s", "jitter", "margin", "min_deadline_s"):
            if getattr(self, fld) < 0:
                raise ValueError(f"{fld} must be >= 0")
        if self.max_deadline_s < self.min_deadline_s:
            # np.clip with min > max silently answers max — a negative or
            # inverted cap would turn every round into 100% stragglers.
            raise ValueError(
                f"max_deadline_s ({self.max_deadline_s}) must be >= "
                f"min_deadline_s ({self.min_deadline_s})"
            )

    @property
    def enabled(self) -> bool:
        return (self.deadline_s is not None or self.adaptive
                or self.target_cohort is not None)

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "DeadlineConfig":
        """Engine-params JSON shape::

            {"deadline_s": 30.0, "over_selection": 0.3, "target_cohort": 80,
             "quorum_fraction": 0.5, "adaptive": true,
             "target_completion_fraction": 0.9,
             "speed_profiles": {"high": 0.05, "low": 0.4},
             "default_step_s": 0.1, "jitter": 0.1}
        """
        if not isinstance(obj, dict):
            raise TypeError(
                f"deadline config must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            # A typo (quorum_fracton) must fail at submit time, not
            # silently run with the knob disabled.
            raise ValueError(
                f"unknown deadline config keys: {unknown} "
                f"(known: {sorted(known)})"
            )
        kw: Dict[str, Any] = {}
        for k in ("deadline_s", "over_selection", "quorum_fraction",
                  "default_step_s", "jitter", "target_completion_fraction",
                  "ema_beta", "margin", "min_deadline_s", "max_deadline_s"):
            if k in obj and obj[k] is not None:
                kw[k] = float(obj[k])
        if "target_cohort" in obj and obj["target_cohort"] is not None:
            kw["target_cohort"] = int(obj["target_cohort"])
        if "adaptive" in obj:
            kw["adaptive"] = bool(obj["adaptive"])
        if "speed_profiles" in obj:
            kw["speed_profiles"] = {
                str(k): float(v) for k, v in obj["speed_profiles"].items()
            }
        return cls(**kw)


def completion_times(
    arrival_time: np.ndarray,
    num_steps: np.ndarray,
    class_of_client: np.ndarray,
    device_classes: Sequence[str],
    cfg: DeadlineConfig,
    seed: int,
    round_idx: int,
    stream: int = 0,
) -> np.ndarray:
    """[C] float32 simulated completion times (inf for never-released).

    ``arrival_time`` is the trace compiler's network release time; compute
    latency is ``steps × seconds-per-step(device class)`` with an optional
    seeded per-client jitter. ``stream`` decorrelates the jitter draws
    across (operator, population) pairs sharing a round — without it every
    same-sized population would get byte-identical jitter. Deterministic
    for a given ``(cfg, seed, round_idx, stream)`` — the property rollback
    replay relies on.
    """
    arrival = np.asarray(arrival_time, np.float32)
    steps = np.asarray(num_steps, np.float32)
    step_s = np.array(
        [cfg.speed_profiles.get(name, cfg.default_step_s)
         for name in device_classes],
        np.float32,
    )
    if len(step_s) == 0:
        compute = steps * np.float32(cfg.default_step_s)
    else:
        cls = np.clip(np.asarray(class_of_client, np.int64), 0,
                      len(step_s) - 1)
        compute = steps * step_s[cls]
    if cfg.jitter > 0.0:
        rng = np.random.default_rng(
            [int(seed), int(round_idx), int(stream), _JITTER_SALT]
        )
        compute = compute * (
            1.0 + cfg.jitter * rng.random(len(compute))
        ).astype(np.float32)
    return (arrival + compute).astype(np.float32)


def select_cohort(
    eligible: np.ndarray,
    cfg: DeadlineConfig,
    seed: int,
    round_idx: int,
    stream: int = 0,
) -> np.ndarray:
    """Over-selection: a boolean mask of ``ceil(K·(1+α))`` clients drawn
    (seeded, uniformly) from the eligible participants; ``stream``
    decorrelates draws across (operator, population) pairs. With no
    ``target_cohort`` every eligible client is selected."""
    eligible = np.asarray(eligible, bool)
    if cfg.target_cohort is None:
        return eligible.copy()
    n_sel = int(math.ceil(cfg.target_cohort * (1.0 + cfg.over_selection)))
    idx = np.flatnonzero(eligible)
    if len(idx) <= n_sel:
        return eligible.copy()
    rng = np.random.default_rng(
        [int(seed), int(round_idx), int(stream), _COHORT_SALT]
    )
    chosen = rng.choice(idx, size=n_sel, replace=False)
    out = np.zeros_like(eligible)
    out[chosen] = True
    return out


def arrival_ranks(
    completion: np.ndarray,
    selected: np.ndarray,
) -> np.ndarray:
    """[C] int32 dense arrival ranks over the selected cohort: 0 for the
    earliest simulated completion, 1 for the next, ...; -1 for
    non-selected clients. Ties break by client index (stable argsort), so
    the order — and everything built on it, e.g. the async engine's
    commit-window assignment — is deterministic and replays exactly under
    rollback/resume. Non-finite completions sort last (they still get a
    rank: whether they commit is the caller's staleness/deadline policy).
    """
    completion = np.asarray(completion, np.float32)
    selected = np.asarray(selected, bool)
    ranks = np.full(len(completion), -1, np.int32)
    idx = np.flatnonzero(selected)
    if len(idx):
        order = idx[np.argsort(completion[idx], kind="stable")]
        ranks[order] = np.arange(len(order), dtype=np.int32)
    return ranks


def effective_deadline(
    completion: np.ndarray,
    selected: np.ndarray,
    cfg: DeadlineConfig,
    controller_deadline: float,
) -> float:
    """The round's close time: the earlier of the controller deadline and
    the K-th smallest completion among selected clients (when K is set and
    at least K were selected)."""
    deadline = float(controller_deadline)
    if cfg.target_cohort is not None:
        sel = np.sort(np.asarray(completion, np.float32)[np.asarray(selected, bool)])
        if len(sel) >= cfg.target_cohort:
            kth = float(sel[cfg.target_cohort - 1])
            if np.isfinite(kth):
                deadline = min(deadline, kth)
    return deadline


@dataclasses.dataclass
class RoundPacing:
    """One round's host-side pacing plan for one population."""

    selected: np.ndarray       # [real] bool — the over-selected cohort
    completion: np.ndarray     # [real] float32 — inf for non-selected
    deadline_s: float          # effective round close time
    n_selected: int
    n_on_time: int
    quorum_required: int

    @property
    def n_stragglers(self) -> int:
        return self.n_selected - self.n_on_time

    @property
    def quorum_met(self) -> bool:
        return self.n_on_time >= self.quorum_required

    def round_close_s(self) -> float:
        """Simulated time the round actually closed: the last on-time
        completion (0 when nothing completed)."""
        on_time = self.completion[self.selected
                                  & (self.completion <= self.deadline_s)]
        return float(on_time.max()) if on_time.size else 0.0


class DeadlineController:
    """EMA percentile tracker → next round's deadline.

    After each successful train round the controller observes the selected
    cohort's completion times and updates
    ``ema ← (1-β)·ema + β·percentile(target_completion_fraction)``; the
    next deadline is ``clamp(ema × margin, min, max)``. With
    ``adaptive=False`` it is a constant-deadline pass-through, so the
    runner has exactly one pacing seam either way.

    State is one float (plus the config); :meth:`state_dict` /
    :meth:`load_state` serialize it into the runner's history records,
    which ride both the in-memory round snapshot and the round checkpoint —
    a rolled-back or resumed run therefore repaces bit-identically.
    """

    def __init__(self, cfg: DeadlineConfig):
        self.cfg = cfg
        self.ema: Optional[float] = None

    def current_deadline(self) -> float:
        if self.cfg.adaptive and self.ema is not None:
            return float(np.clip(self.ema * self.cfg.margin,
                                 self.cfg.min_deadline_s,
                                 self.cfg.max_deadline_s))
        if self.cfg.deadline_s is not None:
            return float(self.cfg.deadline_s)
        return float("inf")

    def observe(self, completion: np.ndarray) -> None:
        if not self.cfg.adaptive:
            return
        finite = np.asarray(completion, np.float32)
        finite = finite[np.isfinite(finite)]
        if finite.size == 0:
            return
        p = float(np.quantile(finite, self.cfg.target_completion_fraction))
        beta = self.cfg.ema_beta
        self.ema = p if self.ema is None else (1.0 - beta) * self.ema + beta * p

    def state_dict(self) -> Dict[str, Any]:
        return {"ema": self.ema}

    def load_state(self, state: Dict[str, Any]) -> None:
        ema = state.get("ema")
        self.ema = None if ema is None else float(ema)

    def reset(self) -> None:
        self.ema = None

    def load_from_history(self, history: List[Dict[str, Any]]) -> None:
        """Rehydrate from the newest history record carrying pacing state
        (rollback/resume hook — see the runner's ``_repace``)."""
        for rec in reversed(history):
            st = rec.get("pacing")
            if st is not None:
                self.load_state(st)
                return
        self.reset()
