"""Deterministic, seed-driven fault injection.

A :class:`FaultPlan` is a list of :class:`FaultSpec` entries plus a seed; the
:class:`FaultInjector` evaluates them at named *injection points* scattered
through the stack (``storage.upload``, ``outbound.send``,
``deviceflow.notify_start``, ``checkpoint.save``, ``checkpoint.corrupt``,
``runner.round_begin``, ``runner.pre_checkpoint``, ...). Every decision —
which hit of a point fires, which probabilistic coin lands — derives from the
plan seed via :class:`ChaosClock`, so a chaos run replays bit-identically
from (plan, seed) alone. That determinism is what lets the acceptance test
compare a faulted run against a fault-free run of the surviving population
bitwise.

Injection is consulted through a process-global active injector
(:func:`install` / :func:`chaos` context manager) so instrumented call sites
cost one ``None`` check when chaos is off and need no plumbing when it is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from olearning_sim_tpu_torch.resilience.events import (
    FAULT_INJECTED,
    ResilienceLog,
    global_log,
)


class FaultError(IOError):
    """An injected transient fault (I/O flavored: retryable by default)."""


class HostPreemption(RuntimeError):
    """Simulated host preemption mid-round. Deliberately NOT retryable at
    call-site level — it must bubble to the runner, which models it as a
    process death and recovers via checkpoint rollback."""


@dataclasses.dataclass
class FaultSpec:
    """One planned fault.

    ``point``   — injection point name (exact match).
    ``times``   — how many hits fire (after filters); -1 = unlimited.
    ``after``   — skip the first ``after`` matching hits (fire on hit
                  ``after``, 0-indexed, and the ``times - 1`` following ones).
    ``probability`` — per-hit coin (seeded; 1.0 = always).
    ``match``   — substring the call-site context (e.g. file name, flow id)
                  must contain; "" matches everything.
    ``rounds``  — restrict to these round indices (when the call site passes
                  one); None = any round.
    ``error``   — what firing does: ``"io"`` raise :class:`FaultError`,
                  ``"preempt"`` raise :class:`HostPreemption`, ``"false"`` /
                  ``"corrupt"`` / ``"nan"`` return the spec for the call site
                  to act on (bool-contract APIs return False; the
                  checkpointer corrupts its newest step file; the runner
                  poisons the ``payload["clients"]`` updates to NaN).
    ``payload`` — free-form extra data for call-site-handled faults (e.g.
                  ``{"clients": [3, 7]}`` for ``runner.poison_clients``).
    """

    point: str
    times: int = 1
    after: int = 0
    probability: float = 1.0
    match: str = ""
    rounds: Optional[Sequence[int]] = None
    error: str = "io"
    payload: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rounds"] = list(self.rounds) if self.rounds is not None else None
        return d


@dataclasses.dataclass
class FaultPlan:
    """Seeded set of fault specs (the unit a chaos test is described by)."""

    specs: List[FaultSpec] = dataclasses.field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "FaultPlan":
        specs = [
            FaultSpec(**{**s, "rounds": s.get("rounds")})
            for s in obj.get("specs", obj.get("faults", []))
        ]
        return cls(specs=specs, seed=int(obj.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}
        )


class ChaosClock:
    """Deterministic decision source: per-spec hit counters + a seeded RNG
    stream per spec (so adding a spec never perturbs another spec's coins)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._hits: Dict[int, int] = {}
        self._fired: Dict[int, int] = {}
        self._rngs: Dict[int, np.random.Generator] = {}

    def hit(self, spec_idx: int) -> int:
        n = self._hits.get(spec_idx, 0)
        self._hits[spec_idx] = n + 1
        return n

    def fired(self, spec_idx: int) -> int:
        return self._fired.get(spec_idx, 0)

    def mark_fired(self, spec_idx: int) -> None:
        self._fired[spec_idx] = self._fired.get(spec_idx, 0) + 1

    def coin(self, spec_idx: int, probability: float) -> bool:
        if probability >= 1.0:
            return True
        rng = self._rngs.get(spec_idx)
        if rng is None:
            rng = np.random.default_rng([self.seed, spec_idx])
            self._rngs[spec_idx] = rng
        return bool(rng.random() < probability)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at injection points. Thread-safe."""

    def __init__(self, plan: FaultPlan, log: Optional[ResilienceLog] = None):
        self.plan = plan
        self.log = log if log is not None else global_log()
        self.clock = ChaosClock(plan.seed)
        self._lock = threading.Lock()

    def fire(self, point: str, context: str = "",
             round_idx: Optional[int] = None,
             task_id: str = "") -> Optional[FaultSpec]:
        """Return the spec that fires at this hit of ``point`` (and record
        the event), or None. At most one spec fires per hit."""
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if spec.point != point:
                    continue
                if spec.match and spec.match not in context:
                    continue
                if spec.rounds is not None and round_idx is not None \
                        and round_idx not in spec.rounds:
                    continue
                hit = self.clock.hit(i)
                if hit < spec.after:
                    continue
                if spec.times >= 0 and self.clock.fired(i) >= spec.times:
                    continue
                if not self.clock.coin(i, spec.probability):
                    continue
                self.clock.mark_fired(i)
                self.log.record(
                    FAULT_INJECTED, point=point, task_id=task_id,
                    round_idx=round_idx, context=context, error=spec.error,
                    hit=hit,
                )
                return spec
            return None

    def check(self, point: str, context: str = "",
              round_idx: Optional[int] = None, task_id: str = "") -> None:
        """Fire-and-raise form for exception-contract call sites."""
        spec = self.fire(point, context=context, round_idx=round_idx,
                         task_id=task_id)
        if spec is None:
            return
        raise exception_for(spec, point, context)


def exception_for(spec: FaultSpec, point: str, context: str) -> Exception:
    """The exception a fired spec maps to (public: wrappers that act on a
    returned spec — e.g. bool-contract repos — use this for the raise
    flavors)."""
    if spec.error == "preempt":
        return HostPreemption(
            f"injected preemption at {point} ({context or 'no context'})"
        )
    return FaultError(
        f"injected fault at {point} ({context or 'no context'})"
    )


# ------------------------------------------------------- global installation
_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_LOCK = threading.Lock()


def install(injector: Optional[FaultInjector]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = injector


def active_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def fire(point: str, context: str = "", round_idx: Optional[int] = None,
         task_id: str = "") -> Optional[FaultSpec]:
    """Module-level fire: None when no chaos plan is installed (the hot-path
    cost of having injection points compiled in)."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.fire(point, context=context, round_idx=round_idx,
                    task_id=task_id)


def inject(point: str, context: str = "", round_idx: Optional[int] = None,
           task_id: str = "") -> None:
    """Module-level fire-and-raise (exception-contract call sites)."""
    inj = _ACTIVE
    if inj is None:
        return
    inj.check(point, context=context, round_idx=round_idx, task_id=task_id)


@contextlib.contextmanager
def chaos(plan: FaultPlan, log: Optional[ResilienceLog] = None):
    """``with chaos(plan): ...`` — install a fault plan for the block."""
    injector = FaultInjector(plan, log=log)
    prev = _ACTIVE
    install(injector)
    try:
        yield injector
    finally:
        install(prev)
