"""Client quarantine: bench clients that produce non-finite updates.

The engine already refuses to aggregate a non-finite client contribution
(``fedcore`` gates each client's delta on finiteness), so a diverged client
cannot poison the global model — but it still *burns compute* every round it
participates and it pollutes the success/failed accounting with repeat
offenders. The quarantine manager tracks per-client health across rounds:

- a client observed non-finite while participating accrues a strike; at
  ``quarantine_after`` consecutive bad rounds it is quarantined (excluded
  from the participation mask entirely — zero weight, zero local steps);
- after ``readmit_after`` quarantined rounds it is re-admitted on probation
  (half-open, circuit-breaker style); a clean round clears its strikes, a
  bad one re-quarantines it immediately.

Exclusion happens through the same masked-participation mechanism the
deviceflow trace compiler uses, so a quarantined client is indistinguishable
(to the compiled program) from a churned-out device — and it shows up as
``failed`` in the per-class success/failed accounting, which is exactly how
the reference reports dead phones.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from olearning_sim_tpu_torch.resilience.events import (
    CLIENT_QUARANTINED,
    CLIENT_READMITTED,
    QUARANTINE,
    READMIT,
    ResilienceLog,
    global_log,
)


def parse_quarantine_params(obj: Any) -> Dict[str, Dict[str, List[int]]]:
    """Validate the engine-params ``quarantine`` block.

    Shape: ``{"preseed": {"<population>": [client ids...]}}`` — operators
    blocklist known-bad device ids at submit time; the runner preseeds its
    :class:`QuarantineManager` with them. Raises ``ValueError`` /
    ``TypeError`` with a message naming the offending key, so submit-time
    validation surfaces a clear diagnostic instead of a server error.
    """
    if not isinstance(obj, dict):
        raise TypeError(
            f"quarantine config must be a JSON object, got "
            f"{type(obj).__name__}"
        )
    unknown = sorted(set(obj) - {"preseed"})
    if unknown:
        raise ValueError(
            f"unknown quarantine config keys: {unknown} (known: ['preseed'])"
        )
    preseed = obj.get("preseed", {})
    if not isinstance(preseed, dict):
        raise TypeError(
            "quarantine.preseed must map population name -> list of client "
            f"ids, got {type(preseed).__name__}"
        )
    out: Dict[str, List[int]] = {}
    for pop, ids in preseed.items():
        if not isinstance(pop, str) or not pop:
            raise ValueError(
                f"quarantine.preseed population names must be non-empty "
                f"strings, got {pop!r}"
            )
        if not isinstance(ids, (list, tuple)):
            raise TypeError(
                f"quarantine.preseed[{pop!r}] must be a list of client ids, "
                f"got {type(ids).__name__}"
            )
        cleaned: List[int] = []
        for c in ids:
            if isinstance(c, bool) or not isinstance(c, int) or c < 0:
                raise ValueError(
                    f"quarantine.preseed[{pop!r}] ids must be ints >= 0, "
                    f"got {c!r}"
                )
            cleaned.append(int(c))
        out[pop] = cleaned
    return {"preseed": out}


class _PopulationState:
    def __init__(self, num_clients: int):
        self.strikes = np.zeros(num_clients, np.int32)
        # Remaining quarantined rounds; 0 = active.
        self.remaining = np.zeros(num_clients, np.int32)
        self.total_quarantines = np.zeros(num_clients, np.int32)


class QuarantineManager:
    def __init__(
        self,
        quarantine_after: int = 1,
        readmit_after: int = 3,
        log: Optional[ResilienceLog] = None,
        task_id: str = "",
    ):
        self.quarantine_after = max(1, int(quarantine_after))
        self.readmit_after = max(1, int(readmit_after))
        self.log = log if log is not None else global_log()
        self.task_id = task_id
        self._lock = threading.Lock()
        self._pops: Dict[str, _PopulationState] = {}

    def _pop(self, name: str, num_clients: int) -> _PopulationState:
        st = self._pops.get(name)
        if st is None or len(st.strikes) < num_clients:
            st = _PopulationState(num_clients)
            self._pops[name] = st
        return st

    # ------------------------------------------------------------- queries
    def active_mask(self, name: str, num_clients: int) -> np.ndarray:
        """[num_clients] float mask: 1 for admitted clients, 0 quarantined.
        Multiplies the trace participation mask in the runner."""
        with self._lock:
            st = self._pop(name, num_clients)
            return (st.remaining[:num_clients] == 0).astype(np.float32)

    def quarantined(self, name: str) -> List[int]:
        with self._lock:
            st = self._pops.get(name)
            if st is None:
                return []
            return [int(i) for i in np.nonzero(st.remaining > 0)[0]]

    def num_quarantined(self) -> int:
        with self._lock:
            return sum(int((st.remaining > 0).sum())
                       for st in self._pops.values())

    # ------------------------------------------------------------ seeding
    def preseed(self, name: str, clients: Iterable[int],
                num_clients: int, rounds: Optional[int] = None) -> None:
        """Quarantine ``clients`` up-front (operator blocklists of known-bad
        device ids via engine params ``quarantine.preseed``; also the
        baseline construction for chaos parity tests). ``rounds`` None =
        effectively forever. Recorded as a ``client_quarantined`` state
        transition so blocklisting is visible in the resilience log."""
        clients = [int(c) for c in clients]
        with self._lock:
            st = self._pop(name, num_clients)
            dur = np.iinfo(np.int32).max if rounds is None else int(rounds)
            for c in clients:
                st.remaining[c] = dur
        if clients:
            self.log.record(
                CLIENT_QUARANTINED, point="runner.quarantine",
                task_id=self.task_id, population=name,
                clients=clients[:64], num_clients=len(clients),
                reason="preseed",
            )

    # ---------------------------------------------------------- snapshotting
    def snapshot(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Copy of the full per-population state — taken by the runner after
        each good round so a rollback restores quarantine decisions bitwise
        (a replayed round must see exactly the masks the original saw)."""
        with self._lock:
            return {
                name: {
                    "strikes": st.strikes.copy(),
                    "remaining": st.remaining.copy(),
                    "total_quarantines": st.total_quarantines.copy(),
                }
                for name, st in self._pops.items()
            }

    def restore(self, snap: Dict[str, Dict[str, np.ndarray]]) -> None:
        with self._lock:
            self._pops.clear()
            for name, arrays in snap.items():
                st = _PopulationState(len(arrays["strikes"]))
                st.strikes = arrays["strikes"].copy()
                st.remaining = arrays["remaining"].copy()
                st.total_quarantines = arrays["total_quarantines"].copy()
                self._pops[name] = st

    def state_json(self) -> Dict[str, Any]:
        """JSON-ready sparse encoding of the full state (only nonzero
        entries). Rides the runner's per-round history records — and
        therefore checkpoint meta — so a supervisor-relaunched task replays
        quarantine decisions bitwise (the in-memory ``snapshot``/``restore``
        pair only survives within one process)."""
        def sparse(a: np.ndarray) -> Dict[str, int]:
            # np.nonzero, not enumerate: this runs every round under the
            # manager lock, so cost must scale with the (usually zero)
            # nonzero entries, not the population size.
            return {str(int(i)): int(a[i]) for i in np.nonzero(a)[0]}

        with self._lock:
            return {
                name: {
                    "n": int(len(st.strikes)),
                    "strikes": sparse(st.strikes),
                    "remaining": sparse(st.remaining),
                    "total": sparse(st.total_quarantines),
                }
                for name, st in self._pops.items()
            }

    def load_json(self, obj: Dict[str, Any]) -> None:
        """Inverse of :meth:`state_json`."""
        with self._lock:
            self._pops.clear()
            for name, d in obj.items():
                st = _PopulationState(int(d["n"]))
                for field, arr in (("strikes", st.strikes),
                                   ("remaining", st.remaining),
                                   ("total", st.total_quarantines)):
                    for k, v in (d.get(field) or {}).items():
                        arr[int(k)] = int(v)
                self._pops[name] = st

    # ----------------------------------------------------------- observing
    def observe(self, name: str, round_idx: int, participated: np.ndarray,
                ok: np.ndarray,
                flagged: Optional[np.ndarray] = None) -> List[int]:
        """Digest one round's per-client outcome for population ``name``.

        ``participated`` — bool [C]: clients the round actually released
        (trace participation x quarantine mask). ``ok`` — bool [C]: finite
        update. ``flagged`` — optional bool [C]: anomaly-flagged by the
        defense feedback loop; a flagged client accrues a strike exactly
        like a non-finite one (and does not clear existing strikes even if
        finite). Returns the newly quarantined client indices. Also
        advances quarantine countdowns and re-admits clients whose term
        expired.
        """
        participated = np.asarray(participated, bool)
        ok = np.asarray(ok, bool)
        n = len(participated)
        if flagged is None:
            flagged = np.zeros(n, bool)
        else:
            flagged = np.asarray(flagged, bool)[:n]
            if len(flagged) < n:
                flagged = np.pad(flagged, (0, n - len(flagged)))
        newly: List[int] = []
        readmitted: List[int] = []
        via_anomaly = 0
        with self._lock:
            st = self._pop(name, n)
            strikes, remaining = st.strikes, st.remaining
            # Countdown for quarantined clients; term expiry = probation.
            serving = remaining[:n] > 0
            remaining[:n][serving] -= 1
            done = serving & (remaining[:n] == 0)
            if done.any():
                strikes[:n][done] = self.quarantine_after - 1  # one strike left
                readmitted = [int(i) for i in np.nonzero(done)[0]]
            bad = participated & (~ok | flagged)
            good = participated & ok & ~flagged
            strikes[:n][good] = 0
            strikes[:n][bad] += 1
            trip = bad & (strikes[:n] >= self.quarantine_after)
            if trip.any():
                remaining[:n][trip] = self.readmit_after
                st.total_quarantines[:n][trip] += 1
                strikes[:n][trip] = 0
                newly = [int(i) for i in np.nonzero(trip)[0]]
                via_anomaly = int((trip & flagged).sum())
        if newly:
            self.log.record(
                QUARANTINE, point="runner.quarantine", task_id=self.task_id,
                round_idx=round_idx, population=name,
                clients=newly[:64], num_clients=len(newly),
            )
            # Per-transition event with the reason split — the quarantine
            # feedback loop's declared state-change signal.
            self.log.record(
                CLIENT_QUARANTINED, point="runner.quarantine",
                task_id=self.task_id, round_idx=round_idx, population=name,
                clients=newly[:64], num_clients=len(newly),
                via_anomaly=via_anomaly,
            )
        if readmitted:
            self.log.record(
                READMIT, point="runner.quarantine", task_id=self.task_id,
                round_idx=round_idx, population=name,
                clients=readmitted[:64], num_clients=len(readmitted),
            )
            self.log.record(
                CLIENT_READMITTED, point="runner.quarantine",
                task_id=self.task_id, round_idx=round_idx, population=name,
                clients=readmitted[:64], num_clients=len(readmitted),
            )
        return newly
