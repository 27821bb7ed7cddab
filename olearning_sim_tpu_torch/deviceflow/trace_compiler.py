"""Trace compiler: dispatch schedules -> per-client mask arrays.

The device half of deviceflow. In the reference, device behavior is
enacted at message-transport time: the Dispatcher releases staged Pulsar
messages per the schedule and drops some (``dispatcher.py:84-242``). Here the
same behavior enters the round as data: a schedule becomes per-client arrays
that the round engine consumes as masks/weights. A copy of the JAX package's
``deviceflow/trace_compiler.py``: the same (strategy, round, seed) gives the
same masks in both packages.

For a population of C clients in round r, ``compile_trace`` yields:

- ``participate`` [C] float32 — 1.0 if the client's update is released this
  round (it was scheduled and not dropped), else 0.0. Multiplied into the
  aggregation weight, making churn/drops exactly inert (see
  ``tests/test_fedcore.py::test_masked_clients_are_inert``).
- ``arrival_time`` [C] float32 — simulated release time (seconds from round
  start) of each client's update; inf for never-released. Feeds staleness /
  delay models and round-duration metrics.
- ``dropped`` [C] bool — scheduled but dropped (distinguishes "offline" from
  "sent and lost", which the reference tracks as drop curves).

Slot-to-client assignment is deterministic: clients are assigned to dispatch
slots in a seeded permutation of uid order, so results are reproducible for a
given (strategy, round, seed) regardless of mesh shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from olearning_sim_tpu_torch.deviceflow.strategy import (
    DispatchSchedule,
    analyze_flow_strategy,
    analyze_real_time_strategy,
    is_real_time_dispatch,
)


@dataclasses.dataclass
class ClientTrace:
    participate: np.ndarray  # [C] float32
    arrival_time: np.ndarray  # [C] float32, np.inf when never released
    dropped: np.ndarray  # [C] bool

    @property
    def num_released(self) -> int:
        return int(self.participate.sum())

    @property
    def num_dropped(self) -> int:
        return int(self.dropped.sum())

    def round_duration(self) -> float:
        """Simulated seconds until the last released update arrives."""
        released = self.arrival_time[np.isfinite(self.arrival_time)]
        return float(released.max()) if released.size else 0.0


def combine_traces(a: ClientTrace, b: ClientTrace) -> ClientTrace:
    """Intersection of two behavior traces over the same population.

    Used when a dispatch-strategy trace (network release schedule) and a
    scenario availability trace (``engine/scenario.py`` — diurnal /
    charging / churn masks) both apply to one round: a client
    participates only if BOTH release it, its update arrives at the
    LATER of the two times (it must be both dispatched and available),
    and it counts as dropped if either side dropped it. Combining with
    an all-on trace (``_all_on``) is an exact identity.
    """
    if a.participate.shape != b.participate.shape:
        raise ValueError(
            f"cannot combine traces over different populations: "
            f"{a.participate.shape[0]} vs {b.participate.shape[0]} clients"
        )
    participate = a.participate * b.participate
    arrival = np.where(
        participate > 0,
        np.maximum(a.arrival_time, b.arrival_time),
        np.float32(np.inf),
    ).astype(np.float32)
    return ClientTrace(
        participate=participate.astype(np.float32),
        arrival_time=arrival,
        dropped=a.dropped | b.dropped,
    )


def _all_on(num_clients: int) -> "ClientTrace":
    return ClientTrace(
        participate=np.ones(num_clients, np.float32),
        arrival_time=np.zeros(num_clients, np.float32),
        dropped=np.zeros(num_clients, bool),
    )


def compile_trace(
    strategy: Optional[str | Dict[str, Any]],
    num_clients: int,
    round_idx: int,
    task_id: str = "task",
    operator: str = "op",
    seed: int = 0,
    now=None,
) -> ClientTrace:
    """Compile one round's behavior strategy into per-client masks.

    ``strategy=None`` (controller disabled, reference
    ``OperationBehaviorController.useController=false``) means every client
    participates immediately.
    """
    if strategy is None:
        return _all_on(num_clients)

    rng = np.random.default_rng([seed, round_idx])
    if is_real_time_dispatch(strategy):
        # Real-time mode: every client sends as it finishes; each message is
        # independently dropped with drop_probability
        # (reference ``dispatcher.py:84-171``).
        plan = analyze_real_time_strategy(strategy)
        dropped = rng.random(num_clients) < plan.drop_probability
        return ClientTrace(
            participate=(~dropped).astype(np.float32),
            arrival_time=np.where(dropped, np.inf, 0.0).astype(np.float32),
            dropped=dropped,
        )

    flow_id = f"{task_id}_{operator}_{round_idx}"
    sched = analyze_flow_strategy(strategy, flow_id, rng=rng, now=now)
    return schedule_to_trace(sched, num_clients, rng)


def schedule_to_trace(
    sched: DispatchSchedule,
    num_clients: int,
    rng: np.random.Generator,
) -> ClientTrace:
    """Materialize a dispatch schedule over a concrete client population.

    Messages in the schedule map to clients via a seeded permutation; if the
    schedule releases fewer messages than there are clients, the rest are
    offline this round (never released). If it releases more, the surplus is
    ignored (the reference drains leftovers the same way,
    ``dispatcher.py:244-252``).
    """
    participate = np.zeros(num_clients, np.float32)
    arrival = np.full(num_clients, np.inf, np.float32)
    dropped = np.zeros(num_clients, bool)
    if sched.empty:
        return ClientTrace(participate, arrival, dropped)

    order = rng.permutation(num_clients)
    times = sched.absolute_times()
    pos = 0
    for slot, (t, amount, drops) in enumerate(
        zip(times, sched.amounts, sched.drop_lists)
    ):
        drops = set(drops)
        for i in range(int(amount)):
            if pos >= num_clients:
                return ClientTrace(participate, arrival, dropped)
            c = order[pos]
            pos += 1
            if i in drops:
                dropped[c] = True
            else:
                participate[c] = 1.0
                arrival[c] = t
    return ClientTrace(participate, arrival, dropped)
