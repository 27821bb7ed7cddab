"""Dispatcher: staged shelf messages -> outbound, on a behavior schedule.

Reference: ``ols_core/deviceflow/non_grpc/dispatcher.py:27-252`` — two modes:

- **real_time** (``:84-171``): forward messages as they arrive, batched by a
  cycling ``dispatch_batch_sizes`` list, dropping each message independently
  with ``drop_probability``;
- **flow** (``:174-242``): execute a pre-computed ``(timing, amount,
  drop_list)`` schedule (from the strategy module), sleeping between slots;
  after release, leftovers are drained to outbound (``:244-252``).

Wall-clock sleeps go through an injectable clock so simulations can run the
schedule in virtual time (the reference always burns real seconds; running
faster-than-real-time here is a deliberate capability).

A copy of the JAX package's ``deviceflow/dispatcher.py``, over the
port's ``deviceflow/strategy.py``: one seeded generator gives the JAX
package's drop lists exactly.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np

from olearning_sim_tpu_torch.deviceflow.rooms import ShelfRoom
from olearning_sim_tpu_torch.deviceflow.strategy import (
    DispatchSchedule,
    RealTimePlan,
    analyze_flow_strategy,
    analyze_real_time_strategy,
    is_real_time_dispatch,
)

Producer = Callable[[List[Any]], None]  # delivers a batch to the outbound service


class Clock:
    """Real or virtual time source."""

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def now(self) -> float:
        return time.monotonic()


class VirtualClock(Clock):
    """Advances instantly; records the simulated timeline. Thread-safe (one
    clock may be shared by several dispatch threads)."""

    def __init__(self):
        self._t = 0.0
        self._lock = threading.Lock()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            with self._lock:
                self._t += seconds

    def now(self) -> float:
        with self._lock:
            return self._t


class Dispatcher:
    def __init__(
        self,
        flow_id: str,
        strategy: str,
        shelf_room: ShelfRoom,
        producer: Producer,
        clock: Optional[Clock] = None,
        rng: Optional[np.random.Generator] = None,
        poll_interval: float = 0.05,
    ):
        self.flow_id = flow_id
        self.strategy = strategy
        self.shelf_room = shelf_room
        self.producer = producer
        self.clock = clock if clock is not None else Clock()
        self.rng = rng if rng is not None else np.random.default_rng()
        self.poll_interval = poll_interval
        self._release = threading.Event()  # all NotifyComplete received
        self.sent = 0
        self.dropped = 0

    def release_dispatch(self) -> None:
        """Signal that the flow is complete; dispatch drains and finishes
        (reference ``release_dispatch`` flag, ``dispatcher.py:47-58``)."""
        self._release.set()

    def _count_drop(self, n: int) -> None:
        if n:
            from olearning_sim_tpu_torch.telemetry import instrument

            instrument("ols_deviceflow_dropped_messages_total").inc(n)
            self.dropped += n

    def _poll_wait(self) -> None:
        """Wait for messages to arrive: real time, NOT the schedule clock —
        under a VirtualClock a virtual-time poll would busy-spin the CPU and
        inflate the simulated timeline. Waking on release avoids a stall."""
        self._release.wait(timeout=self.poll_interval)

    @property
    def released(self) -> bool:
        return self._release.is_set()

    # ------------------------------------------------------------------ run
    def dispatch(self) -> None:
        if is_real_time_dispatch(self.strategy):
            self._dispatch_real_time(analyze_real_time_strategy(self.strategy))
        else:
            sched = analyze_flow_strategy(self.strategy, self.flow_id, rng=self.rng)
            self._dispatch_flow(sched)
        # A flow is only finished once every compute resource has called
        # NotifyComplete (release) AND leftovers are drained — even if the
        # schedule itself ran out earlier (reference deviceflow_server.py:453-473).
        self._release.wait()
        self._drain_remaining()

    def _send(self, batch: List[Any]) -> None:
        if batch:
            from olearning_sim_tpu_torch.telemetry import instrument

            t0 = time.perf_counter()
            self.producer(batch)
            instrument(
                "ols_deviceflow_dispatch_batch_duration_seconds"
            ).observe(time.perf_counter() - t0)
            instrument("ols_deviceflow_dispatched_messages_total").inc(
                len(batch)
            )
            self.sent += len(batch)

    def _dispatch_real_time(self, plan: RealTimePlan) -> None:
        """Batch-as-they-arrive with per-message drops
        (reference ``dispatcher.py:84-171``)."""
        batch_sizes = plan.batch_sizes or [1]
        k = 0
        pending: List[Any] = []
        while True:
            target = max(1, int(batch_sizes[k % len(batch_sizes)]))
            got = self.shelf_room.take_from_shelf(self.flow_id, target - len(pending))
            for payload in got:
                if plan.drop_probability > 0 and self.rng.random() < plan.drop_probability:
                    self._count_drop(1)
                else:
                    pending.append(payload)
            if len(pending) >= target:
                self._send(pending[:target])
                pending = pending[target:]
                k += 1
                continue
            if self.released and self.shelf_room.shelf_size(self.flow_id) == 0:
                self._send(pending)
                return
            if not got:
                self._poll_wait()

    def _dispatch_flow(self, sched: DispatchSchedule) -> None:
        """Execute the (timing, amount, drop_list) schedule
        (reference ``dispatcher.py:174-242``)."""
        for wait, amount, drops in zip(sched.timings, sched.amounts, sched.drop_lists):
            self.clock.sleep(wait)
            amount = int(amount)
            collected: List[Any] = []
            while len(collected) < amount:
                got = self.shelf_room.take_from_shelf(
                    self.flow_id, amount - len(collected)
                )
                collected.extend(got)
                if len(collected) >= amount:
                    break
                if self.released and self.shelf_room.shelf_size(self.flow_id) == 0:
                    break
                if not got:
                    self._poll_wait()
            drop_set = set(drops)
            batch = [p for i, p in enumerate(collected) if i not in drop_set]
            self._count_drop(len(collected) - len(batch))
            self._send(batch)
            if self.released and self.shelf_room.shelf_size(self.flow_id) == 0:
                # No more messages can arrive (sorter rejects post-complete);
                # remaining slots would only busy-wait.
                break

    def _drain_remaining(self) -> None:
        """Forward leftovers after release (reference ``dispatcher.py:244-252``)."""
        while True:
            got = self.shelf_room.take_from_shelf(self.flow_id, 1024)
            if not got:
                return
            self._send(got)
