"""Operator-flow round barriers.

Reference: ``ols_core/taskMgr/utils/operatorflow.py:21-352`` — each round of
the operator flow can be gated by a start condition and a stop condition,
used to synchronize the simulation with an external aggregation service:

- ``""`` (empty): no barrier, proceed immediately;
- ``waiting_for_global_aggregation``: poll an external *selection service*
  for its current round index; start when it answers, stop when its round
  advanced by exactly 1 (``operatorflow.py:135-237``);
- ``sample_and_aggregation`` / ``sample_dc_and_aggregation``: sample client
  submissions into a staging directory, then wait for an
  ``aggregation_finished.txt`` flag file (``operatorflow.py:240-352``; the
  reference hard-codes researcher paths — here the paths and the sampler are
  parameters).

A copy of the JAX package's ``taskmgr/operator_flow.py`` without the
WebSocket round provider (ROADMAP.md A16): ``selection_url`` raises.

All strategies share the (wait_interval, total_timeout) polling contract from
``StrategyCondition`` (``taskService.proto:62-66``). Strategies are a
registry so deployments can plug their own barriers.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from olearning_sim_tpu_torch.utils.clocks import Deadline
from olearning_sim_tpu_torch.utils.logging import Logger

# A strategy factory returns an object with:
#   start(ctx) -> (ok: bool, current_round: Optional[int])
#   stop(ctx, previous_round: int) -> (ok: bool, current_round: Optional[int])
_STRATEGIES: Dict[str, Callable[..., Any]] = {}


def register_flow_strategy(name: str, factory: Callable[..., Any]) -> None:
    _STRATEGIES[name] = factory


class ImmediateBarrier:
    """Empty strategy: no synchronization (reference ``operatorflow.py:49-50``)."""

    def start(self, ctx):
        return True, None

    def stop(self, ctx, previous_round):
        return True, None


class PollingRoundBarrier:
    """``waiting_for_global_aggregation``: an external service owns the round
    counter. ``round_provider()`` returns its current round index (or None on
    error); the reference polls a selection service over WebSocket
    (``operatorflow.py:139-237``)."""

    def __init__(self, round_provider: Callable[[], Optional[int]]):
        self.round_provider = round_provider

    def _poll(self, ctx, predicate):
        # Monotonic countdown: a wall-clock step (NTP correction) must
        # neither expire the barrier early nor stall it past its timeout.
        deadline = Deadline(float(ctx.get("total_timeout", 0)))
        wait_interval = max(float(ctx.get("wait_interval", 0)), 1e-3)
        stop_event = ctx.get("stop_event")
        while True:
            if stop_event is not None and stop_event.is_set():
                return False, None  # task stop requested: abandon the barrier
            current = self.round_provider()
            if current is not None and predicate(current):
                return True, current
            if deadline.expired():
                return False, None
            time.sleep(wait_interval)

    def start(self, ctx):
        return self._poll(ctx, lambda r: True)

    def stop(self, ctx, previous_round):
        # The service's round must advance by exactly 1 past ours
        # (reference ``operatorflow.py:94-107``).
        return self._poll(ctx, lambda r: r - previous_round == 1)


class FlagFileBarrier:
    """``sample_and_aggregation`` family: run an optional sampler at start,
    then stop when the aggregator writes a flag file
    (reference ``operatorflow.py:240-352``, paths parameterized)."""

    def __init__(
        self,
        flag_path: str,
        sampler: Optional[Callable[[Dict[str, Any]], bool]] = None,
        clear_flag: bool = True,
    ):
        self.flag_path = flag_path
        self.sampler = sampler
        self.clear_flag = clear_flag

    def start(self, ctx):
        if self.sampler is not None and not self.sampler(ctx):
            return False, None
        return True, None

    def stop(self, ctx, previous_round):
        # Monotonic countdown (same rationale as PollingRoundBarrier._poll).
        deadline = Deadline(float(ctx.get("total_timeout", 0)))
        wait_interval = max(float(ctx.get("wait_interval", 0)), 1e-3)
        stop_event = ctx.get("stop_event")
        while True:
            if stop_event is not None and stop_event.is_set():
                return False, None
            if os.path.exists(self.flag_path):
                if self.clear_flag:
                    try:
                        os.remove(self.flag_path)
                    except OSError:
                        pass
                return True, None
            if deadline.expired():
                return False, None
            time.sleep(wait_interval)


def _polling_barrier(round_provider=None, selection_url=None, **_):
    if selection_url:
        # The reference polls its selection service over WebSocket; that
        # transport needs the websocket-client package, which the port does
        # not depend on. Refused, never replaced by another barrier.
        raise ValueError(
            "operator_flow.selection_url: the websocket round provider is "
            "not ported yet (ROADMAP.md A16); pass a round_provider callable"
        )
    return PollingRoundBarrier(round_provider)


register_flow_strategy("", lambda **_: ImmediateBarrier())
register_flow_strategy("waiting_for_global_aggregation", _polling_barrier)
register_flow_strategy(
    "sample_and_aggregation",
    lambda flag_path="aggregation_finished.txt", sampler=None, **_: FlagFileBarrier(
        flag_path, sampler
    ),
)
register_flow_strategy(
    "sample_dc_and_aggregation",
    lambda flag_path="aggregation_finished.txt", sampler=None, **_: FlagFileBarrier(
        flag_path, sampler
    ),
)


class OperatorFlowController:
    """Round-loop barrier controller (reference ``OperatorFlow``,
    ``operatorflow.py:39-132``): tracks the external round counter across
    start/stop; unknown strategies fail loudly."""

    def __init__(
        self,
        task_id: str,
        rounds: int,
        start_params: Optional[Dict[str, Any]] = None,
        stop_params: Optional[Dict[str, Any]] = None,
        strategy_kwargs: Optional[Dict[str, Any]] = None,
        logger: Optional[Logger] = None,
        stop_event: Optional["threading.Event"] = None,
    ):
        self.task_id = task_id
        self.rounds = int(rounds)
        self.start_params = dict(start_params or {})
        self.stop_params = dict(stop_params or {})
        # Barrier polls consult this so TaskManager.stop_task is responsive
        # even while the loop is blocked on an external aggregation service.
        if stop_event is not None:
            self.start_params.setdefault("stop_event", stop_event)
            self.stop_params.setdefault("stop_event", stop_event)
        self.strategy_kwargs = dict(strategy_kwargs or {})
        self.logger = logger if logger is not None else Logger()
        self.current_round = 0

    def _barrier(self, name: str):
        if name not in _STRATEGIES:
            self.logger.error(
                task_id=self.task_id, system_name="Engine", module_name="OperatorFlow",
                message=f"unknown operator-flow strategy {name!r}",
            )
            return None
        return _STRATEGIES[name](**self.strategy_kwargs)

    def start(self) -> bool:
        name = self.start_params.get("strategy", "")
        barrier = self._barrier(name)
        if barrier is None:
            return False
        ok, current = barrier.start(self.start_params)
        if ok and current is not None:
            self.current_round = current
        return bool(ok)

    def stop(self) -> bool:
        name = self.stop_params.get("strategy", "")
        barrier = self._barrier(name)
        if barrier is None:
            return False
        ok, current = barrier.stop(self.stop_params, self.current_round)
        if ok and current is not None:
            self.current_round = current
        return bool(ok)
