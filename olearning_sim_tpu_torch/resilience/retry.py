"""Generic retry policy: exponential backoff + deterministic jitter.

One policy object serves every transient-failure call site in the stack
(storage I/O, outbound RPC, checkpoint save/restore, job submission, device
polling). Two failure contracts are supported:

- exception contract: the callable raises; retryable exceptions are retried,
  the last one is re-raised when attempts/deadline run out;
- bool/result contract (the FileRepo convention): the callable returns a
  falsy/failed result; ``retry_if`` marks it retryable, and the final failed
  result is returned for the caller to handle (no exception invented).

``HostPreemption`` and ``NotImplementedError`` are never retried: the former
must bubble to the runner's rollback logic, the latter is a capability
statement, not a transient.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np

from olearning_sim_tpu_torch.resilience.events import (
    RETRY,
    RETRY_EXHAUSTED,
    ResilienceLog,
    global_log,
)
from olearning_sim_tpu_torch.resilience.faults import HostPreemption
from olearning_sim_tpu_torch.utils.clocks import Deadline

# Exceptions a RetryPolicy refuses to absorb regardless of ``retry_on``.
NON_RETRYABLE = (HostPreemption, NotImplementedError, KeyboardInterrupt,
                 SystemExit)


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with jitter, attempt and deadline caps.

    ``jitter`` is a fraction of the current delay drawn from a seeded RNG —
    deterministic for a given (seed, attempt sequence), so chaos tests replay
    exactly. ``sleep`` is injectable (tests pass a no-op or a recorder).
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None   # overall wall-clock cap, seconds
    retry_on: Tuple[type, ...] = (Exception,)
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def delays(self) -> Iterable[float]:
        """The backoff sequence (one entry per retry, i.e. attempts - 1)."""
        rng = np.random.default_rng(self.seed)
        delay = self.base_delay
        for _ in range(max(0, self.max_attempts - 1)):
            jit = float(rng.random()) * self.jitter * delay if self.jitter else 0.0
            yield min(self.max_delay, delay + jit)
            delay = min(self.max_delay, delay * self.multiplier)

    def _retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, NON_RETRYABLE):
            return False
        return isinstance(exc, self.retry_on)

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        retry_if: Optional[Callable[[Any], bool]] = None,
        point: str = "",
        task_id: str = "",
        log: Optional[ResilienceLog] = None,
        **kwargs: Any,
    ) -> Any:
        """Invoke ``fn`` under this policy.

        ``retry_if(result)`` — True means the *returned* result is a failure
        worth retrying (bool-contract APIs). After the last attempt a failed
        result is returned as-is; a raised retryable exception is re-raised.
        """
        log = log if log is not None else global_log()
        # Monotonic countdown via the shared clock helper: a wall-clock step
        # must never expire (or extend) the retry deadline.
        deadline = Deadline(self.deadline)
        delays = iter(self.delays())
        attempt = 0
        while True:
            attempt += 1
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — filtered below
                if not self._retryable(e):
                    raise
                if not self._budget_left(attempt, deadline, delays, point,
                                         task_id, log, error=e):
                    raise
                continue
            if retry_if is None or not retry_if(result):
                return result
            if not self._budget_left(attempt, deadline, delays, point,
                                     task_id, log, error=None):
                return result

    def _budget_left(self, attempt: int, deadline: Deadline, delays,
                     point: str, task_id: str, log: ResilienceLog,
                     error: Optional[BaseException]) -> bool:
        """Record the retry (or exhaustion) and burn the backoff delay.
        Returns False when attempts or deadline are spent."""
        detail = {"attempt": attempt}
        if error is not None:
            detail["error"] = f"{type(error).__name__}: {error}"
        try:
            delay = next(delays)
        except StopIteration:
            if self.max_attempts > 1:
                # A 1-attempt policy (NO_RETRY) never retried anything, so
                # an ordinary failure must not inflate the retry_exhausted
                # robustness counter.
                log.record(RETRY_EXHAUSTED, point=point, task_id=task_id,
                           **detail)
            return False
        if delay > deadline.remaining():
            log.record(RETRY_EXHAUSTED, point=point, task_id=task_id,
                       reason="deadline", **detail)
            return False
        log.record(RETRY, point=point, task_id=task_id, delay=delay, **detail)
        if delay > 0:
            self.sleep(delay)
        return True
