"""Monotonic-clock helpers: the one place timeout arithmetic lives.

Every timeout/deadline in the platform must be measured with
``time.monotonic()``, never ``time.time()``: wall-clock steps (NTP
correction, manual clock set, VM migration) move ``time.time()`` by
arbitrary amounts in either direction, which makes a wall-clock-based
barrier either expire instantly (forward step) or stall far past its
timeout (backward step). ``time.monotonic()`` is immune by contract.

Call sites should use :class:`Deadline` (stateful countdown) or
:func:`monotonic` (raw now) from here rather than importing ``time``
directly for timeout math — one helper, one clock, one place to audit.
A copy of the JAX package's ``utils/clocks.py``.
"""

from __future__ import annotations

import time


def monotonic() -> float:
    """The platform timeout clock (``time.monotonic``)."""
    return time.monotonic()


class Deadline:
    """A countdown measured on the monotonic clock.

    ``Deadline(5.0)`` expires 5 seconds of *monotonic* time from
    construction, regardless of what the wall clock does in between.
    ``timeout_s=None`` never expires (an explicit "no deadline").
    """

    __slots__ = ("timeout_s", "_t0")

    def __init__(self, timeout_s: float | None):
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self._t0 = monotonic()

    def elapsed(self) -> float:
        return monotonic() - self._t0

    def remaining(self) -> float:
        if self.timeout_s is None:
            return float("inf")
        return self.timeout_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0
