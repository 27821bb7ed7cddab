"""Deviceflow dispatch-strategy grammar -> dispatch schedules.

Behavior-compatible re-implementation of the reference's strategy synthesis
(``ols_core/deviceflow/non_grpc/strategy.py``), copied from the JAX
package's ``deviceflow/strategy.py``: a strategy JSON describes how
the "gradient house" releases client updates to the aggregator over time —
modeling device churn, periodic access spikes, and message drops.

Grammar (one of):

- ``real_time_dispatch``: forward as messages arrive, batched by
  ``dispatch_batch_sizes``, each message dropped with ``drop_probability``
  (reference ``strategy.py:19-31``).
- ``flow_dispatch`` with ``total_dispatch_amount`` and exactly one of:
  - ``specific_timing``: explicit time points + amounts, relative seconds or
    absolute wall-clock (per-round indexable) (reference ``strategy.py:73-162``),
  - ``specific_interval``: piecewise *rate functions* — user supplies time
    intervals, function domains, and expressions in ``t`` (e.g.
    ``"math.sin(t)+1"``); the area under each 1-second slice of the curve
    (trapezoidal rule, ``AREA_CALCULATION_NUM`` points) becomes the number of
    messages released that second (reference ``strategy.py:166-273,314-445``).
  Drops are per-slot index lists from either ``drop_probability`` or
  ``drop_amounts`` (reference ``strategy.py:275-311``).

Differences from the reference (intentional):

- deterministic: randomness comes from an injectable ``numpy.random.Generator``
  instead of the global ``random`` module;
- rate functions are evaluated in a restricted namespace (``math``, ``np``,
  ``t``) instead of a bare ``eval``;
- wall-clock "now" is injectable for testability of absolute schedules.
"""

from __future__ import annotations

import dataclasses
import json
import math
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Number of trapezoid sub-intervals per 1-second slice (reference
# ``strategy.py:12`` AREA_CALCULATION_NUM = 100).
AREA_CALCULATION_NUM = 100

_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


@dataclasses.dataclass(frozen=True)
class DispatchSchedule:
    """A flow-mode dispatch plan.

    ``timings[i]`` — seconds to wait after send ``i-1`` (first entry is the
    delay from schedule start); ``amounts[i]`` — messages released at slot
    ``i``; ``drop_lists[i]`` — indices (within the slot) of dropped messages.
    """

    timings: List[float]
    amounts: List[int]
    drop_lists: List[List[int]]

    @property
    def empty(self) -> bool:
        return len(self.amounts) == 0

    @property
    def total_sent(self) -> int:
        return int(sum(self.amounts))

    @property
    def total_dropped(self) -> int:
        return int(sum(len(d) for d in self.drop_lists))

    def absolute_times(self) -> List[float]:
        """Cumulative release times in seconds from schedule start."""
        out, acc = [], 0.0
        for dt in self.timings:
            acc += dt
            out.append(acc)
        return out


EMPTY_SCHEDULE = DispatchSchedule([], [], [])


@dataclasses.dataclass(frozen=True)
class RealTimePlan:
    batch_sizes: List[int]
    drop_probability: float


def _loads(strategy: str | Dict[str, Any]) -> Dict[str, Any]:
    if isinstance(strategy, str):
        return json.loads(strategy)
    return strategy


def is_real_time_dispatch(strategy: str | Dict[str, Any]) -> bool:
    """Reference ``Strategy.check_real_time_dispatch`` (``strategy.py:19-23``)."""
    return bool(_loads(strategy).get("real_time_dispatch", {}).get("use_strategy", False))


def analyze_real_time_strategy(strategy: str | Dict[str, Any]) -> RealTimePlan:
    """Reference ``Strategy.real_time_strategy_analysis`` (``strategy.py:26-31``)."""
    rt = _loads(strategy).get("real_time_dispatch", {})
    return RealTimePlan(
        batch_sizes=[int(b) for b in rt.get("dispatch_batch_sizes", [])],
        drop_probability=float(rt.get("drop_simulation", {}).get("drop_probability", 0)),
    )


def _now_in_zone(now: Optional[datetime], time_zone: str) -> datetime:
    """Wall-clock 'now' expressed in the strategy's timezone as a naive
    datetime (reference ``strategy.py:118-121``: absolute time points are
    naive strings interpreted in ``time_zone``, so 'now' must be converted
    before comparison). An injected ``now`` is used as-is (tests supply it
    already in-zone)."""
    if now is not None:
        return now
    try:
        from zoneinfo import ZoneInfo

        return datetime.now(ZoneInfo(time_zone)).replace(tzinfo=None)
    except Exception:
        return datetime.now()


def round_index_from_flow_id(flow_id: str) -> int:
    """flow_id convention ``{task_id}_{operator}_{round}`` (reference
    ``run_task.py:240``); the round is the suffix after the last underscore."""
    return int(flow_id.rsplit("_", 1)[1])


def analyze_flow_strategy(
    strategy: str | Dict[str, Any],
    flow_id: str,
    rng: Optional[np.random.Generator] = None,
    now: Optional[datetime] = None,
) -> DispatchSchedule:
    """Reference ``Strategy.flow_strategy_analysis`` (``strategy.py:33-70``):
    returns an empty schedule for any malformed/disabled combination rather
    than raising (validation is a separate, stricter pass)."""
    spec = _loads(strategy)
    flow = spec.get("flow_dispatch", {})
    if not flow.get("use_strategy", False):
        return EMPTY_SCHEDULE
    total = int(flow.get("total_dispatch_amount", 0))
    if total <= 0:
        return EMPTY_SCHEDULE

    timing = flow.get("specific_timing", {})
    interval = flow.get("specific_interval", {})
    use_timing = bool(timing.get("use", False))
    use_interval = bool(interval.get("use", False))
    if use_timing == use_interval:  # both or neither
        return EMPTY_SCHEDULE

    rng = rng if rng is not None else np.random.default_rng()
    if use_timing:
        return _specific_timing(timing, flow_id, rng, now)
    return _specific_interval(total, interval, flow_id, rng, now)


# ----------------------------------------------------------- specific_timing
def _specific_timing(
    spec: Dict[str, Any],
    flow_id: str,
    rng: np.random.Generator,
    now: Optional[datetime],
) -> DispatchSchedule:
    """Reference ``_specific_timing_analysis`` (``strategy.py:73-162``)."""
    time_type = spec.get("time_type", "relative")

    if time_type == "relative":
        timings = list(spec.get("timings", []))
    else:
        # absolute schedules are per-round indexable: timings is a list of
        # per-round lists selected by the flow_id round suffix.
        try:
            timings = list(spec.get("timings", [])[round_index_from_flow_id(flow_id)])
        except (IndexError, ValueError, TypeError):
            return EMPTY_SCHEDULE

    amounts = [int(a) for a in spec.get("amounts", [])]
    if len(timings) != len(amounts) or len(timings) == 0:
        return EMPTY_SCHEDULE

    drop_spec = spec.get("drop_simulation", {})
    if drop_spec:
        if len(drop_spec) != 1:  # exactly one drop mechanism allowed
            return EMPTY_SCHEDULE
        drop_lists = _drop_lists(amounts, drop_spec, rng)
    else:
        drop_lists = [[] for _ in amounts]

    if time_type == "absolute":
        now = _now_in_zone(now, spec.get("time_zone", "Asia/Shanghai"))
        now_frac = now.microsecond / 1e6
        base = datetime.strptime(now.strftime(_DATE_FORMAT), _DATE_FORMAT)
        offsets = [
            (datetime.strptime(t, _DATE_FORMAT) - base).total_seconds() for t in timings
        ]
        order = sorted(range(len(offsets)), key=lambda i: offsets[i])
        offsets = [offsets[i] for i in order]
        amounts = [amounts[i] for i in order]
        drop_lists = [drop_lists[i] for i in order]
        # drop already-past time points (reference ``strategy.py:136-150``)
        first = next((i for i, o in enumerate(offsets) if o >= 0), None)
        if first is None:
            return EMPTY_SCHEDULE
        offsets, amounts, drop_lists = offsets[first:], amounts[first:], drop_lists[first:]
        timings = [offsets[0] - round(now_frac, 2)] + [
            offsets[i] - offsets[i - 1] for i in range(1, len(offsets))
        ]

    return DispatchSchedule([float(t) for t in timings], amounts, drop_lists)


# --------------------------------------------------------- specific_interval
def _eval_rate(expression: str, t: float) -> float:
    """Evaluate a user rate function at ``t`` in a restricted namespace."""
    return float(eval(expression, {"__builtins__": {}}, {"math": math, "np": np, "t": t}))


def _specific_interval(
    total: int,
    spec: Dict[str, Any],
    flow_id: str,
    rng: np.random.Generator,
    now: Optional[datetime],
) -> DispatchSchedule:
    """Reference ``_specific_interval_analysis`` (``strategy.py:166-273``)."""
    time_type = spec.get("time_type", "relative")

    if time_type == "relative":
        intervals = list(spec.get("intervals", []))
    else:
        try:
            intervals = list(spec.get("intervals", [])[round_index_from_flow_id(flow_id)])
        except (IndexError, ValueError, TypeError):
            return EMPTY_SCHEDULE

    rules = spec.get("dispatch_rules", {})
    domains = list(rules.get("domains", []))
    functions = list(rules.get("functions", []))
    drop_spec = dict(spec.get("drop_simulation", {}))
    if len(intervals) != len(domains) or len(domains) != len(functions):
        return EMPTY_SCHEDULE
    if len(intervals) == 0:
        return EMPTY_SCHEDULE
    if drop_spec and len(drop_spec) != 1:
        return EMPTY_SCHEDULE

    try:
        if time_type == "absolute":
            # Convert absolute interval endpoints to a relative timeline whose
            # origin is the first interval's start (reference ``strategy.py:212-226``:
            # gaps BETWEEN intervals are preserved via the running offset).
            abs_intervals = intervals
            intervals = []
            for i, (s, e) in enumerate(abs_intervals):
                start_t = datetime.strptime(s, _DATE_FORMAT)
                end_t = datetime.strptime(e, _DATE_FORMAT)
                if i == 0:
                    lo = 0
                else:
                    prev_end = datetime.strptime(abs_intervals[i - 1][1], _DATE_FORMAT)
                    lo = int((start_t - prev_end).total_seconds()) + intervals[i - 1][1]
                hi = int((end_t - start_t).total_seconds()) + lo
                intervals.append([lo, hi])

        sched = _interval_schedule(total, intervals, domains, functions, drop_spec, rng)
    except (ZeroDivisionError, IndexError, ValueError, TypeError, KeyError):
        # Contract: malformed specs yield an empty schedule, never raise
        # (validation is the strict pass; reference strategy.py behaves
        # the same for its malformed branches).
        return EMPTY_SCHEDULE
    if sched.empty:
        return sched

    if time_type == "absolute":
        # Shift the first delay so slot 0 fires at the first interval's
        # absolute start; drop slots already in the past
        # (reference ``strategy.py:240-273``).
        now = _now_in_zone(now, spec.get("time_zone", "Asia/Shanghai"))
        now_frac = now.microsecond / 1e6
        base = datetime.strptime(now.strftime(_DATE_FORMAT), _DATE_FORMAT)
        start = datetime.strptime(abs_intervals[0][0], _DATE_FORMAT)
        timings = list(sched.timings)
        timings[0] = int((start - base).total_seconds()) - round(now_frac, 2)
        cumulative = np.cumsum(timings)
        first = next((i for i, c in enumerate(cumulative) if c >= 0), None)
        if first is None:
            return EMPTY_SCHEDULE
        timings = timings[first:]
        amounts = list(sched.amounts[first:])
        drops = [list(d) for d in sched.drop_lists[first:]]
        timings[0] = float(cumulative[first])
        return DispatchSchedule(timings, amounts, drops)

    return sched


def _interval_schedule(
    total: int,
    intervals: Sequence[Sequence[int]],
    domains: Sequence[Sequence[float]],
    functions: Sequence[str],
    drop_spec: Dict[str, Any],
    rng: np.random.Generator,
) -> DispatchSchedule:
    """Reference ``_get_interval_params`` (``strategy.py:314-445``): rate
    curves -> per-second areas -> integer send counts with residual carry."""
    t_list: List[List[int]] = []
    area_list: List[List[float]] = []
    for interval, domain, fn in zip(intervals, domains, functions):
        ilen = interval[1] - interval[0]
        dlen = domain[1] - domain[0]
        seconds = list(range(int(interval[0]), int(interval[1]) + 1))
        dom_pts = [domain[0] + dlen / ilen * (s - seconds[0]) for s in seconds]
        areas = []
        for i in range(len(dom_pts) - 1):
            ts = np.linspace(dom_pts[i], dom_pts[i + 1], num=AREA_CALCULATION_NUM + 1)
            ys = [_eval_rate(fn, float(t)) for t in ts]
            area = 0.0
            for j in range(1, len(ys)):
                seg = 0.5 * (ys[j] + ys[j - 1]) * (1.0 / AREA_CALCULATION_NUM)
                if seg > 0:  # negative-rate segments send nothing
                    area += seg
            areas.append(area)
        t_list.append(seconds[:-1])
        area_list.append(areas)

    totals = [sum(a) for a in area_list]
    grand = sum(totals)
    if grand <= 0:
        return EMPTY_SCHEDULE

    # Split the grand total across intervals proportionally (last takes the
    # rounding remainder), then integerize each interval's per-second counts
    # with a residual-carry accumulator (reference ``strategy.py:361-382``).
    amount_per_interval = [round(t / grand * total) for t in totals]
    amount_per_interval[-1] = total - sum(amount_per_interval[:-1])
    per_interval_sends: List[List[int]] = []
    for k, areas in enumerate(area_list):
        target = amount_per_interval[k]
        ideal = [a / totals[k] * target for a in areas]
        sends, carry = [], 0.0
        for v in ideal:
            acc = carry + v
            if round(acc) > 0:
                sends.append(int(round(acc)))
                carry = acc - round(acc)
            else:
                sends.append(0)
                carry = acc
        per_interval_sends.append(sends)

    # Expand interval-level drop specs to slot-level (reference
    # ``strategy.py:384-423``).
    if "drop_probability" in drop_spec:
        probs = drop_spec.get("drop_probability", [])
        expanded = []
        for k, sends in enumerate(per_interval_sends):
            expanded.extend([probs[k]] * len(sends))
        drop_spec = {"drop_probability": expanded}
    elif "drop_amounts" in drop_spec:
        amounts_in = drop_spec.get("drop_amounts", [])
        expanded = []
        for k, sends in enumerate(per_interval_sends):
            total_k = sum(sends)
            d = int(amounts_in[k])
            if d == 0:
                expanded.extend([0] * len(sends))
            elif d >= total_k:
                expanded.extend(sends)
            else:
                # Distribute d drops uniformly over the interval's messages.
                chosen = sorted(rng.choice(total_k, size=d, replace=False).tolist())
                pos, out = 0, []
                for s in sends:
                    cnt = sum(1 for c in chosen if pos <= c < pos + s)
                    out.append(cnt)
                    pos += s
                expanded.extend(out)
        drop_spec = {"drop_amounts": expanded}

    flat_times: List[int] = []
    flat_amounts: List[int] = []
    for seconds, sends in zip(t_list, per_interval_sends):
        flat_times.extend(seconds)
        flat_amounts.extend(sends)
    timings = [float(flat_times[0])] + [
        float(flat_times[i] - flat_times[i - 1]) for i in range(1, len(flat_times))
    ]
    drop_lists = _drop_lists(flat_amounts, drop_spec, rng) if drop_spec else [
        [] for _ in flat_amounts
    ]
    return DispatchSchedule(timings, flat_amounts, drop_lists)


# ------------------------------------------------------------------- drops
def _drop_lists(
    amounts: Sequence[int],
    drop_spec: Dict[str, Any],
    rng: np.random.Generator,
) -> List[List[int]]:
    """Reference ``_generate_drop_simulation_list`` (``strategy.py:275-311``)."""
    if "drop_probability" in drop_spec:
        out = []
        for p, amount in zip(drop_spec["drop_probability"], amounts):
            amount = int(amount)
            if p <= 0:
                out.append([])
            elif p >= 1:
                out.append(list(range(amount)))
            else:
                out.append([i for i in range(amount) if rng.random() < p])
        return out
    if "drop_amounts" in drop_spec:
        out = []
        for d, amount in zip(drop_spec["drop_amounts"], amounts):
            d, amount = int(d), int(amount)
            if d == 0:
                out.append([])
            elif 0 < d < amount:
                out.append(sorted(rng.choice(amount, size=d, replace=False).tolist()))
            else:
                out.append(list(range(amount)))
        return out
    return [[] for _ in amounts]
