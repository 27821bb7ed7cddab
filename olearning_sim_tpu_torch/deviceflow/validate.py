"""Deviceflow strategy validation.

Behavior-compatible with the reference's exhaustive strategy checks
(``ols_core/deviceflow/utils/validate_parameters.py:8-225``): exactly one of
real_time/flow; exactly one of timing/interval; monotone intervals; known
timezone; drop probability in [0,1]; per-slot list sizes consistent; amounts
sum equals the total; rate functions evaluate at their domain start.

Returns ``(ok: bool, message: str)`` — the same contract the reference gRPC
service surfaces to callers. Timezones use stdlib ``zoneinfo`` instead of
pytz.

A copy of the JAX package's ``deviceflow/validate.py``.
"""

from __future__ import annotations

import json
import math
from datetime import datetime
from enum import Enum
from typing import Any, Dict, Tuple

import numpy as np

_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


class ComputeResource(Enum):
    logical_simulation = 1
    device_simulation = 2


class StrategyTimeType(Enum):
    absolute = 1
    relative = 2


def check_notify_start_params(compute_resource: str, strategy: str) -> Tuple[bool, str]:
    """Reference ``check_params_of_notify_start`` (``validate_parameters.py:12-22``)."""
    try:
        parsed = json.loads(strategy)
    except Exception:
        return False, "strategy not json format"
    if not hasattr(ComputeResource, compute_resource):
        return False, "compute resource error"
    return check_strategy(parsed)


def check_strategy(strategy: Dict[str, Any] | str) -> Tuple[bool, str]:
    if isinstance(strategy, str):
        try:
            strategy = json.loads(strategy)
        except Exception:
            return False, "strategy not json format"

    rt = strategy.get("real_time_dispatch", {})
    flow = strategy.get("flow_dispatch", {})
    use_rt = bool(rt.get("use_strategy", False))
    use_flow = bool(flow.get("use_strategy", False))
    if use_rt == use_flow:
        return False, "Must use one strategy"
    if use_rt:
        return _check_real_time(rt)
    return _check_flow(flow)


def _check_real_time(rt: Dict[str, Any]) -> Tuple[bool, str]:
    p = rt.get("drop_simulation", {}).get("drop_probability", -1)
    if p != -1 and not 0 <= p <= 1:
        return False, "drop probability must in [0,1]"
    return True, "Pass"


def _valid_timezone(tz: str) -> bool:
    try:
        from zoneinfo import ZoneInfo

        ZoneInfo(tz)
        return True
    except Exception:
        return False


def _check_flow(flow: Dict[str, Any]) -> Tuple[bool, str]:
    total = flow.get("total_dispatch_amount", -1)

    timing = flow.get("specific_timing", {})
    interval = flow.get("specific_interval", {})
    use_timing = bool(timing.get("use", False))
    use_interval = bool(interval.get("use", False))
    if use_timing == use_interval:
        return False, "Must use one specific strategy"
    spec = timing if use_timing else interval

    time_type = spec.get("time_type", "")
    time_zone = spec.get("time_zone", "")
    if time_type == "":
        return False, "time type error"
    if not hasattr(StrategyTimeType, time_type):
        return False, "time type error, absolute or relative need"
    if time_type == StrategyTimeType.absolute.name:
        if time_zone == "":
            return False, "time zone error"
        if not _valid_timezone(time_zone):
            return False, "time zone error, format must be a known timezone"

    drop = spec.get("drop_simulation", {})
    drop_probability = drop.get("drop_probability", [])
    drop_amounts = drop.get("drop_amounts", [])
    if drop_probability and drop_amounts:
        return False, "drop probability and drop amounts can't be set at the same time"
    if drop_probability:
        for p in drop_probability:
            if not 0 <= p <= 1:
                return False, "drop probability must in [0,1]"
    elif drop_amounts:
        if total < sum(drop_amounts):
            return False, "drop amounts sum > total dispatch amount"

    if use_timing:
        return _check_timing(timing, total, time_type, drop_probability, drop_amounts)
    return _check_interval(interval, time_type, drop_probability, drop_amounts)


def _check_timing(spec, total, time_type, drop_probability, drop_amounts) -> Tuple[bool, str]:
    amounts = spec.get("amounts", [])
    if time_type == StrategyTimeType.relative.name:
        timings_list = [spec.get("timings", [])]
    else:
        timings_list = spec.get("timings", [])

    for timings in timings_list:
        try:
            if len(amounts) != len(timings):
                return False, "amounts and timings must have the same size"
            if drop_probability and len(amounts) != len(drop_probability):
                return False, "amounts, timings and drop_probability must have the same size"
            if drop_amounts and len(amounts) != len(drop_amounts):
                return False, "amounts, timings and drop_amounts must have the same size"
            if total != sum(amounts):
                return False, "amounts not equal total dispatch amount"
            if time_type == StrategyTimeType.absolute.name:
                for t in timings:
                    try:
                        datetime.strptime(t, _DATE_FORMAT)
                    except (ValueError, TypeError):
                        return False, "absolute time format error, must %Y-%m-%d %H:%M:%S"
            else:
                for t in timings:
                    try:
                        if t < 0:
                            return False, "relative time format error, must >= 0"
                    except TypeError:
                        return False, "relative time format error, must figure"
        except Exception as e:  # malformed nesting surfaces as message, not crash
            return False, f"{e}"
    return True, "Pass"


def _monotone_interval_endpoints(flat) -> bool:
    """[[1,2],[2,3]] passes, [[1,1],[2,3]] and overlaps fail: strictly
    increasing within an interval, non-decreasing across the seam
    (reference ``validate_parameters.py:163-195``)."""
    for i in range(len(flat) - 1):
        if i % 2 == 0:
            if flat[i] >= flat[i + 1]:
                return False
        else:
            if flat[i] > flat[i + 1]:
                return False
    return True


def _check_interval(spec, time_type, drop_probability, drop_amounts) -> Tuple[bool, str]:
    if time_type == StrategyTimeType.relative.name:
        intervals_list = [spec.get("intervals", [])]
    else:
        intervals_list = spec.get("intervals", [])

    for intervals in intervals_list:
        try:
            flat = [x for pair in intervals for x in pair]
            if time_type == StrategyTimeType.absolute.name:
                try:
                    stamps = [
                        datetime.strptime(t, _DATE_FORMAT).timestamp() for t in flat
                    ]
                except (ValueError, TypeError):
                    return False, "absolute time format error, must %Y-%m-%d %H:%M:%S"
                if not _monotone_interval_endpoints(stamps):
                    return False, "absolute time value error"
            else:
                if any(v < 0 for v in flat):
                    return False, "relative time format error, must >= 0"
                if not _monotone_interval_endpoints(flat):
                    return False, "relative time value error"

            rules = spec.get("dispatch_rules", {})
            domains = rules.get("domains", [])
            functions = rules.get("functions", [])
            try:
                if not (len(intervals) == len(domains) == len(functions)):
                    return False, "intervals, domains and functions must have the same size"
                if drop_probability and len(intervals) != len(drop_probability):
                    return False, (
                        "intervals, domains, functions and drop_probability "
                        "must have the same size"
                    )
                if drop_amounts and len(intervals) != len(drop_amounts):
                    return False, (
                        "intervals, domains, functions and drop_amounts "
                        "must have the same size"
                    )
                for i in range(len(domains)):
                    if domains[i][0] >= domains[i][1]:
                        return False, "domains right value must be greater than the left value"
                    t = domains[i][0]
                    eval(functions[i], {"__builtins__": {}}, {"math": math, "np": np, "t": t})
            except Exception:
                return False, "domains or functions error, variable must be t"
        except Exception as e:
            return False, f"{e}"
    return True, "Pass"
