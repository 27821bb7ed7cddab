"""Which clients train in a round, and which labels drift: a frozen NumPy
copy of the task's two availability models.

A client trains in round ``r`` when the dispatch trace releases it and the
scenario finds it available; both are pure functions of the task JSON,
the trace seed (0 for a task JSON) and ``r``.

The dispatch trace (the train operator's ``strategy_gradient_house``,
SimDC's ``flow_dispatch`` with ``specific_interval`` in relative time and
``drop_probability``): the rate curve of each interval is integrated over
every one-second slice by the trapezoid rule on 101 points (negative
segments send nothing); the total is split over intervals in proportion
and each slice's share is rounded with the residual carried; each message
of slice ``i`` is dropped with the interval's probability, drawn message
by message from ``default_rng([seed, r])``; the same generator then
permutes the clients, and messages go to clients in that order. A client
whose message is sent and not dropped trains.

The scenario (``engine`` params ``scenario``): static per-client draws
from ``default_rng([seed, 0x5CE9A10])`` in the order phase jitter,
charging start, leave, join membership, join round, drift stagger; per
round ``default_rng([seed, 0x5CE9A11, r])`` draws the online uniforms
(then the arrival uniforms). A client is available when it is alive
(``join <= r < leave``, geometric lifetimes), online (uniform below ``clip(
base + amp * cos(2 pi (h - peak - phase) / 24) * spike boosts, 0, 1)`` at
the simulated hour ``h``) and, where required, charging. Its labels rotate
by ``(r + stagger) // drift_period_rounds`` classes.

Only what the benchmark's cells use is here: any other strategy raises.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

AREA_POINTS = 100
STATIC_SALT = 0x5CE9A10
ROUND_SALT = 0x5CE9A11


def _rate(expression: str, t: float) -> float:
    return float(eval(expression, {"__builtins__": {}}, {"math": math, "np": np, "t": t}))


class Dispatch:
    """The flow-dispatch schedule of one strategy: its per-slice send
    counts are the same every round; the drops and the client order are
    drawn per round."""

    def __init__(self, strategy: Optional[dict]):
        self.amounts: List[int] = []
        self.probs: List[float] = []
        self.enabled = strategy is not None
        if strategy is None:
            return
        flow = strategy["flow_dispatch"]
        iv = flow["specific_interval"]
        if (not flow.get("use_strategy") or not iv.get("use")
                or iv.get("time_type", "relative") != "relative"
                or set(iv.get("drop_simulation", {})) != {"drop_probability"}):
            raise NotImplementedError("only relative specific_interval dispatch with "
                                      "drop_probability is modelled")
        total = int(flow["total_dispatch_amount"])
        rules = iv["dispatch_rules"]
        area_list = []
        for interval, domain, fn in zip(iv["intervals"], rules["domains"], rules["functions"]):
            ilen = interval[1] - interval[0]
            dlen = domain[1] - domain[0]
            seconds = list(range(int(interval[0]), int(interval[1]) + 1))
            pts = [domain[0] + dlen / ilen * (s - seconds[0]) for s in seconds]
            areas = []
            for i in range(len(pts) - 1):
                ts = np.linspace(pts[i], pts[i + 1], num=AREA_POINTS + 1)
                ys = [_rate(fn, float(t)) for t in ts]
                area = 0.0
                for j in range(1, len(ys)):
                    seg = 0.5 * (ys[j] + ys[j - 1]) * (1.0 / AREA_POINTS)
                    if seg > 0:
                        area += seg
                areas.append(area)
            area_list.append(areas)
        totals = [sum(a) for a in area_list]
        grand = sum(totals)
        per_interval = [round(t / grand * total) for t in totals]
        per_interval[-1] = total - sum(per_interval[:-1])
        probs_in = iv["drop_simulation"]["drop_probability"]
        for k, areas in enumerate(area_list):
            carry = 0.0
            for a in areas:
                acc = carry + a / totals[k] * per_interval[k]
                if round(acc) > 0:
                    self.amounts.append(int(round(acc)))
                    carry = acc - round(acc)
                else:
                    self.amounts.append(0)
                    carry = acc
                self.probs.append(float(probs_in[k]))

    def released(self, num_clients: int, seed: int, round_idx: int) -> np.ndarray:
        """[C] bool: the clients whose update the round releases."""
        if not self.enabled:
            return np.ones(num_clients, bool)
        rng = np.random.default_rng([seed, round_idx])
        drops = []
        for p, amount in zip(self.probs, self.amounts):
            if p <= 0:
                drops.append(np.zeros(amount, bool))
            elif p >= 1:
                drops.append(np.ones(amount, bool))
            else:
                drops.append(rng.random(amount) < p)
        order = rng.permutation(num_clients)
        out = np.zeros(num_clients, bool)
        pos = 0
        for amount, dropped in zip(self.amounts, drops):
            take = min(amount, num_clients - pos)
            out[order[pos:pos + take]] = ~dropped[:take]
            pos += take
            if pos >= num_clients:
                break
        return out


class Scenario:
    """The scenario block over one population of ``num_clients`` whose
    device class per client is ``class_names[class_of_client]``."""

    def __init__(self, cfg: Optional[dict], num_clients: int, class_of_client: np.ndarray,
                 class_names: List[str], seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        if cfg is None:
            return
        c = num_clients
        rng = np.random.default_rng([seed, STATIC_SALT])
        jitter = rng.uniform(-1.0, 1.0, size=c) * float(cfg.get("phase_jitter_hours", 0.0))
        self.charge_start = rng.uniform(0.0, 24.0, size=c)
        u_leave = rng.random(c)
        u_member = rng.random(c)
        u_join = rng.random(c)
        period = cfg.get("drift_period_rounds")
        self.stagger = (rng.integers(0, int(period), size=c) if period is not None
                        else np.zeros(c, np.int64))
        shifts = cfg.get("class_phase_hours") or {}
        phase = jitter
        if shifts:
            per_class = np.array([float(shifts.get(n, 0.0)) for n in class_names])
            phase = phase + per_class[np.clip(class_of_client[:c], 0, len(per_class) - 1)]
        self.phase = phase
        leave = float(cfg.get("leave_rate", 0.0))
        self.leave_round = (np.floor(np.log(np.maximum(u_leave, 1e-300)) / np.log1p(-leave)) + 1.0
                            if leave > 0 else np.full(c, np.inf))
        join_frac = float(cfg.get("join_frac", 0.0))
        joiner = u_member < join_frac
        self.join_round = np.zeros(c)
        if join_frac > 0:
            rate = float(cfg.get("join_rate", 0.1))
            self.join_round[joiner] = np.floor(
                np.log(np.maximum(u_join[joiner], 1e-300)) / np.log1p(-rate)) + 1.0

    def _hour(self, r: int) -> float:
        day = float(self.cfg.get("day_seconds", 86400.0))
        return (r * float(self.cfg.get("round_seconds", 600.0))) % day / day * 24.0

    def round(self, r: int, num_clients: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(available [C] bool, label shift [C] or None)``."""
        cfg = self.cfg
        if cfg is None:
            return np.ones(num_clients, bool), None
        rng = np.random.default_rng([self.seed, ROUND_SALT, r])
        online_u = rng.random(num_clients)
        h = self._hour(r)
        p = float(cfg.get("online_base", 1.0)) + float(cfg.get("online_amp", 0.0)) * np.cos(
            2.0 * np.pi * (h - float(cfg.get("peak_hour", 20.0)) - self.phase) / 24.0)
        for spike in cfg.get("spikes", []):
            start, n = int(spike["round"]), int(spike.get("rounds", 1))
            if start <= r < start + n:
                p = p * float(spike.get("boost", 3.0))
        online = online_u < np.clip(p, 0.0, 1.0)
        alive = (self.join_round <= r) & (r < self.leave_round)
        ok = alive & online
        if cfg.get("charging_required"):
            ok &= ((h - self.charge_start) % 24.0) < float(cfg.get("charging_hours", 8.0))
        shift = None
        if cfg.get("drift_period_rounds") is not None:
            shift = ((r + self.stagger) // int(cfg["drift_period_rounds"])).astype(np.int64)
        return ok, shift


class Availability:
    """Both models over one task's population: :meth:`round` gives the
    clients that train in a round and their labels' rotation."""

    def __init__(self, strategy: Optional[dict], scenario: Optional[dict], nums: List[int],
                 class_names: List[str]):
        self.num_clients = int(sum(nums))
        cls = np.repeat(np.arange(len(nums)), nums)
        self.dispatch = Dispatch(strategy)
        self.scenario = Scenario(scenario, self.num_clients, cls, class_names)

    def round(self, r: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        released = self.dispatch.released(self.num_clients, 0, r)
        available, shift = self.scenario.round(r, self.num_clients)
        if shift is not None and not shift.any():
            shift = None
        return released & available, shift


def from_task(task: dict) -> Availability:
    """The availability of a task JSON's first population and first train
    operator."""
    target = task["target"]["data"][0]
    nums = [int(n) for n in target["allocation"]["logical_simulation"]]
    names = list(target["total_simulation"]["devices"])
    train = next(op for op in task["operatorflow"]["operators"]
                 if op["logical_simulation"]["operator_code_path"] == "builtin:train")
    ctl = train["operation_behavior_controller"]
    strategy = (json.loads(ctl["strategy_gradient_house"])
                if ctl.get("use_gradient_house") and ctl.get("strategy_gradient_house") else None)
    params: Dict = json.loads(train["logical_simulation"]["operator_params"])
    return Availability(strategy, params.get("scenario"), nums, names)
