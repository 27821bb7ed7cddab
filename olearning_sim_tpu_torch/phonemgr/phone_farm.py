"""Simulated phone farm implementing the PhoneManager wire surface.

Progress is computed lazily from wall-clock against the phone cost model —
no background threads: a device job submitted at t0 with R rounds has
completed ``clamp(floor((speedup * (now - t0) - startup_s) / round_time_s),
0, R)`` rounds at query time. ``speedup`` compresses simulated time for
tests (speedup=100 -> the 8.8 s startup passes in 88 ms of wall time).

Failure injection mirrors the platform's fault model (per-device-class
failure counting against ``dynamic_nums`` tolerances,
reference ``task_manager.py:743-748``): each (round, class) draws failures
binomially with ``failure_rate`` from a deterministic per-task stream.

A copy of the JAX package's ``phonemgr/phone_farm.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PhoneCostModel:
    """Measured constants from the reference allocator
    (``taskMgr/utils/utils_runner.py:941-943``)."""

    round_time_s: float = 0.14   # beta: one FL round on a physical phone
    startup_s: float = 8.808     # lambda: app start / model push overhead


@dataclasses.dataclass
class _DeviceJob:
    task_id: str
    rounds: int
    operators: List[str]
    # [{"name": data, "devices": [class...], "nums": [n...]}]
    data: List[Dict[str, Any]]
    t0: float
    stopped_at_round: Optional[int] = None


class SimulatedPhoneFarm:
    """PhoneManager-surface farm over a static phone inventory.

    ``inventory``: {user_id: {phone_type: count}} — the
    getDeviceAvailableResource answer before freezes.
    """

    def __init__(
        self,
        inventory: Dict[str, Dict[str, int]],
        cost: PhoneCostModel = PhoneCostModel(),
        speedup: float = 1.0,
        failure_rate: float = 0.0,
        seed: int = 0,
    ):
        self.inventory = {u: dict(t) for u, t in inventory.items()}
        self.cost = cost
        self.speedup = float(speedup)
        self.failure_rate = float(failure_rate)
        self.seed = seed
        self._lock = threading.RLock()
        self._frozen: Dict[str, Dict[str, Dict[str, int]]] = {}  # task->user->type
        self._jobs: Dict[str, _DeviceJob] = {}

    # --------------------------------------------------------------- resource
    def get_device_available_resource(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            avail = {u: dict(t) for u, t in self.inventory.items()}
            for task_frozen in self._frozen.values():
                for user, types in task_frozen.items():
                    for ptype, n in types.items():
                        if user in avail and ptype in avail[user]:
                            avail[user][ptype] = max(0, avail[user][ptype] - n)
            return avail

    def request_device_resource(self, task_id: str, user_id: str,
                                phones: Dict[str, int]) -> bool:
        with self._lock:
            avail = self.get_device_available_resource().get(user_id, {})
            for ptype, n in phones.items():
                if n > avail.get(ptype, 0):
                    return False
            entry = self._frozen.setdefault(task_id, {}).setdefault(user_id, {})
            for ptype, n in phones.items():
                entry[ptype] = entry.get(ptype, 0) + n
            return True

    def release_device_resource(self, task_id: str) -> bool:
        with self._lock:
            self._frozen.pop(task_id, None)
            return True

    # ------------------------------------------------------------------ tasks
    def submit_task(self, task_id: str, rounds: int, operators: List[str],
                    data: List[Dict[str, Any]]) -> bool:
        """Device sub-job intake (reference ``PhoneMgr.submitTask`` called by
        ``task_runner.py:89-114``). ``data`` entries: name / devices / nums.
        Rejected only while a live job with the same id is still running;
        finished or stopped jobs may be resubmitted (task retry)."""
        with self._lock:
            old = self._jobs.get(task_id)
            if old is not None and old.stopped_at_round is None \
                    and self._rounds_done(old) < old.rounds:
                return False
            self._jobs[task_id] = _DeviceJob(
                task_id=task_id,
                rounds=int(rounds),
                operators=list(operators) or ["train"],
                data=[dict(d) for d in data],
                t0=time.monotonic(),
            )
            return True

    def stop_device(self, task_id: str) -> bool:
        with self._lock:
            job = self._jobs.get(task_id)
            if job is None:
                return False
            if job.stopped_at_round is None:
                job.stopped_at_round = self._rounds_done(job)
            return True

    def _rounds_done(self, job: _DeviceJob) -> int:
        elapsed = (time.monotonic() - job.t0) * self.speedup
        done = int((elapsed - self.cost.startup_s) / self.cost.round_time_s)
        done = max(0, min(job.rounds, done))
        if job.stopped_at_round is not None:
            done = min(done, job.stopped_at_round)
        return done

    def _fail_count(self, task_id: str, round_idx: int, data_idx: int,
                    class_idx: int, n: int) -> int:
        if self.failure_rate <= 0.0 or n <= 0:
            return 0
        # crc32, not hash(): str hashes are PYTHONHASHSEED-randomized, which
        # would break the documented cross-process determinism.
        rng = np.random.default_rng(
            [self.seed, zlib.crc32(task_id.encode()), round_idx, data_idx, class_idx]
        )
        return int(rng.binomial(n, min(1.0, self.failure_rate)))

    def get_device_task_status(self, task_id: str) -> Dict[str, Any]:
        """DeviceTaskResult-shaped progress (reference
        ``phoneMgr.proto`` DeviceTaskResult / DeviceDataStatus; consumed by
        TaskManager status fusion, ``task_manager.py:538-576``)."""
        with self._lock:
            job = self._jobs.get(task_id)
            if job is None:
                return {"is_finished": False, "max_round": 0, "round": 0,
                        "operator": "", "device_result": []}
            done = self._rounds_done(job)
            finished = done >= job.rounds or job.stopped_at_round is not None
            result = []
            for di, d in enumerate(job.data):
                devices = list(d.get("devices", []))
                nums = list(d.get("nums", []))
                success = [0] * len(devices)
                failed = [0] * len(devices)
                if done > 0:
                    # Counts are per the last completed round (matching the
                    # logical half's fresh-per-round accounting).
                    for ci, n in enumerate(nums):
                        f = self._fail_count(task_id, done - 1, di, ci, int(n))
                        success[ci] = int(n) - f
                        failed[ci] = f
                result.append({
                    "name": d.get("name", ""),
                    "simulation_target": {
                        "devices": devices,
                        "success_num": success,
                        "failed_num": failed,
                    },
                })
            return {
                "is_finished": finished,
                "max_round": job.rounds,
                "round": done,
                "operator": job.operators[-1],
                "device_result": result,
            }
