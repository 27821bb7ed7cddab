"""Hybrid logical/device allocation: the min-makespan integer program.

Reference: ``ols_core/taskMgr/utils/utils_runner.py:939-1022``
(``auto_allocation_hybrid_task``) — decide how many device-rounds of each
device class run as logical simulation vs on real phones, minimizing the
slower of the two pipelines, with a measured cost model:

    time_logical(i) = ceil(x_i * k_i / f_i) * alpha
    time_phone(i)   = ceil((N_i - q_i - x_i) / m_i) * beta + lambda

where per class i: N = total device-rounds, q = measurement ("running
response") rounds pinned to phones, f = logical computation units, m = phone
count, k = rounds multiplier, x = device-rounds sent to logical simulation.

The reference solves with PuLP/CBC; this implementation uses
``scipy.optimize.milp`` (HiGHS) with the identical ceil-linearization, plus a
brute-force fallback. The reference's measured constants (alpha=3.5 s,
beta=0.14 s, lambda=8.808 s, ``utils_runner.py:941-943``) remain defaults; on
an accelerator the measured alpha is orders of magnitude smaller — pass a
measured :class:`CostModel` for real allocations.

A copy of the JAX package's ``taskmgr/hybrid.py``; it reads and writes
the port's ``TaskConfig`` dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-device-round costs in seconds."""

    alpha: float = 3.5    # logical (reference CPU actor measurement)
    beta: float = 0.14    # phone per round
    lam: float = 8.808    # phone fixed startup

    @staticmethod
    def tpu_measured(device_rounds_per_sec: float) -> "CostModel":
        """Cost model with alpha derived from a measured accelerator
        throughput (device-rounds/sec; the JAX package's name)."""
        return CostModel(alpha=1.0 / max(device_rounds_per_sec, 1e-9))


def _makespan(x: int, N: int, q: int, f: int, k: int, m: int, cm: CostModel) -> float:
    t_log = math.ceil(x * k / f) * cm.alpha if f > 0 else (math.inf if x > 0 else 0.0)
    remaining = N - q - x
    t_ph = (math.ceil(remaining / m) * cm.beta + cm.lam) if m > 0 else (
        math.inf if remaining > 0 else 0.0
    )
    return max(t_log, t_ph)


def _solve_brute(N, q, f, k, m, cm: CostModel) -> List[int]:
    """Exact per-class search. The makespan is the max over classes, but each
    class's term depends only on its own x, so minimizing each class's own
    max(t_log, t_phone) minimizes the global max too."""
    xs = []
    for Ni, qi, fi, ki, mi in zip(N, q, f, k, m):
        best_x, best_t = 0, math.inf
        for x in range(0, Ni - qi + 1):
            t = _makespan(x, Ni, qi, fi, ki, mi, cm)
            if t < best_t:
                best_x, best_t = x, t
        xs.append(best_x)
    return xs


def _solve_milp(N, q, f, k, m, cm: CostModel) -> List[int] | None:
    """HiGHS MILP with the reference's ceil linearization
    (``utils_runner.py:984-1009``). Variable layout per class i:
    [x_i, ceil_logical_i, ceil_phone_i], then the shared makespan z."""
    try:
        from scipy.optimize import LinearConstraint, milp
        from scipy.optimize import Bounds
    except ImportError:
        return None

    n = len(N)
    nv = 3 * n + 1  # x, cl, cp per class + z
    z_idx = 3 * n

    c = np.zeros(nv)
    c[z_idx] = 1.0  # minimize z

    lb = np.zeros(nv)
    ub = np.full(nv, np.inf)
    integrality = np.ones(nv)
    integrality[z_idx] = 0
    for i in range(n):
        ub[3 * i] = N[i] - q[i]

    A_rows, lo, hi = [], [], []

    def row(coeffs: Dict[int, float], lo_v: float, hi_v: float):
        r = np.zeros(nv)
        for j, v in coeffs.items():
            r[j] = v
        A_rows.append(r)
        lo.append(lo_v)
        hi.append(hi_v)

    for i in range(n):
        xi, cli, cpi = 3 * i, 3 * i + 1, 3 * i + 2
        # cl_i >= x_i * k_i / f_i  and  cl_i <= (x_i*k_i + f_i - 1)/f_i
        row({cli: f[i], xi: -k[i]}, 0.0, f[i] - 1)
        # cp_i >= (N_i - q_i - x_i)/m_i  and  <= (... + m_i - 1)/m_i
        row({cpi: m[i], xi: 1.0}, N[i] - q[i], N[i] - q[i] + m[i] - 1)
        # z >= cl_i * alpha ;  z >= cp_i * beta + lambda
        row({z_idx: 1.0, cli: -cm.alpha}, 0.0, np.inf)
        row({z_idx: 1.0, cpi: -cm.beta}, cm.lam, np.inf)

    res = milp(
        c=c,
        constraints=LinearConstraint(np.array(A_rows), np.array(lo), np.array(hi)),
        integrality=integrality,
        bounds=Bounds(lb, ub),
    )
    if not res.success:
        return None
    return [int(round(res.x[3 * i])) for i in range(n)]


def auto_allocation_hybrid_task(
    data_dict: Dict[str, Sequence[int]],
    cost_model: CostModel = CostModel(),
) -> Tuple[List[int], List[int]]:
    """Reference-compatible entry (``utils_runner.py:939-1022``): input keys
    N, f, k, m, q per device class; returns (allocation_logical,
    allocation_device). Classes with no phones (m=0) go fully logical; with
    no logical units (f=0) fully device; the rest are optimized."""
    n_all = len(data_dict["N"])
    alloc_logical = [0] * n_all
    alloc_device = [0] * n_all
    remain = []
    for i in range(n_all):
        if data_dict["f"][i] == 0:
            alloc_device[i] = data_dict["N"][i]
        elif data_dict["m"][i] == 0:
            alloc_logical[i] = data_dict["N"][i]
        else:
            remain.append(i)
    if not remain:
        return alloc_logical, alloc_device

    N = [data_dict["N"][i] for i in remain]
    q = [data_dict["q"][i] for i in remain]
    f = [data_dict["f"][i] for i in remain]
    k = [data_dict["k"][i] for i in remain]
    m = [data_dict["m"][i] for i in remain]

    xs = _solve_milp(N, q, f, k, m, cost_model)
    if xs is None:
        xs = _solve_brute(N, q, f, k, m, cost_model)

    for j, i in enumerate(remain):
        alloc_logical[i] = xs[j]
        alloc_device[i] = int(data_dict["N"][i] - xs[j])
    return alloc_logical, alloc_device


def fix_data_parameters(tc, cost_model: CostModel = CostModel()) -> None:
    """Fill in allocations for optimization-enabled target data in place
    (reference ``HybridOptimizer.fix_data_parameters``,
    ``utils_runner.py:29-51``): f from the logical resource request, m from
    the device resource request, q from runningResponse, k=1."""
    logical_req = {
        rr.dataNameResourceRequest: dict(
            zip(rr.deviceResourceRequest, rr.numResourceRequest)
        )
        for rr in tc.logicalSimulation.resourceRequestLogicalSimulation
    }
    device_req = {
        rr.dataNameResourceRequest: dict(
            zip(rr.deviceResourceRequest, rr.numResourceRequest)
        )
        for rr in tc.deviceSimulation.resourceRequestDeviceSimulation
    }
    for td in tc.target.targetData:
        if not td.allocation.optimization:
            continue
        devices = list(td.totalSimulation.deviceTotalSimulation)
        nums = list(td.totalSimulation.numTotalSimulation)
        rr_map = dict(zip(
            td.allocation.runningResponse.deviceRunningResponse,
            td.allocation.runningResponse.numRunningResponse,
        ))
        data_dict = {
            "N": nums,
            "q": [rr_map.get(d, 0) for d in devices],
            "f": [logical_req.get(td.dataName, {}).get(d, 0) for d in devices],
            "m": [device_req.get(td.dataName, {}).get(d, 0) for d in devices],
            "k": [1] * len(devices),
        }
        alloc_l, alloc_d = auto_allocation_hybrid_task(data_dict, cost_model)
        del td.allocation.allocationLogicalSimulation[:]
        td.allocation.allocationLogicalSimulation.extend(alloc_l)
        del td.allocation.allocationDeviceSimulation[:]
        td.allocation.allocationDeviceSimulation.extend(alloc_d)
