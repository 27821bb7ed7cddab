"""External operator execution: host subprocesses per client batch.

Reference hot loop being preserved (not replaced): ``Actor.loop_run`` runs
``python3 {op}/{entry} --params '<json>'`` once per virtual phone and counts
exit codes (``utils_run_task.py:481-514``). Here the same contract runs per
*client batch* (``BATCH_SIZE`` 1 reproduces per-phone granularity) with bounded
subprocess parallelism replacing the Ray actor pool. The result feeds the
same ok-mask accounting as the compiled path, so status fusion and
per-device-class success/failed counts are identical in shape.

A copy of the JAX package's ``operators/external.py``, with two
differences. Its ok mask spans the population's whole padded client axis
(``padded_clients``), which a data-parallel rank's shard holds only in
part; at one rank it is the JAX module's ``num_clients``. Over several
ranks (the core's plan), each rank runs every world-th batch and the ranks
sum their masks, so each client's code runs once a round, as in the JAX
package's one process. The batch size, the concurrency, the timeout and the
interpreter are the JAX module's defaults, as constants: no task sets them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np

BATCH_SIZE = 1       # clients per subprocess (1 == reference per-phone)
MAX_WORKERS = 8      # concurrent subprocesses (the actor-pool analogue)
TIMEOUT_S = 300.0


@dataclasses.dataclass
class ExternalOperator:
    """Runs user operator code for every client of every population.

    ``code_dir`` must already contain the operator code (use
    ``storage.fetch_operator_code`` to stage a zip from any FileRepo).
    """

    code_dir: str
    entry_file: str
    operator_params: str = ""  # opaque JSON string handed to the operator

    def __post_init__(self):
        entry = os.path.join(self.code_dir, self.entry_file)
        if not os.path.isfile(entry):
            raise FileNotFoundError(f"operator entry not found: {entry}")
        # Parse operator_params once, at build time: a malformed JSON blob
        # must fail the task here, not silently train with defaults.
        if self.operator_params:
            try:
                self._parsed_params = json.loads(self.operator_params)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"operator_params is not valid JSON: {e}"
                ) from e
        else:
            self._parsed_params = {}
        # One stable scratch root per operator instance (reference
        # actor_save_dir is per-actor and stable across rounds,
        # utils_run_task.py:430-479); per-batch subdirs are reused each
        # round instead of leaking a tempdir per round.
        self.save_dir = tempfile.mkdtemp(prefix="ext_op_")

    # ------------------------------------------------------------------ batch
    def _batch_params(self, task_id: str, round_idx: int, operator_name: str,
                      population_name: str, client_ids: List[int],
                      save_dir: str) -> Dict[str, Any]:
        """Per-batch params in the reference schema
        (``base_operator.py:15-52``)."""
        os.makedirs(save_dir, exist_ok=True)
        return {
            "task_id": task_id,
            "current_round": round_idx,
            "data": {"name": population_name},
            "operator": {
                "name": operator_name,
                "operator_params": self.operator_params,
            },
            "client_ids": client_ids,
            "actor_save_dir": save_dir,
            "actor_simulation_num": len(client_ids),
            "params": self._parsed_params,
        }

    def _run_batch(self, params: Dict[str, Any]) -> bool:
        cmd = [sys.executable, os.path.join(self.code_dir, self.entry_file),
               "--params", json.dumps(params)]
        try:
            proc = subprocess.run(
                cmd, cwd=self.code_dir, timeout=TIMEOUT_S,
                capture_output=True,
            )
            return proc.returncode == 0
        except (subprocess.TimeoutExpired, OSError):
            return False

    # -------------------------------------------------------------- operator
    def __call__(self, runner, round_idx: int, operator, population) -> Dict[str, Any]:
        """OperatorSpec.custom_fn: advance one population's clients through
        the external code; the returned ok_mask feeds analyze_results (the
        exit-code accounting of ``utils_run_task.py:490-494``)."""
        from olearning_sim_tpu_torch.parallel import collectives

        group = runner.core.plan.world_group
        me, world = collectives.rank(group), collectives.size(group)
        p = population
        real = p.dataset.num_real_clients
        batches = [
            list(range(s, min(s + BATCH_SIZE, real)))
            for s in range(0, real, BATCH_SIZE)
        ]
        mine = range(me, len(batches), world)
        params_list = [
            self._batch_params(
                runner.task_id, round_idx, operator.name, p.name, batches[bi],
                os.path.join(self.save_dir, f"{p.name}_batch{bi}"),
            )
            for bi in mine
        ]
        with ThreadPoolExecutor(max_workers=MAX_WORKERS) as pool:
            results = list(pool.map(self._run_batch, params_list))
        ok = np.zeros(p.dataset.padded_clients, bool)
        for bi, success in zip(mine, results):
            ok[batches[bi]] = success
        if world > 1:
            import torch

            # Each client's result is on one rank only: the sum is the mask.
            local = torch.from_numpy(ok.astype(np.int32)).to(runner._device(p))
            ok = collectives.psum([local], group)[0].cpu().numpy() > 0
        success_n = int(ok[:real].sum())
        return {"ok_mask": ok, "success": success_n, "failed": real - success_n}


def external_operator_spec(name: str, code_dir: str, entry_file: str,
                           operator_params: str = "",
                           use_deviceflow: bool = False,
                           deviceflow_strategy: str = "",
                           inputs=None):
    """Build an OperatorSpec running external user code (the task-bridge
    path for non-``builtin:`` operatorCodePath values). Deviceflow lifecycle
    flags carry over so legacy operators keep their NotifyStart/Complete
    semantics."""
    from olearning_sim_tpu_torch.engine.runner import OperatorSpec

    return OperatorSpec(
        name=name,
        kind="custom",
        use_deviceflow=use_deviceflow,
        deviceflow_strategy=deviceflow_strategy,
        inputs=list(inputs or []),
        custom_fn=ExternalOperator(
            code_dir=code_dir, entry_file=entry_file,
            operator_params=operator_params,
        ),
    )
