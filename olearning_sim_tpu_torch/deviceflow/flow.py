"""Flow lifecycle state machine.

Reference: ``ols_core/deviceflow/non_grpc/deviceflow.py:15-197``. A *flow* is
one (task, operator, round)'s passage of client updates through the gradient
house: Register -> NotifyStart (per compute resource) -> messages staged ->
NotifyComplete (per compute resource) -> dispatch -> release. The same flow is
touched by both halves of a hybrid task (logical simulation on the card,
device simulation on phones), so NotifyStart performs consistency checks between
them; NotifyComplete marks per-resource completion and the flow finishes when
every registered compute resource has completed.

State is a plain dict persisted on every mutation (crash recovery re-reads it;
reference ``deviceflow_server.py:83-164``).

A copy of the JAX package's ``deviceflow/flow.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo

FLOW_COLUMNS = ["task_id", "flow_id", "flow"]


def new_flow_params(
    task_id: str, flow_id: str, strategy: str, outbound_service: Dict[str, Any]
) -> Dict[str, Any]:
    """Reference flow_params shape (``deviceflow.py:59-69``)."""
    return {
        "isFinished": False,
        "to_sort": False,
        "to_dispatch": False,
        "task_id": task_id,
        "flow_id": flow_id,
        "outbound_service": outbound_service,
        "strategy": strategy,
        "notify_start_called": {},
        "notify_complete_called": {},
    }


class FlowManager:
    def __init__(self, repo: Optional[TableRepo] = None, logger: Optional[Logger] = None):
        self.repo = repo if repo is not None else MemoryTableRepo(FLOW_COLUMNS)
        self.logger = logger if logger is not None else Logger()

    # ------------------------------------------------------------- lifecycle
    def notify_start(
        self,
        flow: Dict[str, Dict[str, Any]],
        task_id: str,
        flow_id: str,
        compute_resource: str,
        strategy: str,
        outbound_service: Optional[Dict[str, Any]] = None,
    ) -> Tuple[bool, Dict[str, Any]]:
        """First caller creates the flow; later callers (the other compute
        resource) must agree on task_id/strategy/outbound endpoints
        (reference ``deviceflow.py:29-121``)."""
        outbound_service = outbound_service or {}
        if flow_id not in flow:
            params = new_flow_params(task_id, flow_id, strategy, dict(outbound_service))
            if not self._ensure_flow_row(flow_id, task_id):
                return False, {}
        else:
            params = flow[flow_id]
            if task_id != params["task_id"]:
                self._err(task_id, "notify_start", f"task_id mismatch for flow {flow_id}")
                return False, {}
            if strategy != params["strategy"]:
                self._err(task_id, "notify_start", f"strategy mismatch for flow {flow_id}")
                return False, {}
            for endpoint, cfg in outbound_service.items():
                existing = params["outbound_service"].get(endpoint)
                if existing is None:
                    params["outbound_service"][endpoint] = cfg
                elif existing != cfg:
                    self._err(
                        task_id,
                        "notify_start",
                        f"outbound {endpoint} mismatch for flow {flow_id}",
                    )
                    return False, {}

        params["notify_start_called"][compute_resource] = True
        if not self.persist(flow_id, task_id, params):
            return False, {}
        return True, params

    def notify_complete(
        self,
        flow: Dict[str, Dict[str, Any]],
        task_id: str,
        flow_id: str,
        compute_resource: str,
    ) -> Tuple[bool, Dict[str, Any]]:
        """Reference ``deviceflow.py:123-146``: unknown flow is an error."""
        if flow_id not in flow:
            return False, {}
        params = flow[flow_id]
        if task_id != params["task_id"]:
            self._err(task_id, "notify_complete", f"task_id mismatch for flow {flow_id}")
            return False, {}
        params["notify_complete_called"][compute_resource] = True
        if not self.persist(flow_id, task_id, params):
            return False, {}
        return True, params

    @staticmethod
    def check_all_notify_start(task_registry: Dict[str, Any], params: Dict[str, Any]) -> bool:
        """All registered compute resources have called NotifyStart
        (reference ``deviceflow.py:149-153``)."""
        total = task_registry.get("total_compute_resources", [])
        called = params.get("notify_start_called", {})
        return len(total) == len(called) and all(called.values())

    @staticmethod
    def check_all_notify_complete(task_registry: Dict[str, Any], params: Dict[str, Any]) -> bool:
        total = task_registry.get("total_compute_resources", [])
        called = params.get("notify_complete_called", {})
        return len(total) == len(called) and all(called.values())

    # ----------------------------------------------------------- persistence
    def load_flows(self) -> Dict[str, Dict[str, Any]]:
        """Crash recovery: rebuild the in-memory flow map from the repo
        (reference ``deviceflow_server.py:83-164``)."""
        out: Dict[str, Dict[str, Any]] = {}
        for row in self.repo.query_all():
            blob = row.get("flow")
            if not blob:
                continue
            try:
                params = json.loads(blob)
            except (TypeError, json.JSONDecodeError):
                continue
            if not params.get("isFinished", False):
                out[row["flow_id"]] = params
        return out

    def release_flow(self, flow_id: str) -> None:
        self.repo.delete_items(flow_id=flow_id)

    def _ensure_flow_row(self, flow_id: str, task_id: str) -> bool:
        existing = self.repo.get_values_by_conditions(
            "task_id", flow_id=flow_id, task_id=task_id
        )
        if len(existing) == 0:
            return self.repo.add_item({"task_id": [task_id], "flow_id": [flow_id]})
        if len(existing) == 1:
            return True
        self._err(task_id, "notify_start", f"duplicate rows for flow {flow_id}")
        return False

    def persist(self, flow_id: str, task_id: str, params: Dict[str, Any]) -> bool:
        ok = self.repo.set_item_value(
            identify_name="flow_id",
            identify_value=flow_id,
            item="flow",
            value=json.dumps(params),
        )
        if not ok:
            self._err(task_id, "update_flow", f"failed to persist flow {flow_id}")
        return ok

    def _err(self, task_id: str, module: str, message: str):
        self.logger.error(
            task_id=task_id, system_name="Deviceflow", module_name=module, message=message
        )
