"""Resource manager: the frozen-resource ledger, keyed to the CUDA cards.

Reference: ``ols_core/resourceMgr/resource_manager.py`` — totals snapshot at
boot from ``ray.cluster_resources()`` (``:49-54``), a MySQL ledger of frozen
cpu/mem per task, and proxying of phone-resource ops to the PhoneMgr. A copy
of the JAX package's ``resourcemgr/resource_manager.py``, whose
``TpuTopology`` counts ``jax.devices()``; here:

- the totals come from the CUDA cards (:meth:`DeviceTopology.detect`):
  ``torch.cuda.device_count()`` cards and a derived "cpu"-equivalent
  capacity so the reference scheduler vocabulary keeps working
  (``units_per_core`` computation units per card; the reference task JSONs
  ask for up to tens of units, so one unit per card admits none of them);
- the ledger is a TableRepo (sqlite/in-memory) instead of MySQL;
- phone resources are held by a pluggable ``phone_provider`` (the PhoneMgr
  client in hybrid deployments; a static dict in tests).

freeze_type semantics preserved from the reference scheduler (``task_scheduler.py:71-174``):
0 = cluster resources only, 1 = phones only, 2 = both.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional

from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo

RES_COLUMNS = ["task_id", "user_id", "cpu", "mem", "phone_resource"]


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Snapshot of the card fleet (vs ``ray.cluster_resources()``); the JAX
    package's ``TpuTopology`` with the same fields. ``platform`` is
    ``"gpu"`` for CUDA cards, ``"cpu"`` for the host."""

    num_chips: int
    num_cores: int
    platform: str
    device_kinds: List[str]
    # Scheduler-vocabulary capacity: computation units ("cpu") and memory
    # units ("mem") over all cards.
    cpu: float = 0.0
    mem: float = 0.0

    @staticmethod
    def detect(device="cuda", units_per_core: float = 1.0,
               mem_per_core: float = 1.0) -> "DeviceTopology":
        """The cards of ``device``'s type: every visible CUDA card (one
        core per card), or the host as one core for ``"cpu"``. Raises
        without CUDA unless the CPU is asked for."""
        import torch

        from olearning_sim_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            kinds = sorted({torch.cuda.get_device_name(i) for i in range(n)})
            platform = "gpu"
        else:
            n, kinds, platform = 1, ["cpu"], "cpu"
        return DeviceTopology(
            num_chips=n,
            num_cores=n,
            platform=platform,
            device_kinds=kinds,
            cpu=n * units_per_core,
            mem=n * mem_per_core,
        )


class ResourceManager:
    def __init__(
        self,
        topology: Optional[DeviceTopology] = None,
        repo: Optional[TableRepo] = None,
        phone_provider: Optional[Callable[[], Dict[str, Dict[str, int]]]] = None,
        logger: Optional[Logger] = None,
    ):
        self.topology = topology if topology is not None else DeviceTopology.detect()
        self.repo = repo if repo is not None else MemoryTableRepo(RES_COLUMNS)
        self.phone_provider = phone_provider or (lambda: {})
        self.logger = logger if logger is not None else Logger()
        self._lock = threading.RLock()
        self._frozen_phones: Dict[str, Dict[str, Dict[str, int]]] = {}  # task -> user -> type -> n
        self._recover()

    def _recover(self):
        for row in self.repo.query_all():
            phones = row.get("phone_resource")
            if phones:
                try:
                    self._frozen_phones[row["task_id"]] = json.loads(phones)
                except (TypeError, json.JSONDecodeError):
                    pass

    # ----------------------------------------------------------------- query
    def _frozen_totals(self) -> Dict[str, float]:
        cpu = mem = 0.0
        for row in self.repo.query_all():
            cpu += float(row.get("cpu") or 0)
            mem += float(row.get("mem") or 0)
        return {"cpu": cpu, "mem": mem}

    def get_resource(self) -> Dict[str, Any]:
        """Available = topology totals - frozen ledger; phones from provider
        minus frozen phone counts (reference ``getResource``,
        ``resource_manager.py:262-281``)."""
        with self._lock:
            phones = {u: dict(t) for u, t in self.phone_provider().items()}
            for task_phones in self._frozen_phones.values():
                for user, types in task_phones.items():
                    for ptype, n in types.items():
                        if user in phones and ptype in phones[user]:
                            phones[user][ptype] = max(0, phones[user][ptype] - n)
            return {
                "logical_simulation": self.get_cluster_available_resource(),
                "device_simulation": phones,
                "topology": dataclasses.asdict(self.topology),
            }

    def get_cluster_available_resource(self) -> Dict[str, float]:
        """Totals minus frozen ledger (reference
        ``getClusterAvailableResource``, ``resource_manager.py:98-106``)."""
        with self._lock:
            frozen = self._frozen_totals()
            return {
                "cpu": max(0.0, self.topology.cpu - frozen["cpu"]),
                "mem": max(0.0, self.topology.mem - frozen["mem"]),
            }

    def get_cluster_total_resource(self) -> Dict[str, float]:
        """Boot-time topology totals (reference ``getClusterTotalResource``,
        ``resource_manager.py:245-251``)."""
        return {"cpu": self.topology.cpu, "mem": self.topology.mem}

    def get_cluster_resource_detail(self) -> list:
        """Frozen ledger rows (reference ``getClusterResourceDetail`` returns
        the running rows, ``resource_manager.py:234-243``)."""
        with self._lock:
            return list(self.repo.query_all())

    # ---------------------------------------------------------------- freeze
    def request_cluster_resource(self, task_id: str, user_id: str,
                                 cpu: float, mem: float) -> bool:
        """Reference ``requestClusterResource`` (``resource_manager.py:135-194``)."""
        with self._lock:
            # Only the cluster numbers are needed — get_resource() would also
            # hit the phone provider (a gRPC round-trip in hybrid mode) under
            # the ledger lock.
            avail = self.get_cluster_available_resource()
            if cpu > avail["cpu"] or mem > avail["mem"]:
                self.logger.error(
                    task_id=task_id, system_name="ResourceMgr", module_name="request",
                    message=f"insufficient cluster resources: need cpu={cpu} mem={mem}, "
                    f"have {avail}",
                )
                return False
            if self.repo.has_item("task_id", task_id):
                return False  # double-freeze guard
            return self.repo.add_item({
                "task_id": [task_id],
                "user_id": [user_id],
                "cpu": [cpu],
                "mem": [mem],
                "phone_resource": [json.dumps({})],
            })

    def release_cluster_resource(self, task_id: str) -> bool:
        """Reference ``releaseClusterResource`` (``resource_manager.py:199-230``);
        idempotent."""
        with self._lock:
            self.repo.delete_items(task_id=task_id)
            self._frozen_phones.pop(task_id, None)
            return True

    def request_phone_resource(self, task_id: str, user_id: str,
                               phones: Dict[str, int]) -> bool:
        """Reference ``requestResource`` phone path (``resource_manager.py:283-332``)."""
        with self._lock:
            avail = self.get_resource()["device_simulation"].get(user_id, {})
            for ptype, n in phones.items():
                if n > avail.get(ptype, 0):
                    return False
            entry = self._frozen_phones.setdefault(task_id, {}).setdefault(user_id, {})
            for ptype, n in phones.items():
                entry[ptype] = entry.get(ptype, 0) + n
            if self.repo.has_item("task_id", task_id):
                self.repo.set_item_value(
                    "task_id", task_id, "phone_resource",
                    json.dumps(self._frozen_phones[task_id]),
                )
            else:
                self.repo.add_item({
                    "task_id": [task_id], "user_id": [user_id],
                    "cpu": [0.0], "mem": [0.0],
                    "phone_resource": [json.dumps(self._frozen_phones[task_id])],
                })
            return True

    def release_resource(self, task_id: str) -> bool:
        return self.release_cluster_resource(task_id)
