"""Logical slice CRUD over the visible device fleet.

Reference semantics preserved from ``rayclusterMgr/kuberay_cluster_manager.py``:

- ``createRayCluster`` (``:59-102``)  -> :meth:`ClusterManager.create_slice`
- ``modifyRayCluster`` (``:112-162``) -> :meth:`ClusterManager.modify_slice`
  (the reference patches worker-group replicas; here the slice grows/shrinks
  its device allocation)
- ``deleteRayCluster`` (``:169-194``) -> :meth:`ClusterManager.delete_slice`
- ``queryRayCluster`` (``:201-225``)  -> :meth:`ClusterManager.query_slice`

Where KubeRay pods take minutes to schedule, device slices are immediate, so
the PENDING->READY lifecycle collapses; the status vocabulary is kept for
wire compatibility. State persists in a :class:`TableRepo` and is recovered on
boot (the same MySQL-recovery discipline as the rest of the control plane,
SURVEY.md section 5).

A copy of the JAX package's ``clustermgr/slice_manager.py`` over the CUDA
cards (``torch.device("cuda", i)``) in place of ``jax.devices()``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import MemoryTableRepo, TableRepo

SLICE_COLUMNS = ["slice_name", "user_id", "num_devices", "device_indices", "status"]


def cuda_devices() -> List[Any]:
    """Every visible CUDA card, in index order; raises without one."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ClusterManager: no CUDA card is visible; pass "
                           "devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class SliceStatus(str, enum.Enum):
    PENDING = "PENDING"
    READY = "READY"


@dataclasses.dataclass
class SliceSpec:
    """A named logical slice: a subset of the fleet's device indices."""

    name: str
    user_id: str
    device_indices: List[int]
    status: SliceStatus = SliceStatus.READY

    @property
    def num_devices(self) -> int:
        return len(self.device_indices)


class ClusterManager:
    """Carves the visible device fleet into named, non-overlapping slices."""

    def __init__(
        self,
        devices: Optional[Sequence[Any]] = None,
        repo: Optional[TableRepo] = None,
        logger: Optional[Logger] = None,
    ):
        """``devices`` — the fleet, default every visible CUDA card (raises
        without one: the CPU is taken only when asked for, as
        ``devices=[torch.device("cpu")]``)."""
        if devices is None:
            devices = cuda_devices()
        self.devices = list(devices)
        self.repo = repo if repo is not None else MemoryTableRepo(SLICE_COLUMNS)
        self.logger = logger if logger is not None else Logger()
        self._lock = threading.RLock()
        self._slices: Dict[str, SliceSpec] = {}
        self._recover()

    def _recover(self) -> None:
        """Re-adopt persisted slices (dropping any that no longer fit the
        fleet, e.g. after a topology shrink)."""
        for row in self.repo.query_all():
            try:
                indices = json.loads(row["device_indices"])
            except (TypeError, KeyError, json.JSONDecodeError):
                continue
            if any(not 0 <= i < len(self.devices) for i in indices):
                self.logger.warning(
                    task_id="", system_name="clustermgr", module_name="recover",
                    message=f"dropping slice {row.get('slice_name')}: device "
                            f"indices {indices} exceed fleet size {len(self.devices)}",
                )
                self.repo.delete_items(slice_name=row.get("slice_name"))
                continue
            self._slices[row["slice_name"]] = SliceSpec(
                name=row["slice_name"],
                user_id=row.get("user_id") or "",
                device_indices=indices,
                status=SliceStatus(row.get("status") or "READY"),
            )

    # ------------------------------------------------------------------ alloc
    def _free_indices(self) -> List[int]:
        used = {i for s in self._slices.values() for i in s.device_indices}
        return [i for i in range(len(self.devices)) if i not in used]

    def _persist(self, spec: SliceSpec) -> None:
        # Update-in-place when the row exists (delete-then-insert would open a
        # crash window in which the slice record is lost entirely).
        if self.repo.has_item("slice_name", spec.name):
            for col, val in (
                ("user_id", spec.user_id),
                ("num_devices", str(spec.num_devices)),
                ("device_indices", json.dumps(spec.device_indices)),
                ("status", spec.status.value),
            ):
                self.repo.set_item_value("slice_name", spec.name, col, val)
        else:
            self.repo.add_item({
                "slice_name": [spec.name],
                "user_id": [spec.user_id],
                "num_devices": [str(spec.num_devices)],
                "device_indices": [json.dumps(spec.device_indices)],
                "status": [spec.status.value],
            })

    # ------------------------------------------------------------------- CRUD
    def create_slice(self, name: str, num_devices: int, user_id: str = "") -> SliceSpec:
        with self._lock:
            if name in self._slices:
                raise ValueError(f"slice {name!r} already exists")
            free = self._free_indices()
            if num_devices <= 0 or num_devices > len(free):
                raise ValueError(
                    f"cannot allocate {num_devices} devices; {len(free)} free "
                    f"of {len(self.devices)}"
                )
            spec = SliceSpec(name=name, user_id=user_id,
                             device_indices=free[:num_devices])
            self._slices[name] = spec
            self._persist(spec)
            return spec

    def modify_slice(self, name: str, num_devices: int) -> SliceSpec:
        """Grow or shrink an existing slice (reference patches worker-group
        min/max/replicas, ``kuberay_cluster_manager.py:112-162``)."""
        with self._lock:
            spec = self._slices.get(name)
            if spec is None:
                raise KeyError(f"slice {name!r} not found")
            if num_devices <= 0:
                raise ValueError("num_devices must be positive")
            if num_devices < spec.num_devices:
                spec.device_indices = spec.device_indices[:num_devices]
            elif num_devices > spec.num_devices:
                free = self._free_indices()
                need = num_devices - spec.num_devices
                if need > len(free):
                    raise ValueError(
                        f"cannot grow slice {name!r} to {num_devices}; "
                        f"only {len(free)} devices free"
                    )
                spec.device_indices = spec.device_indices + free[:need]
            self._persist(spec)
            return spec

    def delete_slice(self, name: str) -> bool:
        with self._lock:
            spec = self._slices.pop(name, None)
            if spec is None:
                return False
            self.repo.delete_items(slice_name=name)
            return True

    def query_slice(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            spec = self._slices.get(name)
            if spec is None:
                return None
            return {
                "name": spec.name,
                "user_id": spec.user_id,
                "num_devices": spec.num_devices,
                "device_indices": list(spec.device_indices),
                "status": spec.status.value,
            }

    def list_slices(self) -> List[str]:
        with self._lock:
            return sorted(self._slices)

    # ------------------------------------------------------------------ usage
    def slice_devices(self, name: str) -> List[Any]:
        with self._lock:
            spec = self._slices.get(name)
            if spec is None:
                raise KeyError(f"slice {name!r} not found")
            return [self.devices[i] for i in spec.device_indices]

    def mesh_plan(self, name: str, dp: Optional[int] = None,
                  mp: int = 1):
        """A MeshPlan over the slice's cards — the handle tasks actually
        train with (replaces handing out a Ray cluster address). The port
        runs one ``torch.distributed`` rank per card, so the slice must span
        the default group's ranks (one rank when none is initialised)."""
        import torch.distributed as dist

        from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

        devices = self.slice_devices(name)
        world = dist.get_world_size() if (dist.is_available()
                                          and dist.is_initialized()) else 1
        if len(devices) != world:
            raise ValueError(
                f"slice {name!r} holds {len(devices)} devices but the "
                f"process group has {world} ranks (one rank per card)")
        if dp is None:
            dp = len(devices) // mp
        return make_mesh_plan(dp=dp, mp=mp)
