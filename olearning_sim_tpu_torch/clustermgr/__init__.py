"""Cluster substrate management: logical slices of the card fleet.

:class:`ClusterManager` carves named, non-overlapping slices out of the
visible CUDA cards (the JAX package's ``clustermgr/slice_manager.py``), so a
platform session that names the ``slicemgr`` service boots. The rest of the
JAX package's ``clustermgr`` (multi-host launch, Kubernetes jobs, elastic
resize) is not ported (ROADMAP A11)."""

from olearning_sim_tpu_torch.clustermgr.slice_manager import (
    ClusterManager,
    SliceSpec,
    SliceStatus,
)

__all__ = ["ClusterManager", "SliceSpec", "SliceStatus"]
