"""Cluster substrate management: slices of the card fleet, multi-process
launch and elastic rescale.

:class:`ClusterManager` carves named, non-overlapping slices out of the
visible CUDA cards (the JAX package's ``clustermgr/slice_manager.py``), so a
platform session that names the ``slicemgr`` service boots.
:mod:`~olearning_sim_tpu_torch.clustermgr.launcher` starts a world of one
process per rank over ``torch.distributed`` (the JAX package's
``jax.distributed`` launcher), :mod:`worker` is each process's entry
point, :mod:`targets` the multi-process smoke targets, and
:class:`ElasticWorldRunner` rescales a running task by
checkpoint-restart. The Kubernetes job builder is not ported
(ROADMAP A11e)."""

from olearning_sim_tpu_torch.clustermgr.elastic import ElasticWorldRunner
from olearning_sim_tpu_torch.clustermgr.launcher import (
    DistributedConfig,
    MultiHostLauncher,
    initialize_distributed,
)
from olearning_sim_tpu_torch.clustermgr.slice_manager import (
    ClusterManager,
    SliceSpec,
    SliceStatus,
)

__all__ = ["ClusterManager", "SliceSpec", "SliceStatus", "DistributedConfig",
           "MultiHostLauncher", "initialize_distributed", "ElasticWorldRunner"]
