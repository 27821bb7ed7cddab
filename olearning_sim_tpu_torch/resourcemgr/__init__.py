"""The frozen-resource ledger over the CUDA cards (the JAX package's
``resourcemgr``)."""

from olearning_sim_tpu_torch.resourcemgr.resource_manager import (
    RES_COLUMNS,
    DeviceTopology,
    ResourceManager,
)

__all__ = ["DeviceTopology", "RES_COLUMNS", "ResourceManager"]
