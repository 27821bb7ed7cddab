from olearning_sim_tpu_torch.engine.algorithms import Algorithm, fedadam, fedavg
from olearning_sim_tpu_torch.engine.client_data import (
    ClientDataset,
    make_central_text_eval_set,
    make_synthetic_text_dataset,
)
from olearning_sim_tpu_torch.engine.fedcore import (
    FedCore,
    FedCoreConfig,
    RoundMetrics,
    ServerState,
    build_fedcore,
)

__all__ = [
    "Algorithm", "ClientDataset", "FedCore", "FedCoreConfig", "RoundMetrics",
    "ServerState", "build_fedcore", "fedadam", "fedavg",
    "make_central_text_eval_set", "make_synthetic_text_dataset",
]
