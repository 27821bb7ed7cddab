from olearning_sim_tpu_torch.engine.algorithms import (
    Adagrad,
    Adam,
    Algorithm,
    SGD,
    Yogi,
    ditto,
    fedadagrad,
    fedadam,
    fedavg,
    fedavgm,
    fedprox,
    fedyogi,
    from_config,
    scaffold,
)
from olearning_sim_tpu_torch.engine.client_data import (
    ClientDataset,
    make_central_eval_set,
    make_central_text_eval_set,
    make_synthetic_dataset,
    make_synthetic_text_dataset,
    make_synthetic_texture_dataset,
    make_texture_eval_set,
)
from olearning_sim_tpu_torch.engine.fedcore import (
    ControlState,
    FedCore,
    FedCoreConfig,
    PersonalState,
    RoundMetrics,
    ServerState,
    build_fedcore,
    parse_float_dtype,
)

__all__ = [
    "Adagrad", "Adam", "Algorithm", "ClientDataset", "ControlState", "FedCore",
    "FedCoreConfig", "PersonalState", "RoundMetrics", "SGD", "ServerState", "Yogi",
    "build_fedcore", "ditto", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedprox",
    "fedyogi", "from_config", "make_central_eval_set", "make_central_text_eval_set",
    "make_synthetic_dataset", "make_synthetic_text_dataset",
    "make_synthetic_texture_dataset", "make_texture_eval_set", "parse_float_dtype",
    "scaffold",
]
