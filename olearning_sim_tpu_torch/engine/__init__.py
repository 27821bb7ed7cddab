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
from olearning_sim_tpu_torch.engine.async_rounds import (
    AsyncConfig,
    AsyncRoundPlan,
    AsyncStats,
    plan_async_round,
    staleness_weights,
)
from olearning_sim_tpu_torch.engine.client_data import (
    ClientDataset,
    HostClientStore,
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
    StreamStats,
    build_fedcore,
    parse_float_dtype,
)
from olearning_sim_tpu_torch.engine.scenario import (
    ScenarioConfig,
    ScenarioModel,
    ScenarioTrace,
    SpikeSpec,
)

__all__ = [
    "Adagrad", "Adam", "Algorithm", "AsyncConfig", "AsyncRoundPlan", "AsyncStats",
    "ClientDataset", "ControlState", "FedCore",
    "FedCoreConfig", "HostClientStore", "PersonalState", "RoundMetrics", "SGD",
    "ScenarioConfig", "ScenarioModel", "ScenarioTrace", "ServerState", "SpikeSpec",
    "StreamStats", "Yogi",
    "build_fedcore", "ditto", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedprox",
    "fedyogi", "from_config", "make_central_eval_set", "make_central_text_eval_set",
    "make_synthetic_dataset", "make_synthetic_text_dataset",
    "make_synthetic_texture_dataset", "make_texture_eval_set", "parse_float_dtype",
    "plan_async_round", "scaffold", "staleness_weights",
]
