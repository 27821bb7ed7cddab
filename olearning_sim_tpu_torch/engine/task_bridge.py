"""Task JSON -> ready-to-run :class:`SimulationRunner` on the port's engine.

The port of the JAX package's ``engine/task_bridge.py``: the task-JSON
schema a user submits drives the round engine on the GPU. Builtin
operators are addressed by name::

    "logical_simulation": {
        "operator_code_path": "builtin:train",   # or builtin:eval
        "operator_params": "{ ...engine params json... }"
    }

Engine params (the first builtin operator's ``operator_params``), all
optional::

    {
      "model":     {"name": "mlp2", "overrides": {...}, "input_shape": [784]},
      "algorithm": {"name": "fedavg", "local_lr": 0.05, ...},
      "fedcore":   {"batch_size": 32, "max_local_steps": 10, "block_clients": 64,
                    "carry_dtype": "bf16", "shard_server_update": false},
      "data":      {"synthetic": {"seed": 0, "n_local": 20, "num_classes": 10,
                    "dirichlet_alpha": null, "class_sep": 2.0}, "eval_n": 1024,
                    "real": {"scheme": "dirichlet", "alpha": 0.5, "n_local": 20},
                    "compute_profiles": {"<device class>": local_steps}},
      "resilience": {...},                    # ResilienceConfig.from_dict
      "quarantine": {"preseed": {"data_0": [3, 7]}},
      "operator_flow": {...},                 # barrier kwargs (flag_path, ...)
      "scheduling": {"family": "..."},        # cost-oracle family key
      "checkpoint": {"directory": "ckpt/{task_id}", "every": 1, "max_to_keep": 3},
      "convergence": {"target_accuracy": 0.9, "eval_every": 5, "round_budget": 40},
      "deadline":  {"deadline_s": 30.0, "over_selection": 0.3, "target_cohort": 80,
                    "quorum_fraction": 0.5, "adaptive": true,
                    "speed_profiles": {"high": 0.05, "low": 0.4}},
      "defense":   {"clip_norm": 5.0, "aggregator": "trimmed_mean",
                    "trim_fraction": 0.1, "anomaly_threshold": 4.0},
      "storage":   {"root": "/models",        # make_file_repo's keywords: the
                    "endpoint": "minio:9000", ...},  # FILE root, object-store settings
      "scenario":  {"online_base": 0.4, "online_amp": 0.3,
                    "spikes": [{"round": 3, "rounds": 2, "boost": 3.0}],
                    "leave_rate": 0.001, "drift_period_rounds": 20,
                    "stream_block_rows": 2048},
      "async":     {"buffer_size": 64, "max_staleness": 8,
                    "schedule": "polynomial", "staleness_alpha": 0.5,
                    "speed_profiles": {"high": 0.05, "low": 0.4}},
      "parallel":  {"mp": 2}                  # or {"pp": 2, "microbatches": 4}
    }

Data parallelism is not a key: as the JAX bridge builds its plan over
every device, this one builds it over every rank of ``torch.distributed``'s
default group (one rank per card, e.g. under ``torchrun``; a world of one
when no group is initialised), so dp is the world size. Each rank builds
the same population from the seed, pads it to a multiple of ``dp *
block_clients`` and places its own shard. A ``parallel`` block is parsed
as the JAX bridge parses it (an unknown key such as ``dp`` is an error)
and selects the mesh: ``mp`` runs the tensor-parallel round and ``pp`` the
pipelined one over ``world // (mp * pp)`` dp ranks; a plan handed in must
realize the block, or the task is refused in the JAX bridge's words.

With ``scenario.stream_block_rows`` the population stays on the host (a
``HostClientStore``) and train rounds stream it through the device in
blocks of that many clients (``FedCore.stream_round``); without it the
scenario's masks and drift apply to the resident round.

An operator's ``model`` (the first that sets ``use_model`` or
``model_update_style``) exports each round's global model through a file
repo of its ``model_transfer_type`` as ``model_update_style`` names it, and
with ``use_model`` warm-starts from ``model_path``. A checkpoint directory
has ``{task_id}`` replaced, and a relative one is placed under
``tempfile.gettempdir()``, so a relaunch from another working directory
resumes from the same steps.

A target with a ``dataPath`` trains on that archive, fetched over its
``dataTransferType`` with the ``storage`` block's settings, parsed and
partitioned by ``data.real`` (``olearning_sim_tpu_torch.data``); its test
split (or a held-out tail of ``eval_n`` rows) is the eval set. An operator
whose ``operatorCodePath`` is not ``builtin:`` runs user code in
subprocesses (``olearning_sim_tpu_torch.operators``): a directory as it
is, or an archive fetched over ``operatorTransferType``. An
``operator_flow.selection_url`` polls a selection service over WebSocket;
without the websocket-client package the task fails at build with an
``ImportError`` naming it. An unknown engine-params block is refused, since
a dropped block would run a different simulation than the one asked for.
The JAX bridge's persistent compile-cache switch has no counterpart in
eager PyTorch and is dropped.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np

from olearning_sim_tpu_torch.checkpoint import ModelUpdateExporter, RoundCheckpointer
from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.engine.algorithms import from_config as algorithm_from_config
from olearning_sim_tpu_torch.engine.async_rounds import AsyncConfig
from olearning_sim_tpu_torch.engine.client_data import (
    HostClientStore,
    make_central_eval_set,
    make_central_text_eval_set,
    make_synthetic_dataset,
    make_synthetic_text_dataset,
)
from olearning_sim_tpu_torch.engine.convergence import ConvergenceConfig
from olearning_sim_tpu_torch.engine.defense import DefenseConfig
from olearning_sim_tpu_torch.engine.fedcore import FedCoreConfig, build_fedcore
from olearning_sim_tpu_torch.engine.pacing import DeadlineConfig
from olearning_sim_tpu_torch.engine.runner import (
    DataPopulation,
    OperatorSpec,
    SimulationRunner,
    remove_scratch,
)
from olearning_sim_tpu_torch.engine.scenario import ScenarioConfig
from olearning_sim_tpu_torch.parallel.mesh import MeshPlan, ParallelConfig, make_mesh_plan
from olearning_sim_tpu_torch.resilience import ResilienceConfig, parse_quarantine_params
from olearning_sim_tpu_torch.storage import make_file_repo
from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
from olearning_sim_tpu_torch.taskmgr.operator_flow import (
    OperatorFlowController,
    require_websocket_client,
)
from olearning_sim_tpu_torch.telemetry import default_tracer

BUILTIN_PREFIX = "builtin:"

KNOWN = {"model", "algorithm", "fedcore", "data", "resilience", "quarantine",
         "operator_flow", "scheduling", "storage", "parallel", "checkpoint",
         "convergence", "deadline", "defense", "scenario", "async"}


def _engine_params(tc) -> Dict[str, Any]:
    """Engine params: the first builtin operator's operatorParams JSON."""
    for op in tc.operatorFlow.operator:
        info = op.logicalSimulationOperatorInfo
        if info.operatorCodePath.startswith(BUILTIN_PREFIX) and info.operatorParams:
            return json.loads(info.operatorParams)
    return {}


def cost_family(tc) -> str:
    """The scheduler cost-oracle family key of a task, as the JAX package's
    ``CostOracle.family_of`` computes it."""
    params = _engine_params(tc)
    sched = params.get("scheduling") or {}
    if sched.get("family"):
        return str(sched["family"])
    algo = (params.get("algorithm") or {}).get("name", "unknown")
    model = (params.get("model") or {}).get("name", "unknown")
    return f"{algo}_{model}"


def _check_blocks(task_id: str, params: Dict[str, Any]) -> None:
    """Refuse an unknown engine-params block; fail a ``selection_url``
    without websocket-client now, not at the first barrier."""
    unknown = sorted(set(params) - KNOWN)
    if unknown:
        raise ValueError(f"task {task_id}: unknown engine params blocks {unknown} "
                         f"(known: {sorted(KNOWN)})")
    if (params.get("operator_flow") or {}).get("selection_url"):
        require_websocket_client()


def _external_spec(op, storage: Optional[Dict[str, Any]]) -> OperatorSpec:
    """External user code: stage it (a directory as it is, else an archive
    or file fetched through its transfer type's repo) and run it through
    the subprocess escape hatch (reference get_operator_code,
    utils_runner.py:684-782 + the per-phone subprocess loop)."""
    from olearning_sim_tpu_torch.operators import external_operator_spec
    from olearning_sim_tpu_torch.storage import fetch_operator_code

    info = op.logicalSimulationOperatorInfo
    path = info.operatorCodePath
    fetched = []
    try:
        if os.path.isdir(path):
            code_dir = path
        else:
            repo = make_file_repo(info.operatorTransferType, **(storage or {}))
            fetched.append(tempfile.mkdtemp(prefix=f"op_{op.name}_"))
            code_dir = fetch_operator_code(repo, path, fetched[0])
        spec = external_operator_spec(
            name=op.name,
            code_dir=code_dir,
            entry_file=info.operatorEntryFile,
            operator_params=info.operatorParams,
            use_deviceflow=op.operationBehaviorController.useController,
            deviceflow_strategy=op.operationBehaviorController.strategyBehaviorController,
            inputs=list(op.input),
        )
    except BaseException:
        for d in fetched:
            shutil.rmtree(d, ignore_errors=True)
        raise
    spec.scratch_dirs = fetched + spec.scratch_dirs
    return spec


def _operator_specs(tc, storage: Optional[Dict[str, Any]] = None) -> list:
    specs = []
    try:
        for op in tc.operatorFlow.operator:
            info = op.logicalSimulationOperatorInfo
            if info.operatorCodePath == "":
                # Device-only operator: belongs to the phone half.
                continue
            if not info.operatorCodePath.startswith(BUILTIN_PREFIX):
                specs.append(_external_spec(op, storage))
                continue
            kind = info.operatorCodePath[len(BUILTIN_PREFIX):]
            if kind not in ("train", "eval"):
                raise ValueError(f"operator {op.name}: unknown builtin operator {kind!r}")
            specs.append(OperatorSpec(
                name=op.name,
                kind=kind,
                use_deviceflow=op.operationBehaviorController.useController,
                deviceflow_strategy=op.operationBehaviorController.strategyBehaviorController,
                outbound_service=op.operationBehaviorController.outboundService,
                inputs=list(op.input),
            ))
    except BaseException:
        remove_scratch(specs)
        raise
    return specs


def _model_io(task_id: str, tc, params: Dict[str, Any]):
    """The operators' ``Model`` (taskservice.proto Model): per-round export
    named by modelUpdateStyle and a warm start from modelPath (reference
    ``download_model_files``, ``utils_run_task.py:327-397``). Returns
    (model_io, warm_start_path)."""
    for op in tc.operatorFlow.operator:
        m = op.model
        if not (m.useModel or m.modelUpdateStyle):
            continue
        try:
            repo = make_file_repo(m.modelTransferType, **(params.get("storage") or {}))
        except ValueError as e:
            raise ValueError(f"task {task_id}: operator {op.name} model: {e}") from None
        model_io = ModelUpdateExporter(
            repo, task_id,
            **({"update_style": m.modelUpdateStyle} if m.modelUpdateStyle else {}),
        )
        return model_io, (m.modelPath if m.useModel and m.modelPath else None)
    return None, None


def _checkpointer(task_id: str, ckpt_cfg: Dict[str, Any], registry) -> RoundCheckpointer:
    """The checkpoint block's RoundCheckpointer, in a per-task directory,
    writing its series into the runner's registry."""
    # str.replace, not .format: a path with any other brace must pass
    # through, not raise.
    directory = str(ckpt_cfg.get("directory") or "").replace("{task_id}", task_id)
    if not directory:
        directory = os.path.join(tempfile.gettempdir(), "ols_checkpoints", task_id)
    elif not os.path.isabs(directory):
        # Anchor relative paths: a relaunch from another working directory
        # must open the same directory, or it would resume from round 0.
        directory = os.path.join(tempfile.gettempdir(), directory)
    return RoundCheckpointer(directory, max_to_keep=int(ckpt_cfg.get("max_to_keep", 3)),
                             task_id=task_id, registry=registry)


def build_runner_from_taskconfig(
    tc,
    task_repo=None,
    deviceflow=None,
    stop_event: Optional[threading.Event] = None,
    perf=None,
    cost_oracle=None,
    registry=None,
    device="cuda",
    plan: Optional[MeshPlan] = None,
) -> SimulationRunner:
    """Build a ready-to-run runner from a task JSON (str or dict), the
    port's :class:`~olearning_sim_tpu_torch.taskmgr.codecs.TaskConfig`, or a
    protobuf ``TaskConfig`` handed in by the JAX control plane (read by
    attribute). The model, its parameters and the populations are placed
    on ``device``, which defaults to CUDA and raises without it.
    ``task_repo`` / ``deviceflow`` / ``perf`` / ``cost_oracle`` /
    ``registry`` are handed to the runner, duck-typed; with a
    ``cost_oracle`` the runner feeds it under :func:`cost_family`'s key.
    ``plan`` — the mesh plan (default: the ``parallel`` block's over every
    rank of the default group, or a world of one); one handed in must
    realize the block. The build is a ``bridge.build`` span of the
    default tracer, holding ``bridge.model``, ``bridge.populations`` and
    ``bridge.runner``."""
    with default_tracer().span("bridge.build"):
        if isinstance(tc, (str, dict)):
            tc = json2taskconfig(tc)
        dev = resolve_device(device)
        task_id = tc.taskID.taskID
        params = _engine_params(tc)
        _check_blocks(task_id, params)
        # The block selects the mesh, so it is resolved before the plan, as
        # the JAX bridge resolves it.
        parallel = (ParallelConfig.from_dict(params["parallel"])
                    if params.get("parallel") else ParallelConfig())
        if plan is None:
            plan = parallel.make_plan() if parallel.enabled else make_mesh_plan()
        elif parallel.enabled and not parallel.matches(plan):
            raise ValueError(
                f"task {task_id}: engine params ask for "
                f"parallel mp={parallel.mp} pp={parallel.pp} but the supplied "
                f"mesh plan has mp={plan.mp} pp={plan.pp}"
            )
        operators = _operator_specs(tc, storage=params.get("storage"))
        try:
            return _assemble(tc, dev, task_id, params, plan, parallel, operators,
                             task_repo=task_repo, deviceflow=deviceflow,
                             stop_event=stop_event, perf=perf, cost_oracle=cost_oracle,
                             registry=registry)
        except BaseException:
            # The runner that would have removed the operators' scratch
            # directories at its end was never made.
            remove_scratch(operators)
            raise


def _assemble(tc, dev, task_id: str, params: Dict[str, Any], plan: MeshPlan, parallel,
              operators: list, *, task_repo, deviceflow, stop_event, perf, cost_oracle,
              registry) -> SimulationRunner:
    """The rest of :func:`build_runner_from_taskconfig`, once the plan and
    the operators are settled: the model, the populations, the flow and the
    runner."""
    # Parsed before any data is made, so a bad block fails fast.
    model_io, warm_start_path = _model_io(task_id, tc, params)
    convergence = (ConvergenceConfig.from_dict(params["convergence"])
                   if params.get("convergence") else None)
    deadline = (DeadlineConfig.from_dict(params["deadline"])
                if params.get("deadline") else None)
    defense = (DefenseConfig.from_dict(params["defense"])
               if params.get("defense") else None)
    scenario = (ScenarioConfig.from_dict(params["scenario"])
                if params.get("scenario") else None)
    async_config = AsyncConfig.from_dict(params["async"]) if params.get("async") else None

    model_cfg = params.get("model", {})
    algo_cfg = dict(params.get("algorithm", {}))
    data_cfg = params.get("data", {})
    # One validated parser for every fedcore knob: a typo'd or wrong-typed
    # knob fails here, before any data is made.
    cfg = FedCoreConfig.from_dict(params.get("fedcore", {}))
    algorithm = algorithm_from_config(algo_cfg.pop("name", "fedavg"), **algo_cfg)
    input_shape = tuple(model_cfg.get("input_shape", [])) or None

    tracer = default_tracer()
    with tracer.span("bridge.model"):
        from olearning_sim_tpu_torch.models import get_model

        model_name = model_cfg.get("name", "mlp2")
        # An unknown model raises get_model's KeyError, as in the JAX bridge.
        spec = get_model(model_name)
        core = build_fedcore(model_name, algorithm, cfg,
                             model_overrides=model_cfg.get("overrides"),
                             input_shape=input_shape, device=dev, plan=plan,
                             microbatches=parallel.microbatches)

    syn = data_cfg.get("synthetic", {})
    overrides = model_cfg.get("overrides") or {}
    # The model's head size bounds the labels; its embedding table bounds
    # the token ids.
    model_classes = int(overrides.get("num_classes",
                                      spec.defaults.get("num_classes", spec.num_classes)))
    num_classes = int(syn.get("num_classes", model_classes))
    if num_classes > model_classes:
        raise ValueError(
            f"data.synthetic.num_classes={num_classes} exceeds the model's "
            f"head size {model_classes}; labels would fall outside the logits"
        )
    if input_shape is None:
        input_shape = spec.example_input_shape
    is_text = np.issubdtype(np.dtype(spec.input_dtype), np.integer)
    model_vocab = int(overrides.get("vocab_size", spec.defaults.get("vocab_size", 30522)))
    vocab_size = int(syn.get("vocab_size", model_vocab))
    if is_text and vocab_size > model_vocab:
        raise ValueError(
            f"data.synthetic.vocab_size={vocab_size} exceeds the model's "
            f"vocab_size={model_vocab}; token ids would fall outside the "
            f"embedding table"
        )

    seed = int(syn.get("seed", 0))
    populations = []
    with tracer.span("bridge.populations"):
        for td in tc.target.targetData:
            devices = list(td.totalSimulation.deviceTotalSimulation)
            # The logical half simulates only its allocated share of devices;
            # the rest belongs to real phones (hybrid split).
            alloc = [int(a) for a in td.allocation.allocationLogicalSimulation]
            if alloc and any(a > 0 for a in alloc):
                nums = alloc
            else:
                nums = [int(n) for n in td.totalSimulation.numTotalSimulation]
            dynamic = [int(n) for n in td.totalSimulation.dynamicNumTotalSimulation]
            if not dynamic:
                dynamic = [0] * len(nums)
            num_clients = sum(nums)
            eval_data = None
            pop_classes = num_classes
            if td.dataPath:
                # Real dataset: honour dataPath + dataTransferType (reference
                # download_data_files, utils_run_task.py:174-325). The archive's
                # test split (or a held-out tail) is the central eval set.
                from olearning_sim_tpu_torch.data import load_population

                real_cfg = data_cfg.get("real", {})
                text_kwargs = ({"vocab_size": vocab_size, "seq_len": int(input_shape[0])}
                               if is_text else {})
                ds, eval_data, data_classes = load_population(
                    td.dataPath,
                    num_clients=num_clients,
                    n_local=int(real_cfg.get("n_local", syn.get("n_local", 20))),
                    scheme=real_cfg.get("scheme", "dirichlet"),
                    alpha=float(real_cfg.get("alpha", syn.get("dirichlet_alpha") or 0.5)),
                    seed=seed,
                    transfer_type=td.dataTransferType,
                    storage_settings=params.get("storage"),
                    eval_n=data_cfg.get("eval_n"),
                    **text_kwargs,
                )
                if data_classes > model_classes:
                    raise ValueError(
                        f"dataset at {td.dataPath!r} has {data_classes} classes "
                        f"but the model's head emits only {model_classes}"
                    )
                pop_classes = data_classes
            elif is_text:
                ds = make_synthetic_text_dataset(
                    seed=seed, num_clients=num_clients, n_local=int(syn.get("n_local", 20)),
                    seq_len=int(input_shape[0]), num_classes=num_classes,
                    vocab_size=vocab_size, dirichlet_alpha=syn.get("dirichlet_alpha"),
                )
            else:
                ds = make_synthetic_dataset(
                    seed=seed, num_clients=num_clients, n_local=int(syn.get("n_local", 20)),
                    input_shape=input_shape, num_classes=num_classes,
                    dirichlet_alpha=syn.get("dirichlet_alpha"),
                    class_sep=float(syn.get("class_sep", 2.0)),
                )
            store = None
            if scenario is not None and scenario.streamed:
                # Never placed whole: the round streams device-sized blocks
                # from this host store.
                store = HostClientStore.from_dataset(ds)
            else:
                # Every rank pads alike and keeps its own shard.
                ds = ds.pad_for(plan.dp * cfg.block_clients).shard(plan).to(dev)
            cls = np.zeros(ds.padded_clients, int)
            start = 0
            for ci, n in enumerate(nums):
                cls[start:start + n] = ci
                start += n
            if eval_data is None and not td.dataPath and data_cfg.get("eval_n"):
                if is_text:
                    eval_data = make_central_text_eval_set(
                        seed, int(data_cfg["eval_n"]), int(input_shape[0]), num_classes,
                        vocab_size=vocab_size)
                else:
                    eval_data = make_central_eval_set(
                        seed, int(data_cfg["eval_n"]), input_shape, num_classes,
                        class_sep=float(syn.get("class_sep", 2.0)))
            # Heterogeneous compute profiles: {"<device class>": local_steps};
            # unlisted classes run max_local_steps.
            profiles = data_cfg.get("compute_profiles") or {}
            num_steps = None
            if profiles:
                steps = np.full(ds.padded_clients, cfg.max_local_steps, np.int32)
                for ci, name in enumerate(devices):
                    if name in profiles:
                        steps[cls == ci] = int(profiles[name])
                num_steps = steps
            populations.append(DataPopulation(
                name=td.dataName, dataset=ds, device_classes=devices,
                class_of_client=cls, nums=nums, dynamic_nums=dynamic,
                eval_data=eval_data, num_steps=num_steps, num_classes=pop_classes,
                store=store, device=dev,
            ))

    with tracer.span("bridge.runner"):
        fs = tc.operatorFlow.flowSetting
        start_strat = fs.startCondition.logicalSimulationStrategy
        stop_strat = fs.stopCondition.logicalSimulationStrategy
        flow = OperatorFlowController(
            task_id,
            fs.round,
            start_params={
                "strategy": start_strat.strategyCondition,
                "wait_interval": start_strat.waitInterval,
                "total_timeout": start_strat.totalTimeout,
            },
            stop_params={
                "strategy": stop_strat.strategyCondition,
                "wait_interval": stop_strat.waitInterval,
                "total_timeout": stop_strat.totalTimeout,
            },
            strategy_kwargs=params.get("operator_flow", {}),
            stop_event=stop_event,
        )
        resilience = (ResilienceConfig.from_dict(params["resilience"])
                      if params.get("resilience") else None)
        quarantine_preseed = (parse_quarantine_params(params["quarantine"])["preseed"]
                              if params.get("quarantine") else None)
        ckpt_cfg = params.get("checkpoint")
        checkpoint_every = int(ckpt_cfg.get("every", 1)) if ckpt_cfg else 1
        checkpointer = _checkpointer(task_id, ckpt_cfg, registry) if ckpt_cfg else None
        return SimulationRunner(
            task_id=task_id,
            core=core,
            populations=populations,
            operators=operators,
            rounds=fs.round,
            task_repo=task_repo,
            deviceflow=deviceflow,
            operator_flow=flow,
            stop_event=stop_event,
            perf=perf,
            resilience=resilience,
            quarantine_preseed=quarantine_preseed,
            cost_oracle=cost_oracle,
            cost_family=cost_family(tc) if cost_oracle is not None else None,
            registry=registry,
            checkpointer=checkpointer,
            checkpoint_every=checkpoint_every,
            model_io=model_io,
            warm_start_path=warm_start_path,
            convergence=convergence,
            deadline=deadline,
            defense=defense,
            scenario=scenario,
            async_config=async_config,
        )
