"""Three-stage TaskConfig validation.

Behavior-compatible with the reference validator
(``ols_core/taskMgr/utils/utils.py:283-829``): type checks, value
correctness (ASCII-only identifiers, ranges, file extensions, enum
validity), and cross-field relationship checks (dimension agreement,
allocation sums, operator DAG inputs referencing earlier operators, resource
requests covering target data). Returns ``(ok, message)`` where the
reference returned bare bools with logged messages — the message carries the
same diagnostic text.

Stage 1 (types) is structurally guaranteed by protobuf (the dataclass codec here); it
survives as a guard that the input *is* a TaskConfig.

A copy of the JAX package's ``taskmgr/validation.py`` over the port's
``TaskConfig`` dataclasses; the engine-params blocks are checked with the
port's own parsers (``engine.{async_rounds,convergence,defense,fedcore,
pacing,scenario,algorithms}``, ``parallel.mesh.ParallelConfig`` and
``resilience.quarantine.parse_quarantine_params``), so a task the port's
runner would refuse at build time is refused at submit.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Tuple

from olearning_sim_tpu_torch.storage.file_repo import TRANSFER_TYPES
from olearning_sim_tpu_torch.taskmgr.codecs import TaskConfig

_PATH_RE = re.compile(r"^[a-zA-Z0-9/._-]+$")


def _ascii(s: str) -> bool:
    """Reference ``is_in_ascii``: printable ASCII only."""
    return all(32 <= ord(ch) <= 126 for ch in s)


def _ext(s: str, ext: str) -> bool:
    return s.endswith(ext)


def _valid_transfer(value: int) -> bool:
    return 0 <= value < len(TRANSFER_TYPES)


class Check(Exception):
    pass


def _req(cond: bool, msg: str) -> None:
    if not cond:
        raise Check(msg)


def validate_type(request) -> Tuple[bool, str]:
    """Stage 1 (reference ``validate_type``, ``utils.py:283-399``): with
    protobuf messages the field types are enforced by construction; assert
    the message type itself."""
    if not isinstance(request, TaskConfig):
        return False, f"expected TaskConfig, got {type(request).__name__}"
    return True, "Pass"


def validate_correctness(request) -> Tuple[bool, str]:
    """Stage 2 (reference ``validate_correctness``, ``utils.py:401-554``)."""
    try:
        _req(request.userID != "", "userID should not be empty")
        _req(_ascii(request.userID), f"userID={request.userID} contains illegal characters")
        _req(request.taskID.taskID != "", "taskID should not be empty")
        _req(_ascii(request.taskID.taskID), f"taskID={request.taskID.taskID} contains illegal characters")

        for i, td in enumerate(request.target.targetData):
            _req(td.dataName != "", f"The name of No.{i} data in target should not be empty")
            _req(_ascii(td.dataName), f"data name {td.dataName} contains illegal characters")
            name = td.dataName
            if td.dataPath:
                _req(
                    _ext(td.dataPath, ".zip") or bool(_PATH_RE.match(td.dataPath)),
                    f"data_name={name}, dataPath={td.dataPath} should be a .zip or folder path",
                )
            _req(_valid_transfer(td.dataTransferType), f"data_name={name}, invalid dataTransferType")
            _req(_ascii(td.taskType), f"data_name={name}, taskType contains illegal characters")
            devices = list(td.totalSimulation.deviceTotalSimulation)
            _req(len(devices) > 0, f"data_name={name}, deviceTotalSimulation must be non-empty")
            _req(len(devices) == len(set(devices)), f"data_name={name}, deviceTotalSimulation has repeats")
            _req(all(_ascii(d) for d in devices), f"data_name={name}, device names contain illegal characters")
            _req(
                all(n > 0 for n in td.totalSimulation.numTotalSimulation),
                f"data_name={name}, numTotalSimulation must be > 0",
            )
            _req(
                all(n >= 0 for n in td.totalSimulation.dynamicNumTotalSimulation),
                f"data_name={name}, dynamicNumTotalSimulation must be >= 0",
            )
            _req(
                all(n >= 0 for n in td.allocation.allocationLogicalSimulation),
                f"data_name={name}, allocationLogicalSimulation must be >= 0",
            )
            _req(
                all(n >= 0 for n in td.allocation.allocationDeviceSimulation),
                f"data_name={name}, allocationDeviceSimulation must be >= 0",
            )
            rr_devices = list(td.allocation.runningResponse.deviceRunningResponse)
            _req(all(_ascii(d) for d in rr_devices), f"data_name={name}, runningResponse devices illegal")
            _req(len(rr_devices) == len(set(rr_devices)), f"data_name={name}, runningResponse devices repeat")
            _req(
                all(n >= 0 for n in td.allocation.runningResponse.numRunningResponse),
                f"data_name={name}, numRunningResponse must be >= 0",
            )
        _req(0 <= request.target.priority <= 10,
             f"target.priority={request.target.priority} should be in range from 0 to 10")

        fs = request.operatorFlow.flowSetting
        _req(fs.round > 0, f"operatorFlow.flowSetting.round={fs.round} should be larger than 0")
        for cond in (fs.startCondition, fs.stopCondition):
            for strat in (cond.logicalSimulationStrategy, cond.deviceSimulationStrategy):
                _req(_ascii(strat.strategyCondition), "strategyCondition contains illegal characters")
                _req(strat.waitInterval >= 0, "waitInterval must be >= 0")
                _req(strat.totalTimeout >= 0, "totalTimeout must be >= 0")

        for i, op in enumerate(request.operatorFlow.operator):
            _req(op.name != "", f"The name of No.{i} operator should not be empty")
            _req(_ascii(op.name), f"operator name {op.name} contains illegal characters")
            _req(" " not in op.name, f"operator name {op.name} includes spaces")
            obc = op.operationBehaviorController
            _req(_ascii(obc.strategyBehaviorController), "strategyBehaviorController illegal characters")
            _req(_ascii(obc.outboundService), "outboundService illegal characters")
            _req(all(_ascii(x) for x in op.input), f"operator {op.name} input illegal characters")
            _req(_valid_transfer(op.model.modelTransferType), f"operator {op.name} invalid modelTransferType")
            _req(_ascii(op.model.modelPath), f"operator {op.name} modelPath illegal characters")
            _req(_ascii(op.model.modelUpdateStyle), f"operator {op.name} modelUpdateStyle illegal characters")
            for which, info, code_exts, entry_ext in (
                ("logical", op.logicalSimulationOperatorInfo, (".zip", "dir"), ".py"),
                ("device", op.deviceSimulationOperatorInfo, (".apk",), ".apk"),
            ):
                _req(_valid_transfer(info.operatorTransferType),
                     f"operator {op.name} invalid {which} operatorTransferType")
                if info.operatorCodePath != "":
                    _req(_ascii(info.operatorCodePath),
                         f"operator {op.name} {which} operatorCodePath illegal characters")
                    if which == "logical":
                        _req(
                            os.path.isdir(os.path.abspath(info.operatorCodePath))
                            or _ext(info.operatorCodePath, ".zip")
                            # An extension of the rebuild: registry-addressed builtin
                            # operators need no code archive.
                            or info.operatorCodePath.startswith("builtin:"),
                            f"operator {op.name} logical operatorCodePath should be an existing "
                            f"dir, a .zip, or a builtin: reference",
                        )
                    else:
                        _req(_ext(info.operatorCodePath, ".apk"),
                             f"operator {op.name} device operatorCodePath should be .apk")
                if info.operatorEntryFile != "":
                    _req(_ascii(info.operatorEntryFile),
                         f"operator {op.name} {which} operatorEntryFile illegal characters")
                    if which == "logical":
                        _req(
                            _ext(info.operatorEntryFile, ".py")
                            or info.operatorCodePath.startswith("builtin:"),
                            f"operator {op.name} logical operatorEntryFile should be .py",
                        )
                    else:
                        _req(_ext(info.operatorEntryFile, ".apk"),
                             f"operator {op.name} device operatorEntryFile should be .apk")
                if info.operatorParams:
                    try:
                        op_params = json.loads(info.operatorParams)
                    except (ValueError, TypeError):
                        raise Check(f"operator {op.name} {which} operatorParams should be a json string")
                    if which == "logical" and isinstance(op_params, dict):
                        # Structured engine-params blocks (deadline-aware
                        # rounds, adversarial defense, quarantine
                        # blocklists): reject malformed knobs at submit
                        # time, not mid-round. Wrong-shaped JSON (a string
                        # where a dict belongs, a list for speed_profiles)
                        # raises AttributeError/KeyError/TypeError from the
                        # parsers — still a validation failure, not a
                        # server error.
                        from olearning_sim_tpu_torch.engine.async_rounds import (
                            AsyncConfig,
                        )
                        from olearning_sim_tpu_torch.engine.convergence import (
                            ConvergenceConfig,
                        )
                        from olearning_sim_tpu_torch.engine.defense import (
                            DefenseConfig,
                        )
                        from olearning_sim_tpu_torch.engine.fedcore import (
                            FedCoreConfig,
                        )
                        from olearning_sim_tpu_torch.engine.pacing import (
                            DeadlineConfig,
                        )
                        from olearning_sim_tpu_torch.engine.scenario import (
                            ScenarioConfig,
                        )
                        from olearning_sim_tpu_torch.parallel.mesh import (
                            ParallelConfig,
                        )
                        from olearning_sim_tpu_torch.resilience.quarantine import (
                            parse_quarantine_params,
                        )

                        def _algo_traits(op_params):
                            """(name, personalized, control_variates) of
                            the operator's algorithm; traits are (False,
                            False) when the name is unknown — it fails
                            elsewhere."""
                            from olearning_sim_tpu_torch.engine.algorithms import (
                                from_config as algorithm_from_config,
                            )

                            algo = (op_params.get("algorithm") or {})
                            name = algo.get("name", "fedavg") \
                                if isinstance(algo, dict) else "fedavg"
                            try:
                                a = algorithm_from_config(name)
                                return (name, a.personalized,
                                        a.control_variates)
                            except Exception:  # noqa: BLE001 — unknown
                                return name, False, False

                        for block, parse in (
                            ("deadline", DeadlineConfig.from_dict),
                            ("defense", DefenseConfig.from_dict),
                            ("fedcore", FedCoreConfig.from_dict),
                            ("quarantine", parse_quarantine_params),
                            ("async", AsyncConfig.from_dict),
                            ("parallel", ParallelConfig.from_dict),
                            ("scenario", ScenarioConfig.from_dict),
                            ("convergence", ConvergenceConfig.from_dict),
                        ):
                            if not op_params.get(block):
                                continue
                            try:
                                parsed = parse(op_params[block])
                            except Check:
                                raise
                            except Exception as e:  # noqa: BLE001
                                raise Check(
                                    f"operator {op.name} {block} params "
                                    f"invalid: {type(e).__name__}: {e}"
                                )
                            if block == "defense" and parsed.gathers_deltas:
                                # fedcore rejects robust aggregators /
                                # anomaly scoring with control-variate
                                # algorithms at round time; catch the
                                # combination here instead.
                                name, _, control = _algo_traits(op_params)
                                _req(
                                    not control,
                                    f"operator {op.name} defense params "
                                    f"invalid: aggregator "
                                    f"{parsed.aggregator!r} / anomaly "
                                    f"scoring is not supported with the "
                                    f"control-variate algorithm {name!r} "
                                    f"(use clip_norm only)",
                                )
                            if block == "scenario" and parsed.streamed:
                                # Streamed cohort composition matrix
                                # (docs/performance.md): the engine
                                # rejects these pairs at build time;
                                # catch them at submit instead.
                                name, personalized, control = \
                                    _algo_traits(op_params)
                                _req(
                                    not (personalized or control),
                                    f"operator {op.name} scenario params "
                                    f"invalid: streamed cohorts "
                                    f"(stream_block_rows) do not support "
                                    f"the personalized / control-variate "
                                    f"algorithm {name!r}",
                                )
                                _req(
                                    not op_params.get("async"),
                                    f"operator {op.name} scenario params "
                                    f"invalid: streamed cohorts do not "
                                    f"compose with buffered async rounds "
                                    f"(the commit-window scan needs the "
                                    f"whole cohort resident)",
                                )
                                dfs = op_params.get("defense")
                                gathers = False
                                if dfs:
                                    try:
                                        gathers = DefenseConfig \
                                            .from_dict(dfs).gathers_deltas
                                    except Exception:  # noqa: BLE001
                                        gathers = False  # fails above
                                _req(
                                    not gathers,
                                    f"operator {op.name} scenario params "
                                    f"invalid: streamed cohorts support "
                                    f"clip-only defense (robust "
                                    f"aggregators / anomaly scoring need "
                                    f"every delta resident)",
                                )
                                par = op_params.get("parallel")
                                par_on = False
                                if par:
                                    try:
                                        par_on = ParallelConfig \
                                            .from_dict(par).enabled
                                    except Exception:  # noqa: BLE001
                                        par_on = False  # fails above
                                _req(
                                    not par_on,
                                    f"operator {op.name} scenario params "
                                    f"invalid: streamed cohorts run on "
                                    f"dp-only meshes (no parallel "
                                    f"mp/pp block)",
                                )
                                fed = op_params.get("fedcore") or {}
                                _req(
                                    not fed.get("shard_server_update"),
                                    f"operator {op.name} scenario params "
                                    f"invalid: streamed cohorts use the "
                                    f"replicated server update (no "
                                    f"fedcore.shard_server_update)",
                                )
                            if block == "async":
                                # The buffered engine's lateness control
                                # is max_staleness; an enabled deadline
                                # config on the same task is a conflict
                                # the runner would reject at build time —
                                # catch it at submit instead.
                                dl = op_params.get("deadline")
                                dl_enabled = False
                                if dl:
                                    try:
                                        dl_enabled = DeadlineConfig \
                                            .from_dict(dl).enabled
                                    except Exception:  # noqa: BLE001
                                        dl_enabled = False  # fails above
                                _req(
                                    not dl_enabled,
                                    f"operator {op.name} async params "
                                    f"invalid: mutually exclusive with an "
                                    f"enabled deadline config (use "
                                    f"async.max_staleness as the "
                                    f"lateness control)",
                                )
                                _, personalized, control = _algo_traits(
                                    op_params
                                )
                                _req(
                                    not (personalized or control),
                                    f"operator {op.name} async params "
                                    f"invalid: buffered async rounds do "
                                    f"not support personalized / "
                                    f"control-variate algorithms",
                                )
                            if block == "parallel":
                                # The composition matrix
                                # (docs/performance.md): the engine
                                # rejects these pairs at build time;
                                # catch them at submit instead.
                                if parsed.pp > 1:
                                    _req(
                                        not op_params.get("defense"),
                                        f"operator {op.name} parallel "
                                        f"params invalid: pipeline "
                                        f"parallelism (pp>1) does not "
                                        f"compose with the defense block "
                                        f"(use mp for defended families)",
                                    )
                                    _req(
                                        not op_params.get("deadline"),
                                        f"operator {op.name} parallel "
                                        f"params invalid: pipeline "
                                        f"parallelism (pp>1) runs the "
                                        f"plain program only — no "
                                        f"deadline block",
                                    )
                                    _req(
                                        not op_params.get("async"),
                                        f"operator {op.name} parallel "
                                        f"params invalid: pipeline "
                                        f"parallelism (pp>1) does not "
                                        f"compose with buffered async "
                                        f"rounds",
                                    )
                                    name, personalized, control = \
                                        _algo_traits(op_params)
                                    _req(
                                        not (personalized or control),
                                        f"operator {op.name} parallel "
                                        f"params invalid: pipeline "
                                        f"parallelism (pp>1) does not "
                                        f"support the personalized / "
                                        f"control-variate algorithm "
                                        f"{name!r}",
                                    )
                                    fed = op_params.get("fedcore") or {}
                                    _req(
                                        not fed.get("shard_server_update"),
                                        f"operator {op.name} parallel "
                                        f"params invalid: pp>1 does not "
                                        f"compose with "
                                        f"fedcore.shard_server_update "
                                        f"(the flat dp coordinate shards "
                                        f"would cut across the stage "
                                        f"partition)",
                                    )
                                if parsed.mp > 1:
                                    dfs = op_params.get("defense")
                                    gathers = False
                                    if dfs:
                                        try:
                                            gathers = DefenseConfig \
                                                .from_dict(dfs) \
                                                .gathers_deltas
                                        except Exception:  # noqa: BLE001
                                            gathers = False  # fails above
                                    _req(
                                        not gathers,
                                        f"operator {op.name} parallel "
                                        f"params invalid: robust "
                                        f"aggregators / anomaly scoring "
                                        f"do not compose with a "
                                        f"model-parallel mesh (mp>1) — "
                                        f"use clip_norm only (see "
                                        f"docs/performance.md)",
                                    )
                                    _req(
                                        not op_params.get("async"),
                                        f"operator {op.name} parallel "
                                        f"params invalid: buffered async "
                                        f"rounds do not compose with a "
                                        f"model-parallel mesh (mp>1)",
                                    )

        units = list(request.logicalSimulation.computationUnit.devicesUnit)
        _req(len(units) == len(set(units)), "computationUnit.devicesUnit has repeats")
        _req(all(_ascii(u) for u in units), "computationUnit.devicesUnit illegal characters")
        _req(
            all(s.numCpus >= 1 for s in request.logicalSimulation.computationUnit.unitSetting),
            "unitSetting.numCpus must be >= 1",
        )
        for which, requests in (
            ("logicalSimulation", request.logicalSimulation.resourceRequestLogicalSimulation),
            ("deviceSimulation", request.deviceSimulation.resourceRequestDeviceSimulation),
        ):
            for i, rr in enumerate(requests):
                _req(rr.dataNameResourceRequest != "",
                     f"No.{i} resource_request in {which} name should not be empty")
                _req(_ascii(rr.dataNameResourceRequest),
                     f"{which} resource_request name illegal characters")
                devs = list(rr.deviceResourceRequest)
                _req(len(devs) == len(set(devs)), f"{which} deviceResourceRequest has repeats")
                _req(all(_ascii(d) for d in devs), f"{which} deviceResourceRequest illegal characters")
                _req(all(n >= 0 for n in rr.numResourceRequest),
                     f"{which} numResourceRequest must be >= 0")
        return True, "Pass"
    except Check as e:
        return False, str(e)


def validate_relationship(request) -> Tuple[bool, str]:
    """Stage 3 (reference ``validate_relationship``, ``utils.py:556-811``)."""
    try:
        data_names: List[str] = []
        for td in request.target.targetData:
            name = td.dataName
            data_names.append(name)
            if td.dataPath:
                transfer = TRANSFER_TYPES[td.dataTransferType]
                if transfer not in ("MINIO", "FILE"):
                    _req(_ext(td.dataPath, ".zip"),
                         f"data_name={name}, transfer={transfer}: dataPath must be .zip")
            devices = list(td.totalSimulation.deviceTotalSimulation)
            nums = list(td.totalSimulation.numTotalSimulation)
            dynamic = list(td.totalSimulation.dynamicNumTotalSimulation)
            _req(len(devices) == len(nums) == len(dynamic),
                 f"data_name={name}: devices, nums, dynamic_nums must have equal length")
            _req(all(nums[i] > dynamic[i] for i in range(len(nums))),
                 f"data_name={name}: nums={nums} must exceed dynamic_nums={dynamic}")
            rr_devices = list(td.allocation.runningResponse.deviceRunningResponse)
            _req(set(rr_devices).issubset(devices),
                 f"data_name={name}: runningResponse devices must be in totalSimulation devices")
            rr_nums = list(td.allocation.runningResponse.numRunningResponse)
            _req(len(rr_devices) == len(rr_nums),
                 f"data_name={name}: runningResponse devices/nums length mismatch")
            rr_map = dict(zip(rr_devices, rr_nums))
            rr_reordered = [rr_map.get(d, 0) for d in devices]
            _req(all(rr_reordered[i] <= nums[i] for i in range(len(nums))),
                 f"data_name={name}: runningResponse nums exceed totalSimulation nums")
            if not td.allocation.optimization:
                alloc_l = list(td.allocation.allocationLogicalSimulation) or [0] * len(nums)
                alloc_d = list(td.allocation.allocationDeviceSimulation) or [0] * len(nums)
                _req(len(alloc_l) == len(nums) == len(alloc_d),
                     f"data_name={name}: allocation lengths must match nums")
                _req(all(nums[i] == alloc_l[i] + alloc_d[i] for i in range(len(nums))),
                     f"data_name={name}: logical + device allocation must equal totalSimulation nums")
                _req(all(alloc_d[i] >= rr_reordered[i] for i in range(len(nums))),
                     f"data_name={name}: device allocation must cover runningResponse")

        fs = request.operatorFlow.flowSetting
        for cond in (fs.startCondition, fs.stopCondition):
            for strat in (cond.logicalSimulationStrategy, cond.deviceSimulationStrategy):
                _req(strat.waitInterval <= strat.totalTimeout,
                     "waitInterval in operatorflow should be no larger than totalTimeout")

        seen_ops: List[str] = []
        for op in request.operatorFlow.operator:
            if op.operationBehaviorController.useController:
                _req(op.operationBehaviorController.strategyBehaviorController != "",
                     f"operator {op.name}: strategyBehaviorController required when useController")
            if list(op.input):
                _req(set(op.input).issubset(set(seen_ops)),
                     f"operator {op.name}: input {list(op.input)} must reference earlier operators")
            if op.model.useModel:
                _req(op.model.modelPath != "",
                     f"operator {op.name}: modelPath required when useModel")
            code_path = op.logicalSimulationOperatorInfo.operatorCodePath
            if code_path != "" and os.path.isdir(os.path.abspath(code_path)):
                _req(
                    TRANSFER_TYPES[op.logicalSimulationOperatorInfo.operatorTransferType] == "FILE",
                    f"operator {op.name}: dir operatorCodePath requires FILE transfer",
                )
            _req(
                not (op.logicalSimulationOperatorInfo.operatorCodePath == ""
                     and op.deviceSimulationOperatorInfo.operatorCodePath == ""),
                f"operator {op.name}: operatorCodePath must be set for at least one side",
            )
            # Builtin operators are addressed by name and ship no entry file
            # (an extension of the rebuild; reference required one, utils.py:671-673).
            if not op.logicalSimulationOperatorInfo.operatorCodePath.startswith("builtin:"):
                _req(
                    not (op.logicalSimulationOperatorInfo.operatorEntryFile == ""
                         and op.deviceSimulationOperatorInfo.operatorEntryFile == ""),
                    f"operator {op.name}: operatorEntryFile must be set for at least one side",
                )
            seen_ops.append(op.name)

        rr_names = [r.dataNameResourceRequest
                    for r in request.logicalSimulation.resourceRequestLogicalSimulation]
        rr_names += [r.dataNameResourceRequest
                     for r in request.deviceSimulation.resourceRequestDeviceSimulation]
        _req(set(data_names) == set(rr_names),
             "resource requests must cover exactly the target data names")

        units = list(request.logicalSimulation.computationUnit.devicesUnit)
        settings = list(request.logicalSimulation.computationUnit.unitSetting)
        _req(len(units) == len(settings), "devicesUnit and unitSetting length mismatch")
        all_devices = [
            d for td in request.target.targetData
            for d in td.totalSimulation.deviceTotalSimulation
        ]
        _req(set(all_devices).issubset(set(units)),
             f"all totalSimulation devices {all_devices} must be in computationUnit {units}")

        for rr in request.logicalSimulation.resourceRequestLogicalSimulation:
            _req(rr.dataNameResourceRequest in data_names,
                 f"logicalSimulation resource request {rr.dataNameResourceRequest} unknown data")
            _req(len(rr.deviceResourceRequest) == len(rr.numResourceRequest),
                 "logicalSimulation resource request devices/nums length mismatch")
            req_map = dict(zip(rr.deviceResourceRequest, rr.numResourceRequest))
            for td in request.target.targetData:
                if td.dataName != rr.dataNameResourceRequest:
                    continue
                if not td.allocation.optimization:
                    alloc_map = dict(zip(
                        td.totalSimulation.deviceTotalSimulation,
                        td.allocation.allocationLogicalSimulation,
                    ))
                else:
                    alloc_map = {}
                for dev, n_req in req_map.items():
                    n_alloc = alloc_map.get(dev, 0)
                    if not td.allocation.optimization and n_alloc > 0:
                        _req(n_req > 0,
                             f"logicalSimulation {td.dataName}/{dev}: request must be > 0 "
                             f"when allocation > 0")
                    else:
                        _req(n_req >= 0, f"logicalSimulation {td.dataName}/{dev}: bad request")

        for rr in request.deviceSimulation.resourceRequestDeviceSimulation:
            _req(rr.dataNameResourceRequest in data_names,
                 f"deviceSimulation resource request {rr.dataNameResourceRequest} unknown data")
            _req(len(rr.deviceResourceRequest) == len(rr.numResourceRequest),
                 "deviceSimulation resource request devices/nums length mismatch")
            req_map = dict(zip(rr.deviceResourceRequest, rr.numResourceRequest))
            for td in request.target.targetData:
                if td.dataName != rr.dataNameResourceRequest:
                    continue
                rr_map = dict(zip(
                    td.allocation.runningResponse.deviceRunningResponse,
                    td.allocation.runningResponse.numRunningResponse,
                ))
                if not td.allocation.optimization:
                    alloc_map = dict(zip(
                        td.totalSimulation.deviceTotalSimulation,
                        td.allocation.allocationDeviceSimulation,
                    ))
                    for dev, n_alloc in alloc_map.items():
                        n_req = req_map.get(dev, 0)
                        n_rr = rr_map.get(dev, 0)
                        if n_alloc == n_rr:
                            _req(n_req >= n_rr,
                                 f"deviceSimulation {td.dataName}/{dev}: request must cover "
                                 f"runningResponse")
                        else:
                            _req(n_req >= 1 and n_req > n_rr,
                                 f"deviceSimulation {td.dataName}/{dev}: request must exceed "
                                 f"runningResponse when allocation > runningResponse")
                else:
                    for dev, n_req in req_map.items():
                        n_rr = rr_map.get(dev, 0)
                        if n_rr > 0:
                            _req(n_req > n_rr,
                                 f"deviceSimulation {td.dataName}/{dev}: request must exceed "
                                 f"runningResponse")
        return True, "Pass"
    except Check as e:
        return False, str(e)


def validate_task_parameters(request) -> Tuple[bool, str]:
    """Reference ``validate_task_parameters`` (``utils.py:813-829``): run the
    three stages in order, first failure wins."""
    for stage in (validate_type, validate_correctness, validate_relationship):
        ok, msg = stage(request)
        if not ok:
            return False, msg
    return True, "Pass"
